"""The port's `avamb_ensemble` module held against vamb_tpu's on the CPU, on
tests/test_avamb_ensemble.py's fixtures and on numpy-seeded random bin
sets: every function returns what vamb_tpu's returns (equal dicts and
sets, equal exceptions), and `write_nc_outputs` writes the same files byte
for byte. The module is host code; nothing here needs a device.
"""

import io
import random
from pathlib import Path

import numpy as np
import pytest

from vamb_torch import avamb_ensemble as T
from vamb_torch.markers import Markers as TMarkers
from vamb_torch.utils import RefHasher as TRefHasher

from vamb_tpu import avamb_ensemble as J
from vamb_tpu.markers import Markers as JMarkers
from vamb_tpu.utils import RefHasher as JRefHasher

from .test_avamb_ensemble import LENGTHS, TestQualityReport, contigs


def _q(mod, table):
    return {k: mod.BinQuality(*v) for k, v in table.items()}


def _both(fn_name, *args, **kwargs):
    "Call the function in both packages; return both results (or both errors)."
    out = []
    for mod in (T, J):
        conv = [_q(mod, a) if isinstance(a, _Qual) else a for a in args]
        try:
            out.append(getattr(mod, fn_name)(*conv, **kwargs))
        except Exception as e:  # noqa: BLE001 - the two must raise alike
            out.append((type(e).__name__, str(e)))
    return out


class _Qual(dict):
    "A {bin: (completeness, contamination)} table, made per package."


def test_quality_report_parse_and_bad_header():
    t, j = (m.read_checkm2_quality(io.StringIO(TestQualityReport.REPORT)) for m in (T, J))
    assert {k: (v.completeness, v.contamination, v.score) for k, v in t.items()} == {
        k: (v.completeness, v.contamination, v.score) for k, v in j.items()}
    for mod in (T, J):
        with pytest.raises(ValueError, match="Name"):
            mod.read_checkm2_quality(io.StringIO("foo\tbar\n1\t2\n"))
        with pytest.raises(ValueError, match="out of range"):
            mod.read_checkm2_quality(io.StringIO("Name\tCompleteness\tContamination\na\t101\t0\n"))


FILTER_CASES = {
    "gates": ({"a": contigs(0, 1, 2), "b": contigs(3), "c": contigs(4, 5)},
              {"a": (0.95, 0.01), "b": (0.95, 0.01), "c": (0.50, 0.01)}, (0.9, 0.05, 250_000)),
    "unscored": ({"a": contigs(0)}, {}, (0.0, 1.0, 0)),
    "contaminated": ({"a": contigs(0, 1, 2), "b": contigs(3, 4, 5)},
                     {"a": (0.95, 0.06), "b": (0.9, 0.05)}, (0.9, 0.05, 0)),
}


@pytest.mark.parametrize("case", sorted(FILTER_CASES))
def test_filter_by_quality(case):
    bins, q, (mc, mx, size) = FILTER_CASES[case]
    t, j = _both("filter_by_quality", bins, _Qual(q), LENGTHS, mc, mx, size)
    assert t == j


DEREP_CASES = {
    "duplicate": ({"good": contigs(0, 1, 2, 3), "dup": contigs(0, 1, 2), "other": contigs(10, 11)},
                  {"good": (0.95, 0.01), "dup": (0.80, 0.05), "other": (0.9, 0.0)}),
    "low overlap": ({"a": contigs(0, 1, 2, 3), "b": contigs(3, 4, 5, 6)},
                    {"a": (0.9, 0.0), "b": (0.8, 0.0)}),
    "tie keeps the first": ({"a": contigs(0, 1, 2), "b": contigs(0, 1, 2)},
                            {"a": (0.9, 0.0), "b": (0.9, 0.0)}),
}


@pytest.mark.parametrize("case", sorted(DEREP_CASES))
def test_dereplicate(case):
    bins, q = DEREP_CASES[case]
    t, j = _both("dereplicate", bins, _Qual(q), LENGTHS, 0.75)
    assert t == j


def _random_bins(seed, n_bins=8, per=10, pool=40):
    rng = random.Random(seed)
    return {f"b{k}": {f"C{rng.randrange(pool)}" for _ in range(per)} for k in range(n_bins)}


RIP_CASES = {
    "larger bin gives up": ({"big": contigs(0, 1, 2, 3, 4), "small": contigs(4, 5)}, LENGTHS),
    "empty bins dropped": ({"a": contigs(0, 1), "b": contigs(0, 1)}, LENGTHS),
    "zero-length shared contig": (
        {"a": contigs(0, 1) | {"Z"}, "b": contigs(2, 3) | {"Z"}}, {**LENGTHS, "Z": 0}),
    "chain": ({f"b{k}": {f"C{k}", f"C{k + 1}", f"X{k}"} for k in range(6)},
              {**{f"C{k}": 1000 + k for k in range(7)}, **{f"X{k}": 5000 for k in range(6)}}),
    **{f"random {s}": (_random_bins(s), LENGTHS) for s in range(4)},
}


@pytest.mark.parametrize("case", sorted(RIP_CASES))
def test_rip_overlaps(case):
    bins, lengths = RIP_CASES[case]
    t, j = _both("rip_overlaps", bins, lengths)
    assert t == j
    seen: set = set()
    for members in t.values():
        assert not (members & seen)
        seen |= members


@pytest.mark.parametrize("seed", range(3))
def test_ensemble_merge(seed):
    "The fixture's three binnings, and random ones with random qualities."
    if seed == 0:
        binnings = [{"vae_1": contigs(0, 1, 2, 3), "vae_2": contigs(10, 11, 12)},
                    {"z_1": contigs(0, 1, 2), "z_2": contigs(20, 21, 22)},
                    {"y_1": contigs(20, 21, 22, 12)}]
        q = {"vae_1": (0.96, 0.01), "vae_2": (0.92, 0.02), "z_1": (0.70, 0.01),
             "z_2": (0.91, 0.00), "y_1": (0.85, 0.10)}
    else:
        rng = np.random.default_rng(seed)
        binnings = [{f"{p}_{k}": v for k, v in _random_bins(seed * 10 + i, 6, 6).items()}
                    for i, p in enumerate(("vae", "z", "y"))]
        q = {name: (float(rng.uniform(0.85, 1.0)), float(rng.uniform(0, 0.06)))
             for b in binnings for name in b}
    t, j = _both("ensemble_merge", binnings, _Qual(q), LENGTHS, 0.9, 0.05, 0.75, 200_000)
    assert t == j
    dup = _both("ensemble_merge", [{"x": contigs(0)}, {"x": contigs(1)}],
                _Qual({"x": (1, 0)}), LENGTHS, min_bin_size=0)
    assert dup[0] == dup[1] and "Duplicate bin name" in dup[0][1]


def test_score_bins_with_markers():
    identifiers = [f"C{i}" for i in range(6)]
    rows = [np.array([0], np.uint8), np.array([0, 1], np.uint8), None, None,
            np.array([2], np.uint8), None]
    names = [["m0a", "m0b"], ["m1"], ["m2"]]
    tm = TMarkers(rows, names, TRefHasher.hash_refnames(identifiers))
    jm = JMarkers(rows, names, JRefHasher.hash_refnames(identifiers))
    bins = {"a": {"C0", "C1"}, "b": {"C2", "C3"}, "c": {"C4"}}
    t = T.score_bins_with_markers(tm, bins, identifiers)
    j = J.score_bins_with_markers(jm, bins, identifiers)
    assert {k: (v.completeness, v.contamination) for k, v in t.items()} == {
        k: (v.completeness, v.contamination) for k, v in j.items()}
    for mod, m in ((T, tm), (J, jm)):
        with pytest.raises(KeyError, match="not present"):
            mod.score_bins_with_markers(m, {"a": {"nope"}}, identifiers)


@pytest.mark.parametrize("separator,compress", [("C", False), (None, True)])
def test_write_nc_outputs_byte_for_byte(tmp_path, separator, compress):
    import gzip

    fasta = tmp_path / "contigs.fna"
    fasta.write_text(">S1Cx\nACGTACGTAA\n>S1Cy\nTTTTACGTCC\n>S2Cz\nGGGGACGTAC\n")
    merged = {"bin1": {"S1Cx", "S1Cy"}, "bin2": {"S2Cz"}}
    files = {}
    for mod in (T, J):
        out = tmp_path / mod.__name__.split(".")[0]
        mod.write_nc_outputs(out, merged, _q(mod, {"bin1": (0.955, 0.012), "bin2": (1.0, 0.0)}),
                             separator=separator, fasta_path=Path(fasta), compress=compress)
        files[mod] = {
            p.relative_to(out).as_posix(): (gzip.decompress(p.read_bytes()) if p.suffix == ".gz"
                                            else p.read_bytes())
            for p in sorted(out.rglob("*")) if p.is_file()}
    assert files[T] == files[J] and len(files[T]) == 3
    for mod in (T, J):
        with pytest.raises(KeyError, match="missing from input FASTA"):
            mod.write_nc_outputs(tmp_path / "bad", {"b": {"S1Cx", "Q"}},
                                 _q(mod, {"b": (1.0, 0.0)}), fasta_path=Path(fasta))

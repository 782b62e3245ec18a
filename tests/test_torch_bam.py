"""The port's BAM input held against vamb_tpu and the independent oracle.

Host code in both packages (the same C++ reader, built from each package's
own copy of bamcov.cpp, and the same chunking in `Abundance.from_files`),
so the tolerance is none: coverage matrices and `abundance.npz` contents
must be bit-identical. The BAMs are written by tests/bamgen.py from a numpy
seed: reads with matches, deletions, insertions, soft and hard clips,
skip flags and NM tags, over contigs of which some fall under the length
filter. `tests/oracle_bam.py` (pure Python, from the BAM specification)
checks the values within its own tolerance. Reads with a reference skip
(N) are held apart: there the reader, in both packages, covers the
skipped span, which the oracle and docs/bamcov_policies.md do not
(`test_refskip_is_covered_as_in_vamb_tpu`).
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest

import vamb_torch.abundance as t_abundance
import vamb_torch.bam as t_bam
import vamb_torch.composition as t_composition
from vamb_torch.__main__ import main as torch_main

import vamb_tpu.abundance as j_abundance
import vamb_tpu.bam as j_bam
import vamb_tpu.composition as j_composition

from . import make_golden
from .bamgen import alignment, cigar_op, write_bam
from .oracle_bam import coverage_oracle

REPO = Path(__file__).resolve().parent.parent


def random_alignments(rng, refs, n_reads: int, refskip: bool = False) -> list[bytes]:
    """Reads of ~150 bp over `refs` [(name, length)] with assorted cigars,
    flags and NM; with `refskip`, some reads skip 30 reference bases (N)."""
    out = []
    for r in range(n_reads):
        ref_id = int(rng.integers(0, len(refs)))
        length = refs[ref_id][1]
        pos = int(rng.integers(0, max(1, length - 160)))
        kind = int(rng.integers(0, 6 if refskip else 5))
        if kind == 0:
            cigar = [cigar_op(150, "M")]
        elif kind == 1:
            cigar = [cigar_op(20, "S"), cigar_op(130, "M")]
        elif kind == 2:
            cigar = [cigar_op(70, "M"), cigar_op(5, "D"), cigar_op(80, "M")]
        elif kind == 3:
            cigar = [cigar_op(60, "M"), cigar_op(4, "I"), cigar_op(86, "=")]
        elif kind == 4:
            cigar = [cigar_op(140, "M"), cigar_op(10, "H")]
        else:
            cigar = [cigar_op(50, "M"), cigar_op(30, "N"), cigar_op(100, "X")]
        flag = int(rng.choice([0, 0, 0, 0, 16, 0x4, 0x100, 0x200, 0x400, 0x800]))
        nm = None if rng.random() < 0.1 else int(rng.integers(0, 25))
        out.append(alignment(ref_id, pos, cigar, flag=flag, nm=nm, read_name=b"r%d" % r))
    return out


def write_bams(d: Path, refs, n_files: int, reads_per_file: int, seed: int,
               refskip: bool = False) -> list[Path]:
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        p = d / f"sample{i}.bam"
        write_bam(p, refs, random_alignments(rng, refs, reads_per_file, refskip))
        paths.append(p)
    return paths


REFS = [("c1", 2500), ("c2", 3100), ("short", 900), ("c3", 2200), ("tiny", 120)]


@pytest.fixture(scope="module")
def bams(tmp_path_factory):
    return write_bams(tmp_path_factory.mktemp("torch_bams"), REFS, 5, 600, seed=3)


def metadata(pkg, mask):
    names = np.array([n for (n, _), m in zip(REFS, mask) if m], dtype=object)
    lengths = np.array([ln for (_, ln), m in zip(REFS, mask) if m])
    return pkg.CompositionMetaData(names, lengths, np.array(mask), 100)


@pytest.mark.parametrize("minid", [0.0, 0.9])
@pytest.mark.parametrize("nthreads", [1, 3])
def test_coverage_matches_vamb_tpu_and_oracle(bams, minid, nthreads):
    paths = [str(p) for p in bams]
    t_names, t_cov = t_bam.coverage_from_bams(paths, minid=minid, nthreads=nthreads)
    j_names, j_cov = j_bam.coverage_from_bams(paths, minid=minid, nthreads=nthreads)
    assert t_names == j_names == [n for n, _ in REFS]
    assert t_cov.dtype == np.float32 and t_cov.tobytes() == j_cov.tobytes()
    assert t_cov.sum() > 0
    for col, path in enumerate(paths):
        names, expected = coverage_oracle(path, min_identity=minid)
        assert names == t_names
        np.testing.assert_allclose(t_cov[:, col], expected, rtol=1e-6, atol=1e-6)
    assert t_bam.bam_ref_names(paths[0]) == j_bam.bam_ref_names(paths[0])


def test_refskip_is_covered_as_in_vamb_tpu(tmp_path):
    """A reference skip (N) is covered by the reader in both packages: they
    agree bit for bit, and exceed the oracle, which advances over N without
    covering it as docs/bamcov_policies.md says. The port keeps vamb_tpu's
    reader (abundance.npz must match it); the divergence from the documented
    policy is recorded in ROADMAP.md's faults of the reference."""
    refs = [("c1", 2500)]
    rng = np.random.default_rng(0)
    skip = [cigar_op(50, "M"), cigar_op(30, "N"), cigar_op(100, "X")]
    p = tmp_path / "skip.bam"
    write_bam(p, refs, [alignment(0, int(rng.integers(0, 2300)), skip, read_name=b"r%d" % i)
                        for i in range(60)])
    t_cov = t_bam.coverage_from_bams([str(p)])[1]
    j_cov = j_bam.coverage_from_bams([str(p)])[1]
    assert t_cov.tobytes() == j_cov.tobytes()
    assert t_cov[0, 0] > coverage_oracle(str(p))[1][0] > 0
    mixed = write_bams(tmp_path, REFS, 2, 600, seed=4, refskip=True)
    assert (t_bam.coverage_from_bams([str(q) for q in mixed], minid=0.9)[1].tobytes()
            == j_bam.coverage_from_bams([str(q) for q in mixed], minid=0.9)[1].tobytes())


def test_bam_errors_match(tmp_path, bams):
    bad = tmp_path / "bad.bam"
    bad.write_bytes(b"this is not a bam file")
    with pytest.raises(ValueError, match="BAM"):
        t_bam.coverage_from_bams([str(bad)])
    other = tmp_path / "other.bam"
    write_bam(other, [("other", 500)], [])
    with pytest.raises(ValueError, match="different reference"):
        t_bam.coverage_from_bams([str(bams[0]), str(other)])
    with pytest.raises(ValueError, match="No BAM"):
        t_bam.coverage_from_bams([])


def _fields(ab):
    return (ab.matrix.tobytes(), list(ab.samplenames), ab.minid, ab.refhash)


@pytest.mark.parametrize(
    "mask,minid,nthreads,cache",
    [
        ([True, True, False, True, False], 0.0, 1, False),
        ([True, True, True, True, True], 0.9, 2, True),  # three chunks that spill
        ([True, True, False, True, False], 0.5, 16, True),  # one chunk: no spill
    ],
)
def test_abundance_from_files_identical(tmp_path, bams, mask, minid, nthreads, cache):
    got = t_abundance.Abundance.from_files(
        bams, tmp_path / "t_cache" if cache else None, metadata(t_composition, mask),
        True, minid, nthreads)
    want = j_abundance.Abundance.from_files(
        bams, tmp_path / "j_cache" if cache else None, metadata(j_composition, mask),
        True, minid, nthreads)
    assert _fields(got) == _fields(want)
    assert got.nseqs == sum(mask) and got.nsamples == len(bams)
    assert not (got.matrix.view(np.uint32) & 0xFFF).any()  # 12 low bits masked
    if cache:
        assert not any((tmp_path / "t_cache").glob("*.npz"))  # spill files removed
    got.save(tmp_path / "t.npz")
    back = j_abundance.Abundance.load(tmp_path / "t.npz", want.refhash)
    assert _fields(back) == _fields(want)


def test_abundance_from_files_rejects_like_vamb_tpu(bams):
    meta = metadata(t_composition, [True] * 4 + [False])
    for kwargs, match in (({"minid": 1.5}, "minid"), ({"nthreads": 0}, "nthreads")):
        args = {"minid": 0.0, "nthreads": 1, **kwargs}
        with pytest.raises(ValueError, match=match):
            t_abundance.Abundance.from_files(bams, None, meta, True, **args)
    wrong = t_composition.CompositionMetaData(
        np.array(["c1", "c2"], dtype=object), np.array([2500, 3100]),
        np.array([True, True]), 100)
    with pytest.raises(ValueError, match="number of reference"):
        t_abundance.Abundance.from_files(bams, None, wrong, True, 0.0, 1)


def test_bamcov_build_raises_with_the_compiler_message(tmp_path):
    "A failed build of libbamcov.so raises with g++'s message; nothing falls back."
    native = tmp_path / "native"
    shutil.copytree(REPO / "vamb_torch" / "native", native,
                    ignore=shutil.ignore_patterns("*.so", "__pycache__"))
    src = native / "bamcov.cpp"
    src.write_text(src.read_text().replace("#include <zlib.h>", "#include <zlib_absent_here.h>"))
    spec = importlib.util.spec_from_file_location("autobuild_copy", native / "autobuild.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="zlib_absent_here.h"):
        mod.build_bamcov()
    assert not (native / "libbamcov.so").exists()


def golden_bams(data: Path, n_files: int, seed: int) -> list[Path]:
    "BAMs over the make_golden catalogue, one per sample."
    with open(data / "contigs.fna") as f:
        lines = f.read().split("\n")
    refs = [(h[1:], len(s)) for h, s in zip(lines[0::2], lines[1::2]) if h]
    return write_bams(data, refs, n_files, 4000, seed)


def test_cli_bin_default_from_bams(tmp_path):
    """`bin default --bamfiles` and `--bamdir -z` through the port's CLI:
    abundance.npz equal to vamb_tpu's from the same BAMs, the run complete."""
    data = tmp_path / "data"
    data.mkdir()
    make_golden.write_synthetic_dataset(data)
    paths = golden_bams(data, 3, seed=11)
    comp = j_composition.Composition.from_file(
        open(data / "contigs.fna", "rb"), str(data / "contigs.fna"), minlength=2000)
    for flags, minid in ((["--bamfiles", *map(str, paths)], 0.0),
                         (["--bamdir", str(data), "-z", "0.95"], 0.95)):
        out = tmp_path / f"out_{minid}"
        torch_main(["bin", "default", "--outdir", str(out), "--fasta", str(data / "contigs.fna"),
                    *flags, "-e", "2", "-q", "1", "-l", "8", "-n", "16", "16",
                    "--seed", "5"], device="cpu")
        want = j_abundance.Abundance.from_files(
            paths, None, comp.metadata, True, minid, 1)
        got = j_abundance.Abundance.load(out / "abundance.npz", comp.metadata.refhash)
        assert _fields(got) == _fields(want)
        assert (out / "vae_clusters_unsplit.tsv").is_file()
    with pytest.raises(ValueError, match="both"):
        torch_main(["bin", "default", "--outdir", str(tmp_path / "x"), "--fasta",
                    str(data / "contigs.fna"), "--bamdir", str(data), "--bamfiles",
                    str(paths[0])], device="cpu")

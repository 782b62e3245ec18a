"""The port's Avamb entry points end to end on the CPU, held against vamb_tpu
on tests/make_golden's dataset (400 contigs in 25 planted groups, 4
samples).

* `bin avamb` (`--e_aae 3 --q_aae --n_aae 48 --z_aae 8 --y_aae 10`, as
  tests/test_pipeline.py:218; `-c 25` bounds the port's CPU clustering;
  `--minfasta 2000`) in both packages. Byte for byte equal TSVs are out of
  reach here, and the test holds what was measured instead: a dense bias
  that feeds a BatchNorm trains on rounding noise (its gradient is zero but
  for rounding, which Adam scales to a step of ~lr; tests/test_torch_aae.py),
  so after 3 steps the z latents differ by up to 5.9e-5 (held within
  2e-4). From those latents the 25 z clusters hold the same contigs (their
  members' order may differ: it follows the latent's distances). The y
  clusters agree on every contig but those whose top two y probabilities
  (vamb_tpu's model) lie within 1e-3 of each other (1 contig of 400 here).
* The port's engine on vamb_tpu's z latent writes vamb_tpu's
  `aae_z_clusters_*` byte for byte.
* `--minfasta`: z and y bin FASTAs in one `bins/` directory; each z bin's
  FASTA holds the same records as vamb_tpu's (in the members' order).
* `avamb_ensemble` over vamb_tpu's z and y TSVs with a `--quality_report`
  (completeness and contamination of each bin against the planted
  groups), and with `--markers` plus `--write_bins`: every output byte for
  byte vamb_tpu's.
* `--profile` writes a torch.profiler trace under `<outdir>/profile`.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from vamb_torch import pipeline as t_pipeline
from vamb_torch.__main__ import main as torch_main
from vamb_torch.utils import BinSplitter, read_clusters, read_npz

from vamb_tpu.__main__ import main as jax_main
from vamb_tpu.markers import Markers as JMarkers
from vamb_tpu.models.aae import AAE as JAAE
from vamb_tpu.models.dataset import make_dataset
from vamb_tpu.utils import RefHasher

from . import make_golden

N_GROUPS = 25
MAX_CLUSTERS = 25
AAE_ARGS = ["--e_aae", "3", "--q_aae", "--n_aae", "48", "--z_aae", "8", "--y_aae", "10",
            "--seed", "6", "-c", str(MAX_CLUSTERS)]
RUNNERS = (("torch", torch_main, {"device": "cpu"}), ("jax", jax_main, {}))


def _inputs(d):
    return ["--fasta", str(d / "contigs.fna"), "--abundance_tsv", str(d / "abundance.tsv")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    "`bin avamb --minfasta 2000` in both packages: {package: outdir}, data dir."
    root = tmp_path_factory.mktemp("torch_avamb")
    data = root / "data"
    data.mkdir()
    make_golden.write_synthetic_dataset(data)
    outs = {}
    for name, main, kw in RUNNERS:
        outs[name] = root / name
        main(["bin", "avamb", "--outdir", str(outs[name]), *_inputs(data), *AAE_ARGS,
              "--minfasta", "2000"], **kw)
    return outs, data


def _clusters(path):
    with open(path) as f:
        return read_clusters(f)


def test_bin_avamb_artifacts_and_latent(runs):
    outs, _ = runs
    for out in outs.values():
        for name in ("aae_model.npz", "aae_z_latent.npz", "aae_z_clusters_unsplit.tsv",
                     "aae_z_clusters_split.tsv", "aae_z_clusters_metadata.tsv",
                     "aae_y_clusters_unsplit.tsv", "aae_y_clusters_split.tsv", "log.txt"):
            assert (out / name).is_file(), (out, name)
    lt, lj = (read_npz(outs[k] / "aae_z_latent.npz") for k in ("torch", "jax"))
    assert lt.shape == (make_golden.N_CONTIGS, 8) and lt.dtype == np.float32
    np.testing.assert_allclose(lt, lj, rtol=0, atol=2e-4)
    # each package's model file loads in the other
    from vamb_torch.models.aae import AAE as TAAE

    t_model = TAAE.load(outs["jax"] / "aae_model.npz", device="cpu")
    j_model = JAAE.load(str(outs["torch"] / "aae_model.npz"))
    assert (t_model.h_n, t_model.ld, t_model.y_len) == (48, 8, 10)
    assert (j_model.h_n, j_model.ld, j_model.y_len) == (48, 8, 10)


def test_z_and_y_clusters_agree(runs):
    outs, data = runs
    zt, zj = (_clusters(outs[k] / "aae_z_clusters_unsplit.tsv") for k in ("torch", "jax"))
    assert len(zt) == len(zj) == MAX_CLUSTERS and zt == zj
    assert (outs["torch"] / "aae_z_clusters_metadata.tsv").read_bytes() == (
        outs["jax"] / "aae_z_clusters_metadata.tsv").read_bytes()
    yt, yj = (_clusters(outs[k] / "aae_y_clusters_unsplit.tsv") for k in ("torch", "jax"))
    members = [c for b in yt.values() for c in b]
    assert len(members) == len(set(members)) == make_golden.N_CONTIGS
    assert all(name.startswith("y_") for name in yt)
    where_t = {c: b for b, m in yt.items() for c in m}
    where_j = {c: b for b, m in yj.items() for c in m}
    moved = sorted(c for c in where_t if where_t[c] != where_j[c])
    # the contigs that moved lie on a near tie of vamb_tpu's y probabilities
    model = JAAE.load(str(outs["jax"] / "aae_model.npz"))
    from vamb_torch.abundance import Abundance
    from vamb_torch.composition import Composition

    comp = Composition.load(outs["jax"] / "composition.npz")
    ab = Abundance.load(outs["jax"] / "abundance.npz", comp.metadata.refhash)
    ds = make_dataset(ab.matrix, comp.matrix, comp.metadata.lengths)
    _, _, y, _ = model.encode_apply(model.params, model.bn_state, ds.depths, ds.tnf, False)
    top2 = np.sort(np.asarray(y), axis=1)[:, -2:]
    margin = dict(zip(comp.metadata.identifiers, top2[:, 1] - top2[:, 0]))
    assert len(moved) <= 2, moved
    assert all(margin[c] < 1e-3 for c in moved), {c: margin[c] for c in moved}


def test_port_engine_on_vamb_tpu_latent_writes_its_z_clusters(runs, tmp_path):
    outs, _ = runs
    from vamb_torch.composition import Composition

    comp = Composition.load(outs["jax"] / "composition.npz")
    t_pipeline.cluster_and_write_files(
        t_pipeline.ClusterOptions(max_clusters=MAX_CLUSTERS),
        _splitter(comp),
        read_npz(outs["jax"] / "aae_z_latent.npz"),
        list(comp.metadata.identifiers),
        comp.metadata.lengths,
        6,
        str(tmp_path / "aae_z_clusters"),
        bin_prefix="z_",
        device="cpu",
    )
    for kind in ("unsplit", "split", "metadata"):
        name = f"aae_z_clusters_{kind}.tsv"
        assert (tmp_path / name).read_bytes() == (outs["jax"] / name).read_bytes(), name


def _splitter(comp):
    splitter = BinSplitter(None)
    splitter.initialize(comp.metadata.identifiers)
    return splitter


def test_minfasta_z_and_y_bins_share_one_directory(runs):
    outs, _ = runs
    files = {}
    for k, out in outs.items():
        names = sorted(p.name for p in (out / "bins").iterdir())
        z_bins = [n for n in names if "z_" in n]
        y_bins = [n for n in names if "y_" in n]
        assert z_bins and y_bins and len(z_bins) + len(y_bins) == len(names), names
        files[k] = {n: (out / "bins" / n).read_bytes() for n in names}
    # the z bins hold the same contigs in both packages; members' order may
    # differ, so compare each FASTA's records as a set
    for n in files["jax"]:
        if "z_" in n:
            assert set(files["torch"][n].split(b">")) == set(files["jax"][n].split(b">")), n


def _quality_report(path, clusters, lengths_of):
    "CheckM2 columns from the planted groups (group of contig i: i % 25)."
    with open(path, "w") as f:
        f.write("Name\tCompleteness\tContamination\tCompleteness_Model_Used\n")
        genome_bp = np.zeros(N_GROUPS)
        for c, ln in lengths_of.items():
            genome_bp[int(c.split("C")[1]) % N_GROUPS] += ln
        for name, members in sorted(clusters.items()):
            bp = np.zeros(N_GROUPS)
            for c in members:
                bp[int(c.split("C")[1]) % N_GROUPS] += lengths_of[c]
            g = int(np.argmax(bp))
            comp = 100 * bp[g] / genome_bp[g]
            cont = 100 * (bp.sum() - bp[g]) / bp.sum()
            f.write(f"{name}\t{comp:.2f}\t{cont:.2f}\tNeural Network\n")


def _ensemble_both(argv_tail, tmp_path, data):
    outs = {}
    for name, main, kw in RUNNERS:
        outs[name] = tmp_path / name
        main(["avamb_ensemble", "--outdir", str(outs[name]), "--fasta", str(data / "contigs.fna"),
              *argv_tail], **kw)
    files = {}
    for name, out in outs.items():
        files[name] = {p.relative_to(out).as_posix(): p.read_bytes() for p in sorted(out.rglob("*"))
                       if p.is_file() and p.name not in ("log.txt", "composition.npz")}
    return files


def test_avamb_ensemble_with_quality_report(runs, tmp_path):
    outs, data = runs
    from vamb_torch.composition import Composition

    comp = Composition.load(outs["jax"] / "composition.npz")
    lengths_of = dict(zip(comp.metadata.identifiers, comp.metadata.lengths.tolist()))
    tsvs = [outs["jax"] / f"aae_{k}_clusters_unsplit.tsv" for k in ("z", "y")]
    clusters = {**_clusters(tsvs[0]), **_clusters(tsvs[1])}
    _quality_report(tmp_path / "quality_report.tsv", clusters, lengths_of)
    files = _ensemble_both(["--clusters", *map(str, tsvs), "--quality_report",
                            str(tmp_path / "quality_report.tsv"), "--min_completeness", "0.3",
                            "--max_contamination", "0.5", "--min_bin_size", "10000"], tmp_path, data)
    assert files["torch"] == files["jax"] and "ensemble_clusters.tsv" in files["torch"]
    merged = _clusters(tmp_path / "torch" / "ensemble_clusters.tsv")
    assert merged
    seen: set = set()
    for members in merged.values():
        assert not (members & seen)
        seen |= members


def test_avamb_ensemble_with_markers_and_bins(runs, tmp_path):
    outs, data = runs
    names = [f"S{1 + i % 3}C{i}" for i in range(make_golden.N_CONTIGS)]
    # each planted group carries 6 single-copy markers on its first 6 contigs
    rows = [np.array([i // N_GROUPS], np.uint8) if i < 6 * N_GROUPS else None
            for i in range(len(names))]
    JMarkers(rows, [[f"M{m}"] for m in range(6)], RefHasher.hash_refnames(names)).save(
        tmp_path / "markers.npz")
    tsvs = [outs["jax"] / f"aae_{k}_clusters_unsplit.tsv" for k in ("z", "y")]
    files = _ensemble_both(["--clusters", *map(str, tsvs), "--markers", str(tmp_path / "markers.npz"),
                            "--write_bins", "--min_completeness", "0.5", "--max_contamination",
                            "0.5", "--min_bin_size", "10000"], tmp_path, data)
    assert files["torch"] == files["jax"]
    assert "quality_report.tsv" in files["torch"]
    assert any(k.startswith("bins/") for k in files["torch"]), sorted(files["torch"])


def test_profile_writes_a_trace(runs, tmp_path):
    _, data = runs
    out = tmp_path / "prof"
    torch_main(["bin", "avamb", "--outdir", str(out), *_inputs(data), "--e_aae", "1", "--q_aae",
                "--n_aae", "16", "--z_aae", "4", "--y_aae", "4", "--seed", "1", "-c", "1",
                "--profile"], device="cpu")
    trace = out / "profile" / "trace.json"
    assert trace.is_file()
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    assert "torch.profiler trace" in (out / "log.txt").read_text()

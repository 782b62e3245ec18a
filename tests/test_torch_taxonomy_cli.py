"""The port's taxonomy entry points end to end on the CPU, held against the
goldens and against vamb_tpu on tests/make_golden's dataset and taxonomy
(400 contigs in 25 planted groups, each labelled to species).

* `taxometer` writes tests/golden/results_taxometer.tsv byte for byte.
* `bin taxvamb --no_predictor` writes tests/golden/vaevae_clusters_unsplit.tsv
  byte for byte.
* The golden Taxometer TSV is weak (5 epochs: every row reads `Bacteria`),
  so both packages' `predict_taxonomy` also train 20 epochs, where every
  row reaches species: their lineages must agree on every row but those
  where vamb_tpu's probability of a node lies within 1e-4 of the 0.5
  threshold, and every score within 1e-4.
* `bin taxvamb` with Taxometer first, and on a refined taxonomy file (the
  other two branches), writes vamb_tpu's TSVs byte for byte (the first
  40 clusters: after 3 epochs the latent splits the 400 contigs into ~120,
  which the port's engine takes ~20 s to emit on the CPU).
* `recluster --algorithm dbscan` on an unrefined taxonomy, with an
  abundance and without `--no_predictor`, trains Taxometer first and
  writes vamb_tpu's refined bins byte for byte.
* `taxonomy_benchmark` writes vamb_tpu's k-fold predictions, accuracy
  report and file list byte for byte (paths aside).
"""

import json

import numpy as np
import pytest

from vamb_torch import pipeline as t_pipeline
from vamb_torch.__main__ import main as torch_main
from vamb_torch.abundance import Abundance as TAbundance
from vamb_torch.composition import Composition as TComposition
from vamb_torch.utils import Reader

from vamb_tpu import pipeline as j_pipeline
from vamb_tpu.__main__ import main as jax_main
from vamb_tpu.abundance import Abundance as JAbundance
from vamb_tpu.composition import Composition as JComposition
from vamb_tpu.utils import RefHasher

from . import make_golden

RUNNERS = (("torch", torch_main, {"device": "cpu"}), ("jax", jax_main, {}))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_taxonomy")
    make_golden.write_synthetic_dataset(d)
    make_golden.write_synthetic_taxonomy(d)
    return d


def _inputs(d):
    return ["--fasta", str(d / "contigs.fna"), "--abundance_tsv", str(d / "abundance.tsv")]


def _seed():
    return ["--seed", str(make_golden.SEED)]


def test_taxometer_writes_golden_tsv(data, tmp_path):
    out = tmp_path / "tm"
    torch_main(["taxometer", "--outdir", str(out), *_inputs(data),
                "--taxonomy", str(data / "taxonomy.tsv"), "-pe", str(make_golden.EPOCHS),
                *_seed()], device="cpu")
    golden = make_golden.GOLDEN_DIR / "results_taxometer.tsv"
    assert (out / "results_taxometer.tsv").read_bytes() == golden.read_bytes()
    assert (out / "predictor_model.npz").is_file()


def test_bin_taxvamb_no_predictor_writes_golden_tsv(data, tmp_path):
    out = tmp_path / "tv"
    torch_main(["bin", "taxvamb", "--outdir", str(out), *_inputs(data),
                "--taxonomy", str(data / "taxonomy.tsv"), "--no_predictor",
                "-e", str(make_golden.EPOCHS), "-q", "2", *_seed(),
                "-u", str(make_golden.MIN_SUCCESSES)], device="cpu")
    name = "vaevae_clusters_unsplit.tsv"
    assert (out / name).read_bytes() == (make_golden.GOLDEN_DIR / name).read_bytes()
    latent = np.load(out / "vaevae_latent.npz")["arr_0"]
    assert latent.shape == (make_golden.N_CONTIGS, 32) and np.isfinite(latent).all()
    assert not (latent.view(np.uint32) & 0xFFF).any()
    for name in ("vaevae_model.npz", "vaevae_clusters_split.tsv", "vaevae_clusters_metadata.tsv"):
        assert (out / name).is_file(), name


def _rows(path):
    out = []
    for line in path.read_text().splitlines()[1:]:
        name, lineage, scores = (line.split("\t") + ["", ""])[:3]
        out.append((name, lineage.split(";") if lineage else [],
                    [float(x) for x in scores.split(";")] if scores else []))
    return out


def test_predict_taxonomy_to_species_matches_vamb_tpu(data, tmp_path):
    epochs = 20
    with Reader(data / "contigs.fna") as f:
        tc = TComposition.from_file(f, str(data / "contigs.fna"), minlength=2000)
    ta = TAbundance.from_tsv(data / "abundance.tsv", tc.metadata)
    with Reader(data / "contigs.fna") as f:
        jc = JComposition.from_file(f, str(data / "contigs.fna"), minlength=2000)
    ja = JAbundance.from_tsv(data / "abundance.tsv", jc.metadata)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t_pipeline.predict_taxonomy(
        tc.metadata, ta.matrix, tc.matrix, tc.metadata.lengths, tmp_path / "t",
        t_pipeline.TaxometerOptions(taxonomy_path=data / "taxonomy.tsv", nepochs=epochs),
        seed=make_golden.SEED, device="cpu")
    j_pipeline.predict_taxonomy(
        jc.metadata, ja.matrix, jc.matrix, jc.metadata.lengths, tmp_path / "j",
        j_pipeline.TaxometerOptions(taxonomy_path=data / "taxonomy.tsv", nepochs=epochs),
        seed=make_golden.SEED)
    t_rows = _rows(tmp_path / "t" / "results_taxometer.tsv")
    j_rows = _rows(tmp_path / "j" / "results_taxometer.tsv")
    assert [r[0] for r in t_rows] == [r[0] for r in j_rows]
    near = 0
    for (_, t_lin, t_sc), (_, j_lin, j_sc) in zip(t_rows, j_rows):
        if t_lin != j_lin:
            near += 1
            assert any(abs(p - 0.5) <= 1e-4 for p in t_sc + j_sc), (t_lin, j_lin)
            continue
        np.testing.assert_allclose(t_sc, j_sc, rtol=0, atol=1e-4)
    assert near == 0  # none lies that close here; recorded by the assertion above
    assert all(len(lin) == 7 for _, lin, _ in j_rows)  # every row reaches species


def _run_both(argv_of, tmp_path, names):
    outs = []
    for tag, run, kwargs in RUNNERS:
        out = tmp_path / tag
        run(argv_of(out), **kwargs)
        outs.append({name: (out / name).read_bytes() for name in names})
    return outs


@pytest.mark.parametrize("branch", ["taxometer_first", "refined_file"])
def test_bin_taxvamb_branches_match_vamb_tpu(data, tmp_path, branch):
    if branch == "taxometer_first":
        taxonomy = data / "taxonomy.tsv"
    else:  # Taxometer's refined format, read as it is
        taxonomy = make_golden.GOLDEN_DIR / "results_taxometer.tsv"

    def argv(out):
        return ["bin", "taxvamb", "--outdir", str(out), *_inputs(data),
                "--taxonomy", str(taxonomy), "-e", "3", "-q", "1", "-pe", "4", *_seed(),
                "-u", str(make_golden.MIN_SUCCESSES), "-c", "40"]

    names = ["vaevae_clusters_unsplit.tsv", "vaevae_clusters_split.tsv",
             "vaevae_clusters_metadata.tsv"]
    if branch == "taxometer_first":
        names.append("results_taxometer.tsv")
    t_out, j_out = _run_both(argv, tmp_path, names)
    for name in names:
        assert t_out[name] == j_out[name], name


def test_recluster_dbscan_runs_taxometer_first(data, tmp_path):
    n, groups = make_golden.N_CONTIGS, 25
    rng = np.random.default_rng(0)
    group = np.arange(n) % groups
    centers = rng.normal(size=(groups, 32)) * 2
    np.savez(tmp_path / "latent.npz",
             (centers[group] + rng.normal(scale=0.3, size=(n, 32))).astype(np.float32))
    names = [f"S{1 + i % 3}C{i}" for i in range(n)]
    marks = [[i // groups] if i // groups < 6 else None for i in range(n)]
    (tmp_path / "markers.npz").write_text(json.dumps({
        "markers": marks, "marker_names": [[f"M{r}"] for r in range(6)],
        "refhash": RefHasher.hash_refnames(names).hex()}))

    def argv(out):
        return ["recluster", "--outdir", str(out), *_inputs(data),
                "--markers", str(tmp_path / "markers.npz"),
                "--latent_path", str(tmp_path / "latent.npz"), "--algorithm", "dbscan",
                "--taxonomy", str(data / "taxonomy.tsv"), "-pe", "20", "--seed", "3",
                "-o", "C"]

    tsvs = ["clusters_reclustered_unsplit.tsv", "clusters_reclustered_split.tsv",
            "results_taxometer.tsv"]
    t_out, j_out = _run_both(argv, tmp_path, tsvs)
    for name in tsvs:
        assert t_out[name] == j_out[name], name
    # Taxometer refined the labels to species, so DBSCAN ran per genus
    assert t_out["results_taxometer.tsv"].count(b"species") == n
    assert t_out[tsvs[0]].count(b"\n") == n + 1


def test_taxonomy_benchmark_matches_vamb_tpu(data, tmp_path):
    def argv(out):
        return ["taxonomy_benchmark", "--outdir", str(out), *_inputs(data),
                "--taxonomy", str(data / "taxonomy.tsv"), "-pe", "3", *_seed()]

    names = ["results_taxonomy_predicted_kfold.tsv", "accuracy_report.tsv", "file_tracking.tsv"]
    t_out, j_out = _run_both(argv, tmp_path, names)
    for name in names[:2]:
        assert t_out[name] == j_out[name], name
    tracking = t_out["file_tracking.tsv"].decode().replace(str(tmp_path / "torch"), "OUT")
    assert tracking == j_out["file_tracking.tsv"].decode().replace(str(tmp_path / "jax"), "OUT")
    report = t_out["accuracy_report.tsv"].decode().splitlines()
    assert report[0] == "Level\tCorrect\tHave_truth\tN_contigs\tAccuracy"
    assert len(report) == 1 + 7


def test_only_avamb_entry_points_are_unported():
    # the avamb entry points were the last: every subcommand is ported now,
    # and each one's help exits 0
    for argv in (["bin", "default", "--help"], ["bin", "taxvamb", "--help"],
                 ["bin", "avamb", "--help"], ["taxometer", "--help"], ["recluster", "--help"],
                 ["taxonomy_benchmark", "--help"], ["avamb_ensemble", "--help"]):
        with pytest.raises(SystemExit) as exit_info:
            torch_main(argv, device="cpu")
        assert exit_info.value.code == 0

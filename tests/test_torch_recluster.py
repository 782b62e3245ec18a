"""The port's `recluster` held against vamb_tpu: weighted k-means, the
marker counters and seeds, per-genus DBSCAN, the taxonomy readers and the
subcommand end to end through both CLIs, on numpy-seeded inputs.

K-means runs in float32 in both packages (XLA's dots against torch's), so
its labels are compared on fixtures whose points lie far from any
boundary; DBSCAN is numpy float64 host code in both. Refined bins must be
the same sets, in the same order, and the written TSVs byte-identical.

Two taxonomy cases differ from vamb_tpu on purpose: the port keeps
upstream Vamb's semantics (vamb/taxonomy.py) where vamb_tpu departs from
them (ADVICE.md; ROADMAP.md's faults of the reference).
"""

import json

import numpy as np
import pytest

from vamb_torch import reclustering as t_rc
from vamb_torch import taxonomy as t_tax
from vamb_torch.__main__ import main as torch_main
from vamb_torch.composition import CompositionMetaData as TMeta
from vamb_torch.markers import Markers as TMarkers
from vamb_torch.ops.kmeans import kmeans as t_kmeans

from vamb_tpu import reclustering as j_rc
from vamb_tpu import taxonomy as j_tax
from vamb_tpu.__main__ import main as jax_main
from vamb_tpu.composition import CompositionMetaData as JMeta
from vamb_tpu.ops.kmeans import kmeans as j_kmeans
from vamb_tpu.utils import RefHasher

from . import make_golden
from . import test_reclustering as fixtures


def port_markers(markers):
    return TMarkers(markers.markers, markers.marker_names, markers.refhash)


# ---------------------------------------------------------------- k-means


@pytest.mark.parametrize("k", [1, 2, 5])
def test_kmeans_labels_identical(k):
    rng = np.random.default_rng(k)
    centers = rng.normal(0, 4, (k, 6))
    sizes = rng.integers(5, 40, k)
    x = np.concatenate([c + rng.normal(0, 0.2, (s, 6)) for c, s in zip(centers, sizes)])
    x = x.astype(np.float32)
    init = x[np.cumsum(sizes) - 1]
    w = rng.integers(2000, 20_000, len(x)).astype(np.float64)
    got = t_kmeans(x, k, init, w, device="cpu")
    want = j_kmeans(x, k, init, w)
    assert np.array_equal(got, want)
    assert len(set(got.tolist())) == k


def test_kmeans_empty_cluster_keeps_its_center():
    x = np.array([[0.0], [0.1], [10.0], [10.2]], np.float32)
    init = np.array([[0.0], [10.0], [100.0]], np.float32)  # the third stays empty
    got = t_kmeans(x, 3, init, np.ones(4), device="cpu")
    assert np.array_equal(got, j_kmeans(x, 3, init, np.ones(4)))
    assert got.tolist() == [0, 0, 1, 1]


# ------------------------------------------------------------ reclustering


def test_marker_counters_and_seeds_identical():
    markers = fixtures.make_markers([[0], [0], [1], None, [0, 1], [2]], n_markers=3)
    tm = port_markers(markers)
    lengths = np.array([9000, 8000, 100, 50, 7000, 3000])
    for contigs in (range(6), [0, 1, 4], [3]):
        counts = t_rc.count_markers(contigs, tm)
        assert np.array_equal(counts, j_rc.count_markers(contigs, markers))
        got = t_rc.count_markers_saturated(contigs, tm)
        want = j_rc.count_markers_saturated(contigs, markers)
        assert (got is None and want is None) or np.array_equal(got, want)
    counts = t_rc.count_markers(range(6), tm)
    assert t_rc.get_kmeans_seeds(range(6), tm, lengths, counts, 3) == j_rc.get_kmeans_seeds(
        range(6), markers, lengths, counts, 3)
    bins = [{0, 2, 5}, {1, 4}, {0, 1, 4, 2}]
    assert t_rc.count_good_genomes(bins, tm) == j_rc.count_good_genomes(bins, markers)


@pytest.mark.parametrize("case", ["merged", "pure", "three"])
def test_recluster_kmeans_identical(case):
    latent, lengths, markers = fixtures.TestRecluster().make_problem()
    clusters = {"merged": [set(range(40))], "pure": [set(range(20)), set(range(20, 40))],
                "three": [set(range(15)), set(range(15, 40)), {3}]}[case]
    got = t_rc.recluster_bins(port_markers(markers), latent,
                              t_rc.KmeansAlgorithm(clusters, 0, lengths, "cpu"))
    want = j_rc.recluster_bins(markers, latent, j_rc.KmeansAlgorithm(clusters, 0, lengths))
    assert got == want


def test_recluster_dbscan_identical():
    latent, lengths, markers = fixtures.TestRecluster().make_problem()
    names = np.array([f"c{i}" for i in range(40)], dtype=object)
    out = []
    for meta_cls, tax, rc, mk in ((TMeta, t_tax, t_rc, port_markers(markers)),
                                  (JMeta, j_tax, j_rc, markers)):
        meta = meta_cls(names, lengths, np.ones(40, bool), 2000)
        taxes = [tax.ContigTaxonomy(["d", "p", "c", "o", "f", f"genus{i // 20}"], True)
                 if i % 7 else None for i in range(40)]
        taxonomy = tax.Taxonomy(taxes, meta.refhash, True)
        out.append(rc.recluster_bins(mk, latent, rc.DBScanAlgorithm(meta, taxonomy, 1)))
    assert out[0] == out[1]


@pytest.mark.parametrize("seed", range(3))
def test_dbscan_genus_identical(seed):
    rng = np.random.default_rng(seed)
    latent = np.concatenate([c + rng.normal(0, 0.05 * (seed + 1), (int(s), 8))
                             for c, s in zip(rng.normal(0, 1, (4, 8)), rng.integers(3, 25, 4))])
    latent[2] = 0.0  # a zero vector: cosine distance 1 to everything
    idx = np.arange(len(latent)) * 3
    lengths = rng.integers(2000, 30_000, len(latent))
    for eps in t_rc.EPS_VALUES:
        assert t_rc.dbscan_genus(latent, idx, lengths, float(eps)) == j_rc.dbscan_genus(
            latent, idx, lengths, float(eps))


# --------------------------------------------------------------- taxonomy


def _meta(names):
    return (TMeta(np.array(names, dtype=object), np.full(len(names), 2500),
                  np.ones(len(names), bool), 2000),
            JMeta(np.array(names, dtype=object), np.full(len(names), 2500),
                  np.ones(len(names), bool), 2000))


def _ranks(taxonomy):
    return [None if t is None else t.ranks for t in taxonomy.contig_taxonomies]


def test_taxonomy_files_read_alike(tmp_path):
    plain = tmp_path / "plain.tsv"
    plain.write_text("contigs\tpredictions\nc1\td;p;c;o;f;g1\nextra\td\nc2\td;p\nc3\t\n")
    refined = tmp_path / "refined.tsv"
    refined.write_text("contigs\tpredictions\tscores\nc1\td;p\t0.9;0.8\nc2\td;q\t1.2;-0.1\n"
                       "c3\nc4\td\t0.5\n\n")
    tm, jm = _meta(["c1", "c2", "c3"])
    got = t_tax.Taxonomy.from_file(plain, tm, True)
    want = j_tax.Taxonomy.from_file(plain, jm, True)
    assert _ranks(got) == _ranks(want) and got.refhash == want.refhash
    assert [t.genus for t in got.contig_taxonomies] == ["g1", None, None]
    tm, jm = _meta(["c1", "c2", "c3", "c4"])
    got = t_tax.Taxonomy.from_refined_file(refined, tm, True)
    want = j_tax.Taxonomy.from_refined_file(refined, jm, True)
    assert _ranks(got) == _ranks(want)
    got_p = t_tax.PredictedTaxonomy.parse_tax_file(refined, True)
    want_p = j_tax.PredictedTaxonomy.parse_tax_file(refined, True)
    assert [(n, p.probs.tolist()) for n, p in got_p] == [(n, p.probs.tolist()) for n, p in want_p]
    for bad in ("contigs\tpredictions\nc1\ta;b\nc2\tb;a\n", "wrong header\n",
                "contigs\tpredictions\nc1\ta\tb\n"):
        plain.write_text(bad)
        tm, jm = _meta(["c1", "c2"])
        with pytest.raises(ValueError):
            t_tax.Taxonomy.from_file(plain, tm, False)
        with pytest.raises(ValueError):
            j_tax.Taxonomy.from_file(plain, jm, False)


def test_refined_unassigned_row_reads_as_upstream(tmp_path):
    """Upstream Vamb semantics, not vamb_tpu's: Taxometer writes an
    unassigned contig as `name\\t\\t`; upstream right-strips the row and reads
    it as unassigned, vamb_tpu reaches float('') and raises."""
    p = tmp_path / "refined.tsv"
    p.write_text("contigs\tpredictions\tscores\nc1\td;p\t0.9;0.8\nc2\t\t\n")
    tm, jm = _meta(["c1", "c2"])
    got = t_tax.Taxonomy.from_refined_file(p, tm, True)
    assert _ranks(got) == [["d", "p"], []]
    with pytest.raises(ValueError):
        j_tax.Taxonomy.from_refined_file(p, jm, True)


def test_blank_line_in_plain_taxonomy_raises_as_upstream(tmp_path):
    """Upstream Vamb semantics, not vamb_tpu's: a blank line in the
    two-column format is an error upstream; vamb_tpu skips it."""
    p = tmp_path / "plain.tsv"
    p.write_text("contigs\tpredictions\nc1\td;p\n\nc2\td;q\n")
    tm, jm = _meta(["c1", "c2"])
    with pytest.raises(ValueError, match="2 tab-separated columns, found 1"):
        t_tax.Taxonomy.from_file(p, tm, True)
    assert _ranks(j_tax.Taxonomy.from_file(p, jm, True)) == [["d", "p"], ["d", "q"]]


# ------------------------------------------------------ recluster, end to end


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """make_golden's dataset and taxonomy, a latent with one tight blob per
    planted group, a clusters TSV that merges the groups two by two, and a
    markers.npz in which marker r sits on the group's r-th contig, so the
    merged bins hold every marker twice."""
    d = tmp_path_factory.mktemp("torch_recluster")
    make_golden.write_synthetic_dataset(d)
    make_golden.write_synthetic_taxonomy(d)
    n, groups = make_golden.N_CONTIGS, 25
    rng = np.random.default_rng(0)
    group = np.arange(n) % groups
    centers = rng.normal(size=(groups, 32)) * 2
    np.savez(d / "latent.npz", (centers[group] + rng.normal(scale=0.3, size=(n, 32)))
             .astype(np.float32))
    names = [f"S{1 + i % 3}C{i}" for i in range(n)]
    marks = [[i // groups] if i // groups < 6 else None for i in range(n)]
    (d / "markers.npz").write_text(json.dumps({
        "markers": marks, "marker_names": [[f"M{r}"] for r in range(6)],
        "refhash": RefHasher.hash_refnames(names).hex()}))
    with open(d / "clusters.tsv", "w") as f:
        f.write("clustername\tcontigname\n")
        f.writelines(f"b{g // 2}\t{name}\n" for g, name in zip(group, names))
    return d


@pytest.mark.parametrize("algorithm", ["kmeans", "dbscan"])
def test_recluster_cli_identical(golden, tmp_path, algorithm):
    d = golden
    tsvs = []
    for tag, run, kwargs in (("torch", torch_main, {"device": "cpu"}), ("jax", jax_main, {})):
        out = tmp_path / tag
        argv = ["recluster", "--outdir", str(out), "--fasta", str(d / "contigs.fna"),
                "--markers", str(d / "markers.npz"), "--latent_path", str(d / "latent.npz"),
                "--algorithm", algorithm, "--seed", "3", "-o", "C"]
        if algorithm == "kmeans":
            argv += ["--clusters_path", str(d / "clusters.tsv")]
        else:
            argv += ["--taxonomy", str(d / "taxonomy.tsv"), "--no_predictor"]
        run(argv, **kwargs)
        tsvs.append([(out / f"clusters_reclustered_{kind}.tsv").read_bytes()
                     for kind in ("unsplit", "split")])
    assert tsvs[0] == tsvs[1]
    bins = {line.split(b"\t")[0] for line in tsvs[0][0].splitlines()[1:]}
    if algorithm == "kmeans":  # each of the 12 merged pairs was split in two
        assert len(bins) == 25
    assert tsvs[0][0].count(b"\n") == make_golden.N_CONTIGS + 1

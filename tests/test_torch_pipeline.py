"""`bin default` of the port held against vamb_tpu on the make_golden dataset
(tests/make_golden.py: 400 contigs, 25 planted groups, 4 samples, seed 41,
5 epochs, -q 2, -u 2).

(a) The port's `cluster_and_write_files` on the latent of vamb_tpu's run
    writes unsplit/split/metadata TSVs byte-identical to vamb_tpu's: given a
    latent, the two engines draw the same random stream and decide alike.
    The same holds with the subset wander forced (`wander_scope="subset"`).
(b) The port's whole `bin default` on the CPU writes a full partition of
    the 400 contigs. Training draws jax's threefry streams, so it trains on
    the same batches and dropout masks as `vamb_tpu`; its latent differs
    from the JAX run's in 95 of 12,800 values (f32 sums in another order
    and eps a few ulps off, then the 12-bit mask), and its cluster TSVs
    equal the golden tests/golden/vae_clusters_*.tsv byte for byte
    (pairwise F1 against the 25 planted groups 0.1746 on both sides).
"""

import numpy as np
import pytest

from vamb_torch.__main__ import main as torch_main
from vamb_torch.pipeline import ClusterOptions, cluster_and_write_files
from vamb_torch.utils import BinSplitter
from vamb_tpu import pipeline as j_pipeline
from vamb_tpu.utils import BinSplitter as JBinSplitter

from . import make_golden

TSVS = ("vae_clusters_unsplit.tsv", "vae_clusters_split.tsv", "vae_clusters_metadata.tsv")
N_GROUPS = 25


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipeline_data")
    make_golden.write_synthetic_dataset(d)
    return d


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_run") / "out"
    make_golden.run_bin_default(out, data)
    return out


def pairwise_f1(tsv) -> float:
    "Pairwise F1 of a cluster TSV against the planted groups (contig i is in group i % 25)."
    rows = [line.split("\t") for line in tsv.read_text().splitlines()[1:]]
    cluster = np.unique([r[0] for r in rows], return_inverse=True)[1]
    group = np.array([int(r[1].split("C")[1]) % N_GROUPS for r in rows])
    iu = np.triu_indices(len(rows), 1)
    same_c = (cluster[:, None] == cluster[None, :])[iu]
    same_g = (group[:, None] == group[None, :])[iu]
    tp = (same_c & same_g).sum()
    precision, recall = tp / same_c.sum(), tp / same_g.sum()
    return 2 * precision * recall / (precision + recall)


def test_clustering_the_jax_latent_writes_identical_tsvs(jax_run, tmp_path):
    latent = np.load(jax_run / "latent.npz")["arr_0"]
    comp = np.load(jax_run / "composition.npz", allow_pickle=True)
    names = list(comp["identifiers"])
    binsplitter = BinSplitter(None)
    binsplitter.initialize(names)
    cluster_and_write_files(
        ClusterOptions(min_successes=make_golden.MIN_SUCCESSES),
        binsplitter,
        latent,
        names,
        comp["lengths"],
        make_golden.SEED,
        str(tmp_path / "vae_clusters"),
        device="cpu",
    )
    for name in TSVS:
        assert (tmp_path / name).read_bytes() == (jax_run / name).read_bytes(), name


def test_subset_scope_on_the_jax_latent_matches_vamb_tpu(jax_run, tmp_path):
    latent = np.load(jax_run / "latent.npz")["arr_0"]
    comp = np.load(jax_run / "composition.npz", allow_pickle=True)
    names = list(comp["identifiers"])
    for side, options, splitter, fn in (
        ("port", ClusterOptions, BinSplitter, cluster_and_write_files),
        ("jax", j_pipeline.ClusterOptions, JBinSplitter, j_pipeline.cluster_and_write_files),
    ):
        binsplitter = splitter(None)
        binsplitter.initialize(names)
        kwargs = {"device": "cpu"} if side == "port" else {}
        fn(options(min_successes=make_golden.MIN_SUCCESSES, wander_scope="subset"),
           binsplitter, latent.copy(), names, comp["lengths"], make_golden.SEED,
           str(tmp_path / f"{side}_clusters"), **kwargs)
    for name in ("clusters_unsplit.tsv", "clusters_metadata.tsv"):
        assert (tmp_path / f"port_{name}").read_bytes() == (tmp_path / f"jax_{name}").read_bytes()


def test_bin_default_end_to_end(data, tmp_path):
    out = tmp_path / "out"
    torch_main(
        ["bin", "default", "--outdir", str(out), "--fasta", str(data / "contigs.fna"),
         "--abundance_tsv", str(data / "abundance.tsv"), "-e", str(make_golden.EPOCHS),
         "-q", "2", "--seed", str(make_golden.SEED), "-u", str(make_golden.MIN_SUCCESSES)],
        device="cpu",
    )
    for name in ("composition.npz", "abundance.npz", "model.npz", "latent.npz", *TSVS):
        assert (out / name).is_file(), name
    latent = np.load(out / "latent.npz")["arr_0"]
    assert latent.shape == (make_golden.N_CONTIGS, 32) and np.isfinite(latent).all()
    rows = [line.split("\t") for line in (out / TSVS[0]).read_text().splitlines()[1:]]
    members = sorted(r[1] for r in rows)
    expected = sorted(f"S{1 + i % 3}C{i}" for i in range(make_golden.N_CONTIGS))
    assert members == expected  # a full partition: every contig exactly once
    f1_port = pairwise_f1(out / TSVS[0])
    f1_golden = pairwise_f1(make_golden.GOLDEN_DIR / TSVS[0])
    assert abs(f1_port - f1_golden) <= 0.05, (f1_port, f1_golden)
    for name in TSVS:
        assert (out / name).read_bytes() == (make_golden.GOLDEN_DIR / name).read_bytes(), name


def test_unported_subcommands_and_flags_fail_loudly(data, tmp_path):
    # every subcommand runs now: `bin avamb` and `avamb_ensemble` fail on
    # their missing inputs, not as unported; `bin avamb --dist` outside
    # torchrun's environment fails as `bin default --dist` does, when the
    # process group finds no RANK to join with
    with pytest.raises(ValueError, match="abundance"):
        torch_main(["bin", "avamb", "--outdir", str(tmp_path), "--fasta",
                    str(data / "contigs.fna")], device="cpu")
    with pytest.raises(ValueError, match="--clusters"):
        torch_main(["avamb_ensemble", "--outdir", str(tmp_path / "e"), "--fasta",
                    str(data / "contigs.fna")], device="cpu")
    for model in ("avamb", "default"):
        with pytest.raises(ValueError, match="RANK"):
            torch_main(["bin", model, "--outdir", str(tmp_path / f"o3{model}"), "--fasta",
                        str(data / "contigs.fna"), "--abundance_tsv", str(data / "abundance.tsv"),
                        "--dist"], device="cpu")
    # bf16 training and bfloat16 distances are ported: the run completes
    torch_main(["bin", "default", "--outdir", str(tmp_path / "o2"), "--fasta",
                str(data / "contigs.fna"), "--abundance_tsv", str(data / "abundance.tsv"),
                "--precision", "bf16", "--distance_dtype", "bfloat16", "-e", "2", "-q", "1"],
               device="cpu")
    assert (tmp_path / "o2" / "vae_clusters_unsplit.tsv").is_file()

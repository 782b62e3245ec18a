"""`bin default` of the port held against vamb_tpu on the make_golden dataset
(tests/make_golden.py: 400 contigs, 25 planted groups, 4 samples, seed 41,
5 epochs, -q 2, -u 2).

(a) The port's `cluster_and_write_files` on the latent of vamb_tpu's run
    writes unsplit/split/metadata TSVs byte-identical to vamb_tpu's: given a
    latent, the two engines draw the same random stream and decide alike.
(b) The port's whole `bin default` on the CPU writes a full partition of
    the 400 contigs. Training draws its randomness from torch, not jax, so
    its bins differ from the golden's; the gate is the pairwise F1 against
    the 25 planted groups, within 0.05 of the golden's. Measured on the CPU:
    port 0.1768, golden tests/golden/vae_clusters_unsplit.tsv 0.1746.
"""

import numpy as np
import pytest

from vamb_torch.__main__ import main as torch_main
from vamb_torch.pipeline import ClusterOptions, cluster_and_write_files
from vamb_torch.utils import BinSplitter

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


def test_unported_subcommands_and_flags_fail_loudly(data, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_main(["recluster", "--outdir", str(tmp_path)], device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_main(["bin", "default", "--outdir", str(tmp_path / "o"), "--fasta",
                    str(data / "contigs.fna"), "--bamfiles", "x.bam"], device="cpu")
    with pytest.raises(NotImplementedError, match="subset"):
        torch_main(["bin", "default", "--outdir", str(tmp_path / "o2"), "--fasta",
                    str(data / "contigs.fna"), "--abundance_tsv", str(data / "abundance.tsv"),
                    "--wander_scope", "subset", "-e", "2", "-q", "1"], device="cpu")

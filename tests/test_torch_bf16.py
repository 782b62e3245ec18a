"""The port's bf16 switches held against vamb_tpu on the CPU.

* `--precision bf16` (the VAE's training passes in bf16, vamb_tpu
  models/vae.py:226-262, layers.py:44-111):
  - one training forward on injected eps and dropout masks: `mu` and the
    outputs within atol 2e-6 of `vamb_tpu`'s `apply` (measured: 3.6e-7 on
    `mu`, 7.2e-7 on the TNF output). Each op rounds to bf16 where jax's
    does, so only the f32 sums' order differs; a missing or extra rounding
    shows at 1e-2.
  - 8 optimizer steps (one epoch) in lockstep through the inject seam, as
    tests/test_torch_vae.py::test_training_lockstep runs 32 at f32: loss
    rtol 1e-3, D-Adaptation's d rtol 0.1, weights and BatchNorm statistics
    atol 1e-3 (measured over seeds 11-14: 5.8e-4, 0.054 and 4.0e-4). The
    gradients differ at the bf16 level from the first step: XLA's CPU code
    sums a bf16 bias gradient over the batch in bf16, row by row, where
    torch sums in f32 and rounds once (2e-2 relative on a bias gradient),
    and an f32 ulp of difference upstream can flip a bf16 rounding (2^-8
    relative). D-Adaptation's step size follows the gradients' sums, so
    the two runs drift apart from there on (weights 1e-2 apart after 16
    steps), which is why the window is one epoch.
  - `test_bf16_precision_trains_and_encodes_f32` (tests/test_vae.py)
    restated: the loss falls, `encode` equals an f32 twin's bit for bit,
    and `model.npz` records "bf16" in a file `vamb_tpu` loads.
* `distance_dtype="bfloat16"` (vamb_tpu cluster.py:1836-1943): the engine
  emission-identical to `vamb_tpu`'s bf16 engine (`compact_async=False`)
  on tests/test_cluster.py::TestBf16DistancePath's blobs and on the
  compaction-forced regime of its
  `test_compaction_partition_quality_determinism`; the bf16 plain versions
  bit for bit the f32 ones on the widened matrix; pairwise co-membership
  agreement with f32 above 0.95 (vamb_tpu's criterion); subset wander and
  attempt lanes "on" raise ValueError in both packages, and the kernels that
  only the subset wander runs refuse a bf16 matrix.
* The CLI: `bin default --precision bf16 --distance_dtype bfloat16` on
  the make_golden dataset in both packages: the port writes a full
  partition and a "bf16" `model.npz`, and its clustering of `vamb_tpu`'s
  latent at bf16 writes `vamb_tpu`'s TSVs byte for byte.
"""

import io

import numpy as np
import pytest
import torch

import jax

from vamb_torch import kernels as K
from vamb_torch.__main__ import main as torch_main
from vamb_torch.cluster import ClusterGenerator as TorchGenerator
from vamb_torch.models import VAE as TVAE
from vamb_torch.models import dataset as t_dataset
from vamb_torch.optim import DAdaptAdam
from vamb_torch.pipeline import ClusterOptions, cluster_and_write_files
from vamb_torch.utils import BinSplitter
from vamb_torch.utils.checkpoint import flatten_tree, load_flat, params_from_jax, params_to_jax

from vamb_tpu import cluster as j_cluster
from vamb_tpu.__main__ import main as jax_main
from vamb_tpu.models import VAE as JVAE
from vamb_tpu.optim import dadapt_adam

from . import make_golden
from .test_torch_cluster import _LIKE_JAX, _assert_same_emission, _clumpy_data
from .test_vae import make_raw

CPU = torch.device("cpu")
S, NLATENT, NHIDDENS = 4, 8, [32, 16]
DROP = 0.2


# ------------------------------------------------------------- the VAE


def _vae_pair(seed: int = 7):
    "vamb_tpu's bf16 VAE and the port's, with the same weights."
    jvae = JVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=seed, dropout=DROP,
                precision="bf16")
    tvae = TVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=seed, dropout=DROP,
                device=CPU, precision="bf16")
    tvae.load_state_dict(params_from_jax(flatten_tree({"params": jvae.params,
                                                       "bn_state": jvae.bn_state})))
    return jvae, tvae


def _batch_data(rng, n: int):
    "tests/test_torch_vae.py::test_training_lockstep's data."
    group = rng.integers(0, 8, n)
    profiles = rng.dirichlet(np.ones(S) * 0.4, 8).astype(np.float32)
    depths = (profiles[group] + rng.uniform(0, 0.02, (n, S))).astype(np.float32)
    depths /= depths.sum(1, keepdims=True)
    tnf = (rng.normal(size=(8, 103))[group] * 0.5 + 0.1 * rng.normal(size=(n, 103))).astype(np.float32)
    ab = rng.normal(size=(n, 1)).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    return depths, tnf, ab, weights


def _inject(rng, b: int):
    "Injected eps and pre-scaled dropout masks for one step (numpy, then torch)."
    keep_scale = np.float32(1.0 / (1.0 - DROP))
    inject = {"eps": rng.standard_normal((b, NLATENT)).astype(np.float32),
              "enc_masks": [(rng.random((b, w)) >= DROP).astype(np.float32) * keep_scale
                            for w in NHIDDENS],
              "dec_masks": [(rng.random((b, w)) >= DROP).astype(np.float32) * keep_scale
                            for w in NHIDDENS[::-1]]}
    t_inject = {"eps": torch.from_numpy(inject["eps"]),
                "enc_masks": [torch.from_numpy(m) for m in inject["enc_masks"]],
                "dec_masks": [torch.from_numpy(m) for m in inject["dec_masks"]]}
    return inject, t_inject


def test_bf16_training_forward_matches_vamb_tpu():
    """One training forward at bf16 on injected draws: jax's bf16 roundings
    op for op (dense, LeakyReLU's slope, the BatchNorm casts), so the
    outputs agree to f32 sum-order noise."""
    rng = np.random.default_rng(3)
    jvae, tvae = _vae_pair()
    d, t, a, _ = _batch_data(rng, 64)
    inject, t_inject = _inject(rng, 64)
    (jd, jt, ja, jmu), _ = jvae.apply(jvae.params, jvae.bn_state, d, t, a, train=True,
                                      inject=inject)
    tvae.train()
    with torch.no_grad():
        td, tt, ta, tmu = tvae(torch.from_numpy(d), torch.from_numpy(t), torch.from_numpy(a),
                               inject=t_inject)
    for name, x, y in (("mu", tmu, jmu), ("depths", td, jd), ("tnf", tt, jt), ("ab", ta, ja)):
        assert x.dtype == torch.float32, name
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=2e-6, err_msg=name)
    # the f32 forward on the same weights differs at the bf16 level
    f32 = TVAE(nsamples=S, nhiddens=NHIDDENS, nlatent=NLATENT, seed=7, dropout=DROP, device=CPU)
    f32.load_state_dict(tvae.state_dict())
    f32.train()
    with torch.no_grad():
        fmu = f32(torch.from_numpy(d), torch.from_numpy(t), torch.from_numpy(a), inject=t_inject)[3]
    assert float((fmu - tmu).abs().max()) > 1e-4


def test_bf16_training_lockstep():
    """8 steps (one epoch) of both packages' bf16 training on injected
    eps and dropout masks, D-Adaptation in both; the gates are the
    module's."""
    N, B = 256, 32
    rng = np.random.default_rng(11)
    depths, tnf, ab, weights = _batch_data(rng, N)
    jvae, tvae = _vae_pair()
    opt_j = dadapt_adam()
    params, bn_state = jvae.params, jvae.bn_state
    opt_state = opt_j.init(params)
    opt_t = DAdaptAdam(tvae.parameters_flat_order())

    @jax.jit
    def jax_step(params, bn_state, opt_state, batch, inject):
        d_in, t_in, a_in, w = batch

        def loss_fn(params, bn_state):
            (d, t, a, mu), new_state = jvae.apply(
                params, bn_state, d_in, t_in, a_in, train=True, inject=inject)
            loss, *_ = jvae.calc_loss(d_in, d, t_in, t, a_in, a, mu, w)
            return loss, new_state

        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, bn_state)
        updates, opt_state = opt_j.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        return params, new_state, opt_state, loss

    tvae.train()
    perm = rng.permutation(N)
    for b in range(N // B):
        idx = perm[b * B : (b + 1) * B]
        inject, t_inject = _inject(rng, B)
        batch = (depths[idx], tnf[idx], ab[idx], weights[idx])
        params, bn_state, opt_state, jloss = jax_step(params, bn_state, opt_state, batch, inject)
        tb = [torch.from_numpy(x) for x in batch]
        d_o, t_o, a_o, mu_o = tvae(tb[0], tb[1], tb[2], inject=t_inject)
        tloss, *_ = tvae.calc_loss(tb[0], d_o, tb[1], t_o, tb[2], a_o, mu_o, tb[3])
        opt_t.zero_grad(set_to_none=True)
        tloss.backward()
        opt_t.step()
        np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-3,
                                   err_msg=f"loss drift at step {b}")
    np.testing.assert_allclose(float(opt_t.d), float(opt_state.d), rtol=0.1)
    flat_t = params_to_jax(tvae.state_dict())
    flat_j = flatten_tree({"params": params, "bn_state": bn_state})
    assert flat_t.keys() == flat_j.keys()
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k], flat_j[k], atol=1e-3, err_msg=k)


def test_bf16_precision_trains_and_encodes_f32():
    """tests/test_vae.py's test restated for the port: the bf16 loss falls,
    `encode` gives the exact f32 forward (an f32 twin with the same
    weights encodes the same bits), and `model.npz` records "bf16" in a
    file `vamb_tpu` loads."""
    ab, tnf, lengths = make_raw(n=200, s=3, seed=1)
    ds = t_dataset.make_dataset(ab, tnf, lengths)
    vae = TVAE(nsamples=3, nhiddens=[64, 64], nlatent=8, seed=0, device=CPU, precision="bf16")
    lines = []
    vae.trainmodel(ds, nepochs=5, batchsize=32, batchsteps=None, logger=lines.append)
    losses = [float(ln.split("Loss: ")[1].split()[0]) for ln in lines if "Loss:" in ln]
    assert losses[-1] < losses[0], losses
    assert any("Precision: bf16" in ln for ln in lines)
    latent = vae.encode(ds)
    assert np.isfinite(latent).all()
    twin = TVAE(nsamples=3, nhiddens=[64, 64], nlatent=8, seed=0, device=CPU)
    twin.load_state_dict(vae.state_dict())
    np.testing.assert_array_equal(latent, twin.encode(ds))

    buf = io.BytesIO()
    vae.save(buf)
    buf.seek(0)
    assert load_flat(buf)[1]["precision"] == "bf16"
    buf.seek(0)
    back = TVAE.load(buf, device=CPU)
    assert back.precision == "bf16" and back._compute_dtype == torch.bfloat16
    buf.seek(0)
    assert JVAE.load(buf).precision == "bf16"


# ------------------------------------------------------------- the engine


def _blobs():
    "tests/test_cluster.py::TestBf16DistancePath's 20 blobs of 30 points in 24 dimensions."
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(20, 24)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    matrix = np.concatenate(
        [c + rng.normal(scale=0.03, size=(30, 24)) for c in centers]).astype(np.float32)
    return matrix, rng.integers(2000, 9000, len(matrix)).astype(np.float32)


def _compaction_blobs():
    "test_compaction_partition_quality_determinism's 24 blobs of 80 points in 16 dimensions."
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((24, 16)).astype(np.float32) * 8
    matrix = np.concatenate(
        [c + 0.01 * rng.standard_normal((80, 16)) for c in centers]).astype(np.float32)
    return matrix, rng.integers(2000, 9000, len(matrix))


@pytest.mark.parametrize("regime", ["blobs", "compaction"])
def test_bf16_engine_matches_vamb_tpu(regime):
    """The port's bf16 engine against `vamb_tpu`'s, cluster for cluster, as
    the f32 parity tests compare; the compaction regime compacts mid-run."""
    if regime == "blobs":
        matrix, lengths = _blobs()
        gen = _assert_same_emission(matrix, lengths, rng_seed=2, jax_kwargs=_LIKE_JAX,
                                    distance_dtype="bfloat16")
    else:
        matrix, lengths = _compaction_blobs()
        gen = _assert_same_emission(matrix, lengths, rng_seed=5, jax_kwargs=_LIKE_JAX,
                                    distance_dtype="bfloat16", batch_clusters=4,
                                    compact_min_pad=128)
        assert gen.compactions
    assert gen.matrixT.dtype == torch.bfloat16 and gen.Q == 0


def test_bf16_matrix_is_the_rounded_f32_one_in_f32_order():
    """The engine order is taken on the f32 matrix and the stored matrix is
    its round-to-nearest-even bf16 copy."""
    matrix, lengths = _blobs()
    gen = TorchGenerator(matrix.copy(), lengths, rng_seed=2, device="cpu", distance_dtype="bfloat16")
    f32 = TorchGenerator(matrix.copy(), lengths, rng_seed=2, device="cpu")
    np.testing.assert_array_equal(gen._order, f32._order)
    assert torch.equal(gen.matrixT, f32.matrixT.to(torch.bfloat16))
    jgen = j_cluster.ClusterGenerator(matrix.copy(), lengths, rng_seed=2, distance_dtype="bfloat16",
                                      compact_async=False)
    np.testing.assert_array_equal(gen._order, jgen._order)
    np.testing.assert_array_equal(gen.matrixT.float().numpy(),
                                  np.asarray(jgen.matrixT).astype(np.float32))


@pytest.mark.parametrize("kernel", ["medoid_sweep", "spec_sweep", "candidate_density_sweep"])
def test_bf16_plain_versions_are_the_f32_ones_widened(kernel):
    """Each bf16-reading wrapper on a CPU bf16 matrix gives the f32 plain
    version's bits on the widened matrix, and not those of the unrounded
    f32 matrix."""
    mT32, w = _clumpy_data(4 * 256 + 100, seed=5)
    mT32 = torch.from_numpy(np.ascontiguousarray(mT32))
    w = torch.from_numpy(w.astype(np.float32))
    mT = mT32.to(torch.bfloat16)
    n = mT.shape[1]
    if kernel == "medoid_sweep":
        call = lambda m: K.medoid_sweep(m, 37, w)  # noqa: E731
        plain = lambda m: K.medoid_sweep_plain(m, 37, w)  # noqa: E731
    elif kernel == "spec_sweep":
        cols = [n - 1, 0, 37, 500, 37]
        call = lambda m: K.spec_sweep(m, cols, w)  # noqa: E731
        plain = lambda m: K.spec_sweep_plain(m, cols, w)  # noqa: E731
    else:
        cand = torch.tensor([3, 37, 800, n - 1])
        call = lambda m: (K.candidate_density_sweep(m, cand, w),)  # noqa: E731
        plain = lambda m: (K.candidate_density_plain(m, cand, w),)  # noqa: E731
    got, widened, unrounded = call(mT), plain(mT.float()), call(mT32)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, widened))
    assert all(torch.equal(a, b) for a, b in zip(plain(mT), widened))
    assert not torch.equal(got[0], unrounded[0])


def test_bf16_subset_only_kernels_refuse_a_bf16_matrix():
    mT = torch.zeros(8, 256, dtype=torch.bfloat16)
    w, kept, d0 = torch.ones(256), torch.ones(256, dtype=torch.bool), torch.zeros(256)
    bids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        K.row_sweep(mT, 0)
    with pytest.raises(ValueError, match="float32"):
        K.gather_blocks(mT, bids)
    with pytest.raises(ValueError, match="float32"):
        K.gather_ball(mT, bids, 1, w, kept, d0)
    with pytest.raises(ValueError, match="float32"):
        K.medoid_sweep(mT.to(torch.float16), 0, w)


def test_bf16_pairwise_agreement_with_f32():
    """tests/test_cluster.py::test_bf16_partition_and_agreement for the
    port: a full partition, and co-membership agreeing with the f32
    engine's on more than 0.95 of 4,000 sampled pairs."""
    matrix, lengths = _blobs()
    f32 = list(TorchGenerator(matrix.copy(), lengths, rng_seed=2, device="cpu"))
    bf16 = list(TorchGenerator(matrix.copy(), lengths, rng_seed=2, device="cpu",
                               distance_dtype="bfloat16"))
    members = np.sort(np.concatenate([c.members for c in bf16]))
    np.testing.assert_array_equal(members, np.arange(len(matrix)))

    def labels(clusters):
        lab = np.empty(len(matrix), np.int32)
        for i, c in enumerate(clusters):
            lab[c.members] = i
        return lab

    la, lb = labels(f32), labels(bf16)
    idx = np.random.default_rng(8).integers(0, len(matrix), (4000, 2))
    agreement = float(np.mean((la[idx[:, 0]] == la[idx[:, 1]]) == (lb[idx[:, 0]] == lb[idx[:, 1]])))
    assert agreement > 0.95, agreement


@pytest.mark.parametrize("package", ["vamb_torch", "vamb_tpu"])
@pytest.mark.parametrize("kwargs,match", [({"wander_scope": "subset"}, "float32 distances"),
                                          ({"attempt_batch": "on"}, "requires the subset wander")])
def test_bf16_subset_and_lanes_raise(package, kwargs, match):
    "bf16 distances never take the subset wander, so lanes 'on' has nothing to ride."
    m = np.ones((4, 8), np.float32)
    lengths = np.full(4, 2000.0, np.float32)
    with pytest.raises(ValueError, match=match):
        if package == "vamb_torch":
            TorchGenerator(m, lengths, device="cpu", distance_dtype="bfloat16", **kwargs)
        else:
            j_cluster.ClusterGenerator(m, lengths, distance_dtype="bfloat16", compact_async=False,
                                       **kwargs)


# ----------------------------------------------------------------- the CLI


def test_bin_default_bf16_through_the_cli(tmp_path):
    """`bin default --precision bf16 --distance_dtype bfloat16` in both
    packages on the make_golden dataset: the port's run writes every
    artifact, a full partition and a "bf16" model; clustering vamb_tpu's
    latent at bf16 with the port writes vamb_tpu's TSVs byte for byte."""
    data = tmp_path / "data"
    data.mkdir()
    make_golden.write_synthetic_dataset(data)
    args = ["--fasta", str(data / "contigs.fna"), "--abundance_tsv", str(data / "abundance.tsv"),
            "-e", str(make_golden.EPOCHS), "-q", "2", "--seed", str(make_golden.SEED),
            "-u", str(make_golden.MIN_SUCCESSES), "--precision", "bf16",
            "--distance_dtype", "bfloat16"]
    out, jout = tmp_path / "port", tmp_path / "jax"
    torch_main(["bin", "default", "--outdir", str(out), *args], device="cpu")
    jax_main(["bin", "default", "--outdir", str(jout), *args])
    tsvs = ("vae_clusters_unsplit.tsv", "vae_clusters_split.tsv", "vae_clusters_metadata.tsv")
    for name in ("composition.npz", "abundance.npz", "model.npz", "latent.npz", *tsvs):
        assert (out / name).is_file(), name
    assert load_flat(out / "model.npz")[1]["precision"] == "bf16"
    assert JVAE.load(out / "model.npz").precision == "bf16"
    assert "Precision: bf16" in (out / "log.txt").read_text()
    latent = np.load(out / "latent.npz")["arr_0"]
    assert latent.shape == (make_golden.N_CONTIGS, 32) and np.isfinite(latent).all()
    rows = [line.split("\t") for line in (out / tsvs[0]).read_text().splitlines()[1:]]
    assert sorted(r[1] for r in rows) == sorted(f"S{1 + i % 3}C{i}"
                                                for i in range(make_golden.N_CONTIGS))

    comp = np.load(jout / "composition.npz", allow_pickle=True)
    names = list(comp["identifiers"])
    binsplitter = BinSplitter(None)
    binsplitter.initialize(names)
    cluster_and_write_files(
        ClusterOptions(min_successes=make_golden.MIN_SUCCESSES, distance_dtype="bfloat16"),
        binsplitter, np.load(jout / "latent.npz")["arr_0"], names, comp["lengths"],
        make_golden.SEED, str(tmp_path / "vae_clusters"), device="cpu")
    for name in tsvs:
        assert (tmp_path / name).read_bytes() == (jout / name).read_bytes(), name

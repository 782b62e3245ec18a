"""The port's clustering engine and its kernels held against vamb_tpu.

* The plain versions of `row_sweep` / `candidate_density_sweep` (what the
  wrappers run for CPU tensors) against `vamb_tpu.ops.pallas_cluster` in
  interpret mode, as tests/test_pallas.py runs the Pallas kernels, with that
  file's tolerances: d atol 2e-7 and d[idx] == 0.0 exactly, densities
  rtol 1e-5 (f32 sums in another order).
* The engine on the CPU against `vamb_tpu.cluster.ClusterGenerator` with
  the switches the port implements (full-scope wander, no attempt lanes,
  no compaction), on the regimes of tests/test_parity_cluster.py, field by
  field as its `assert_same_emission` compares: members (in emission
  order), medoid, seed and kind exactly, radius atol 1e-7, observed pvr rtol 1e-5, pvr atol 1e-6.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vamb_torch import kernels as K
from vamb_torch.cluster import ClusterGenerator as TorchGenerator
from vamb_torch.cluster import engine_order, normalize

from vamb_tpu import cluster as j_cluster
from vamb_tpu.ops import pallas_cluster as P

from .test_parity_cluster import clumpy_latents


def _data(n, f=40, seed=0):
    "tests/test_pallas.py's make_data: normalized columns, ~10% zero weights."
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 32)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True) * np.sqrt(2)
    mT = np.zeros((f, n), np.float32)
    mT[:32] = m.T
    wts = np.where(rng.random(n) < 0.9, rng.integers(2000, 50_000, n), 0).astype(np.float32)
    return mT, wts


def _clumpy_data(n, seed):
    "Columns in tight clumps, so densities sum many terms (engine-like)."
    m, lengths = clumpy_latents(-(-n // 30), 30, 32, seed=seed)
    mT = np.ascontiguousarray(normalize(m[:n]).T)
    return mT, lengths[:n]


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("idx", [0, 123, 4095])
def test_row_sweep_plain_matches_pallas(idx):
    n = P.pallas_pad_multiple()
    mT, _ = _data(n, seed=3)
    expect = np.asarray(P.row_sweep(jnp.asarray(mT), idx, interpret=True))
    got = K.row_sweep(torch.from_numpy(mT), idx).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-7)
    assert got[idx] == 0.0


@pytest.mark.parametrize("c", [1, 7, 25, 32])
@pytest.mark.parametrize("clumpy", [False, True])
def test_candidate_density_plain_matches_pallas(c, clumpy):
    n = P.pallas_pad_multiple()
    if clumpy:
        mT, lengths = _clumpy_data(n, seed=c)
        wts = np.where(np.arange(n) % 3 == 0, 0.0, lengths).astype(np.float32)
    else:
        mT, wts = _data(n, seed=2)
    cand = np.random.default_rng(c).choice(n, size=c, replace=False).astype(np.int32)
    expect = np.asarray(P.candidate_density_sweep(
        jnp.asarray(mT), jnp.asarray(cand), jnp.asarray(wts), interpret=True))
    got = K.candidate_density_sweep(
        torch.from_numpy(mT), torch.from_numpy(cand), torch.from_numpy(wts)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_wrappers_reject_bad_inputs():
    mT = torch.zeros(8, 256)
    with pytest.raises(IndexError):
        K.row_sweep(mT, 256)
    with pytest.raises(ValueError):
        K.candidate_density_sweep(mT, torch.arange(33), torch.ones(256))
    with pytest.raises(ValueError):
        K.row_sweep(mT.T, 0)  # not contiguous


# -------------------------------------------------------------- engine


def _assert_same_emission(matrix, lengths, rng_seed=0, **kwargs):
    jax_side = list(j_cluster.ClusterGenerator(
        matrix.copy(), lengths, rng_seed=rng_seed, wander_scope="full",
        attempt_batch="off", compact=False, **kwargs))
    port = list(TorchGenerator(matrix.copy(), lengths, rng_seed=rng_seed, device="cpu", **kwargs))
    assert len(port) == len(jax_side)
    for i, (e, o) in enumerate(zip(jax_side, port)):
        ctx = f"cluster {i}/{len(port)}"
        assert o.kind_str == e.kind_str, ctx
        assert o.medoid == int(e.medoid), ctx
        assert o.seed == int(e.seed), ctx
        np.testing.assert_array_equal(o.members, e.members, err_msg=ctx)
        if e.radius is None:
            assert o.radius is None, ctx
        else:
            np.testing.assert_allclose(o.radius, e.radius, atol=1e-7, err_msg=ctx)
        if e.observed_pvr is None:
            assert o.observed_pvr is None, ctx
        else:
            np.testing.assert_allclose(o.observed_pvr, e.observed_pvr, rtol=1e-5, err_msg=ctx)
        np.testing.assert_allclose(o.maximal_pvr, e.maximal_pvr, atol=1e-6, err_msg=ctx)
        assert (o.successes, o.attempts) == (e.successes, e.attempts), ctx
    members = np.concatenate([c.members for c in port])
    np.testing.assert_array_equal(np.sort(members), np.arange(len(matrix)))


def test_engine_clumpy_normal_regime():
    "Well-separated clumps: mostly normal clusters at pvr 0.1."
    matrix, lengths = clumpy_latents(40, 30, 32, seed=1)
    _assert_same_emission(matrix, lengths, rng_seed=3)


def test_engine_mixed_regime_with_noise():
    "Clumps + 20% uniform noise: normal, loner, reject and pvr bumps."
    matrix, lengths = clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2)
    _assert_same_emission(matrix, lengths, rng_seed=7, windowsize=60)


def test_engine_uniform_fallback_regime():
    "Uniform latents: pvr climbs past 0.55, then radius-0.06 fallbacks."
    rng = np.random.default_rng(3)
    matrix = rng.normal(size=(600, 32)).astype(np.float32)
    lengths = rng.integers(2000, 10_000, 600).astype(np.float32)
    _assert_same_emission(matrix, lengths, rng_seed=11, windowsize=40, minsuccesses=5)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_engine_tiny_inputs(n):
    rng = np.random.default_rng(n)
    matrix = rng.normal(size=(n, 8)).astype(np.float32)
    lengths = np.full(n, 2500.0, np.float32)
    _assert_same_emission(matrix, lengths, rng_seed=n, windowsize=10, minsuccesses=2)


def test_engine_order_matches():
    matrix, lengths = clumpy_latents(10, 20, 32, seed=4)
    norm = normalize(matrix)
    np.testing.assert_array_equal(norm, j_cluster.normalize(matrix.copy()))
    order, ranks = engine_order(norm, lengths, 9)
    j_order, j_ranks = j_cluster.engine_order(norm, lengths, 9)
    np.testing.assert_array_equal(order, np.asarray(j_order))
    np.testing.assert_array_equal(ranks, np.asarray(j_ranks))


@pytest.mark.parametrize(
    "kwargs,match",
    [({"wander_scope": "subset"}, "subset"), ({"attempt_batch": "on"}, "attempt lanes"),
     ({"compact": True}, "compaction"), ({"distance_dtype": "bfloat16"}, "bfloat16")],
)
def test_unported_switches_fail_loudly(kwargs, match):
    m = np.ones((4, 8), np.float32)
    with pytest.raises(NotImplementedError, match=match):
        TorchGenerator(m, np.full(4, 2000.0, np.float32), device="cpu", **kwargs)

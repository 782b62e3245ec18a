"""The wander step's draw and selection against `vamb_tpu`'s expression:
the Gumbel scores (`kernels.gumbel_scores` on CPU tensors) bit for bit
(compared as int32 bit patterns), and the candidates
(`kernels.gumbel_topc` on CPU tensors, which the engine's `_step` calls)
index for index, the -inf slots included:

    elig = (d <= 0.05) & kept & ~tried & (iota != medoid)
    score = where(elig, -log(-log(uniform(k1, (n,)) + 1e-20) + 1e-20), -inf)
    _, cand = jax.lax.top_k(score, C); cand_valid = elig[cand]

(vamb_tpu/cluster.py:674-681, :775-782; exact top_k, as `vamb_tpu` takes
on the CPU), eagerly and jitted as the engine's while-loop body runs it.
Keys come from a seed through the engine's split chain; n is a subset
ball's 8,192 columns and the 100,000-contig path's 100,096; the masks
leave no column, some columns and every column but the medoid's eligible;
C is 1, the engine's 25 and the most, 32. Gumbel scores tie (the uniform
has 2^23 values), and `jax.lax.top_k` puts the lower index first, where
`torch.topk` need not: two steps of the `PRNGKey(0)` chain whose top 25
hold a tie pin that order. The engine's emissions on every parity regime
stay those of tests/test_torch_cluster.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vamb_torch import kernels as K
from vamb_torch.utils import threefry

_RADIUS = 0.05


def _vamb_tpu_scores(k1, d, kept, tried, medoid):
    n = d.shape[0]
    elig = (d <= _RADIUS) & kept & ~tried & (jnp.arange(n) != medoid)
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(k1, (n,)) + 1e-20) + 1e-20)
    return jnp.where(elig, gumbel, -jnp.inf)


def _vamb_tpu_step(k1, d, kept, tried, medoid, c):
    "The scores, `vamb_tpu`'s candidates and their eligibility."
    score = _vamb_tpu_scores(k1, d, kept, tried, medoid)
    _, cand = jax.lax.top_k(score, c)
    return score, cand, score[cand] > -jnp.inf


_JIT_STEP = jax.jit(_vamb_tpu_step, static_argnums=5)


def _masks(kind: str, n: int, rng):
    if kind == "none":
        return (rng.random(n).astype(np.float32) * 0.1, np.zeros(n, bool), np.zeros(n, bool))
    if kind == "all":
        return np.zeros(n, np.float32), np.ones(n, bool), np.zeros(n, bool)
    return (rng.random(n).astype(np.float32) * 0.1, rng.random(n) < 0.8, rng.random(n) < 0.1)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("c", [1, 25, 32])
@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
@pytest.mark.parametrize("n", [8_192, 100_096])
@pytest.mark.parametrize("mask", ["none", "some", "all"])
def test_gumbel_scores_are_vamb_tpus(seed, n, mask, c):
    rng = np.random.default_rng(seed + n)
    d, kept, tried = _masks(mask, n, rng)
    medoid = int(rng.integers(n))
    args_t = (torch.as_tensor(d), torch.as_tensor(kept), torch.as_tensor(tried), medoid)
    args_j = (jnp.asarray(d), jnp.asarray(kept), jnp.asarray(tried), medoid)
    # three links of the engine's chain: key, k1 = split(key)
    kj, kt = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    for _ in range(3):
        (kj, k1j), (kt, k1t) = jax.random.split(kj), threefry.split_host(kt)
        got = K.gumbel_scores(k1t, *args_t).numpy()
        cand, valid = K.gumbel_topc(k1t, *args_t, c)
        assert cand.dtype == torch.int64 and valid.dtype == torch.bool
        for score, cand_j, valid_j in (_vamb_tpu_step(k1j, *args_j, c), _JIT_STEP(k1j, *args_j, c)):
            assert np.array_equal(_bits(got), _bits(score))
            assert np.array_equal(cand.numpy(), np.asarray(cand_j))
            assert np.array_equal(valid.numpy(), np.asarray(valid_j))
    n_elig = int(np.isfinite(got).sum())
    assert (n_elig == 0) if mask == "none" else (n_elig == n - 1 if mask == "all" else 0 < n_elig < n)
    assert int(valid.sum()) == min(c, n_elig)


@pytest.mark.parametrize("step", [745, 1603])
def test_gumbel_topc_tied_scores_take_jaxs_order(step):
    """Steps of the `key, k1 = split(key)` chain from PRNGKey(0) whose top
    25 of 8,192 scores (every column eligible but the medoid's) hold two
    equal scores: the port's candidates are `jax.lax.top_k`'s, the lower
    index first."""
    n, c, medoid = 8_192, 25, 0
    kj, kt = jax.random.PRNGKey(0), threefry.PRNGKey(0)
    for _ in range(step + 1):
        (kj, k1j), (kt, k1t) = jax.random.split(kj), threefry.split_host(kt)
    d, kept, tried = _masks("all", n, None)
    score, cand_j, _ = _vamb_tpu_step(k1j, jnp.asarray(d), jnp.asarray(kept), jnp.asarray(tried),
                                      medoid, c)
    top = np.asarray(score)[np.asarray(cand_j)]
    assert len(np.unique(top)) < c, "no tie in the top C: the case would not test the order"
    cand, valid = K.gumbel_topc(k1t, torch.as_tensor(d), torch.as_tensor(kept),
                                torch.as_tensor(tried), medoid, c)
    assert np.array_equal(cand.numpy(), np.asarray(cand_j))
    assert bool(valid.all())


def test_gumbel_scores_rejects_bad_inputs():
    d = torch.zeros(16)
    flags = torch.zeros(16, dtype=torch.bool)
    with pytest.raises(ValueError):
        K.gumbel_scores((1, 2), d.double(), flags, flags, 0)
    with pytest.raises(ValueError):
        K.gumbel_scores((1, 2), d, flags.float(), flags, 0)
    with pytest.raises(IndexError):
        K.gumbel_scores((1, 2), d, flags, flags, 16)


@pytest.mark.parametrize("c", [0, 33, -1, 17])
def test_gumbel_topc_rejects_c_out_of_range(c):
    "C lies in 1..n (here 16): the kernel takes C above 32 in rounds."
    flags = torch.zeros(16, dtype=torch.bool)
    with pytest.raises(ValueError):
        K.gumbel_topc((1, 2), torch.zeros(16), flags, flags, 0, c)


@pytest.mark.parametrize("bad", ["d float64", "kept float32", "tried uint8", "d 2-D", "short kept"])
def test_gumbel_topc_rejects_bad_inputs(bad):
    d, kept, tried = torch.zeros(64), torch.ones(64, dtype=torch.bool), torch.zeros(64, dtype=torch.bool)
    if bad == "d float64":
        d = d.double()
    elif bad == "kept float32":
        kept = kept.float()
    elif bad == "tried uint8":
        tried = tried.to(torch.uint8)
    elif bad == "d 2-D":
        d = d.view(8, 8)
    else:
        kept = kept[:32]
    with pytest.raises(ValueError):
        K.gumbel_topc((1, 2), d, kept, tried, 0, 25)


def test_gumbel_topc_rejects_medoid_outside():
    flags = torch.zeros(64, dtype=torch.bool)
    with pytest.raises(IndexError):
        K.gumbel_topc((1, 2), torch.zeros(64), flags, flags, 64, 25)


def test_gumbel_scores_count_no_cpu_launch():
    "The CPU path runs the plain versions and counts no kernel launch."
    before = (K.gumbel_scores.launches, K.gumbel_topc.launches, dict(K.gumbel_topc.launches_by_width))
    flags = torch.ones(256, dtype=torch.bool)
    K.gumbel_scores((3, 4), torch.zeros(256), flags, ~flags, 5)
    cand, valid, score = K.gumbel_topc((3, 4), torch.zeros(256), flags, ~flags, 5, 25, with_scores=True)
    assert score.shape == (256,) and cand.shape == valid.shape == (25,)
    assert (K.gumbel_scores.launches, K.gumbel_topc.launches,
            dict(K.gumbel_topc.launches_by_width)) == before

"""The wander step's Gumbel scores (`kernels.gumbel_scores` on CPU tensors,
which the engine's `_step` calls) against `vamb_tpu`'s expression, bit for
bit (compared as int32 bit patterns):

    elig = (d <= 0.05) & kept & ~tried & (iota != medoid)
    score = where(elig, -log(-log(uniform(k1, (n,)) + 1e-20) + 1e-20), -inf)

(vamb_tpu/cluster.py:674-678, :775-779), eagerly and jitted as the engine's
while-loop body runs it. Keys come from a seed through the engine's split
chain; n is a subset ball's 8,192 columns and the 100,000-contig path's
100,096; the masks leave no column, some columns and every column but the
medoid's eligible. The engine's emissions on every parity regime stay those
of tests/test_torch_cluster.py.
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


_JIT_SCORES = jax.jit(_vamb_tpu_scores)


def _masks(kind: str, n: int, rng):
    if kind == "none":
        return (rng.random(n).astype(np.float32) * 0.1, np.zeros(n, bool), np.zeros(n, bool))
    if kind == "all":
        return np.zeros(n, np.float32), np.ones(n, bool), np.zeros(n, bool)
    return (rng.random(n).astype(np.float32) * 0.1, rng.random(n) < 0.8, rng.random(n) < 0.1)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 7, 2**32 + 5])
@pytest.mark.parametrize("n", [8_192, 100_096])
@pytest.mark.parametrize("mask", ["none", "some", "all"])
def test_gumbel_scores_are_vamb_tpus(seed, n, mask):
    rng = np.random.default_rng(seed + n)
    d, kept, tried = _masks(mask, n, rng)
    medoid = int(rng.integers(n))
    # three links of the engine's chain: key, k1 = split(key)
    kj, kt = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    for _ in range(3):
        (kj, k1j), (kt, k1t) = jax.random.split(kj), threefry.split_host(kt)
        got = K.gumbel_scores(k1t, torch.as_tensor(d), torch.as_tensor(kept),
                              torch.as_tensor(tried), medoid).numpy()
        eager = _vamb_tpu_scores(k1j, jnp.asarray(d), jnp.asarray(kept), jnp.asarray(tried), medoid)
        jitted = _JIT_SCORES(k1j, jnp.asarray(d), jnp.asarray(kept), jnp.asarray(tried), medoid)
        assert np.array_equal(_bits(got), _bits(eager))
        assert np.array_equal(_bits(got), _bits(jitted))
    n_elig = int(np.isfinite(got).sum())
    assert (n_elig == 0) if mask == "none" else (n_elig == n - 1 if mask == "all" else 0 < n_elig < n)


def test_gumbel_scores_rejects_bad_inputs():
    d = torch.zeros(16)
    flags = torch.zeros(16, dtype=torch.bool)
    with pytest.raises(ValueError):
        K.gumbel_scores((1, 2), d.double(), flags, flags, 0)
    with pytest.raises(ValueError):
        K.gumbel_scores((1, 2), d, flags.float(), flags, 0)
    with pytest.raises(IndexError):
        K.gumbel_scores((1, 2), d, flags, flags, 16)


def test_gumbel_scores_count_no_cpu_launch():
    "The CPU path runs the plain version and counts no kernel launch."
    before = K.gumbel_scores.launches
    flags = torch.ones(256, dtype=torch.bool)
    K.gumbel_scores((3, 4), torch.zeros(256), flags, ~flags, 5)
    assert K.gumbel_scores.launches == before

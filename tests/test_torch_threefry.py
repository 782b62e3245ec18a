"""The port's threefry stream (vamb_torch/utils/threefry.py) is bit-identical
to jax.random for the calls the clustering engine makes: PRNGKey(seed),
split(key) and uniform(key, (n,)) float32.

Seeds cover the CLI's range (`--seed` draws 7 random bytes, so up to
2**56 - 1), both sides of the 32-bit boundaries and the seeds the parity
tests use. Tolerance: none, the uint32 words and float bit patterns must
be equal.
"""

import numpy as np
import pytest
import torch

import jax

from vamb_torch.utils import threefry

SEEDS = [0, 3, 7, 41, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, 2**56 - 1, 2**56,
         0x0123456789ABCD]


def _words(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    assert np.array_equal(_words(jax.random.PRNGKey(seed)), threefry.PRNGKey(seed).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_split_chain(seed):
    "Ten links of the engine's `key, sub = split(key)` chain."
    kj, kt = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    for _ in range(10):
        sj, st = jax.random.split(kj), threefry.split(kt)
        assert np.array_equal(_words(sj), st.numpy())
        kj, kt = sj[0], st[0]


@pytest.mark.parametrize("num", [1, 3, 8])
def test_split_num(num):
    kj, kt = jax.random.PRNGKey(11), threefry.PRNGKey(11)
    assert np.array_equal(_words(jax.random.split(kj, num)), threefry.split(kt, num).numpy())


@pytest.mark.parametrize("seed", [0, 7, 2**56 - 1])
@pytest.mark.parametrize("n", [1, 2, 1001, 128 * 37])
def test_uniform_bits(seed, n):
    "Per-step wander draws over an odd and a padded width, after splits."
    kj, kt = jax.random.PRNGKey(seed), threefry.PRNGKey(seed)
    for _ in range(3):
        kj, k1j = jax.random.split(kj)
        kt, k1t = threefry.split(kt)
        uj = np.asarray(jax.random.uniform(k1j, (n,)))
        ut = threefry.uniform(k1t, n, torch.device("cpu")).numpy()
        assert ut.dtype == np.float32
        assert np.array_equal(uj.view(np.uint32), ut.view(np.uint32))

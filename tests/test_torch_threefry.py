"""The port's threefry stream (vamb_torch/utils/threefry.py) against
jax.random, for the calls the clustering engine and VAE training make.

* Bit-identical (the uint32 words, float bit patterns and indices must be
  equal): PRNGKey(seed) and key(seed), split(key, num), fold_in,
  bits(key, shape, uint32) and its little-endian byte view, uniform(key,
  (n,)) float32 and permutation(key, n).
* normal(key, (n,)) float32 (`normal_batched`) within 3 ulps: the erfinv
  polynomial is XLA's, but `log1p` inside it is torch's, not XLA's CPU
  one. Measured here: at most 3 ulps over 1,000,000 draws, with 4.7% of
  values off by one ulp or more (and never a sign).

Seeds cover the CLI's range (`--seed` draws 7 random bytes, so up to
2**56 - 1), both sides of the 32-bit boundaries and the seeds the parity
tests use.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

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


@pytest.mark.parametrize("seed", [0, 41, 2**32 + 5])
def test_key_and_split3(seed):
    "The VAE's `key(seed)` and the per-epoch `split(key, 3)`."
    kj, kt = jax.random.key(seed), threefry.key(seed)
    assert np.array_equal(_words(jax.random.key_data(kj)), kt.numpy())
    assert np.array_equal(_words(jax.random.key_data(jax.random.split(kj, 3))),
                          threefry.split(kt, 3).numpy())


@pytest.mark.parametrize("data", [0, 1, 5, 2**31 + 3, 2**32 - 1])
def test_fold_in(data):
    kj, kt = jax.random.key(9), threefry.key(9)
    assert np.array_equal(_words(jax.random.key_data(jax.random.fold_in(kj, data))),
                          threefry.fold_in(kt, data).numpy())


@pytest.mark.parametrize("shape", [(7,), (3, 5), (256, 257)])
def test_bits_and_bytes(shape):
    "uint32 words in row-major counter order, and their little-endian bytes."
    kj, kt = jax.random.key(13), threefry.key(13)
    wj = jax.random.bits(kj, shape, jnp.uint32)
    wt = threefry.bits(kt, shape)
    assert np.array_equal(_words(wj), wt.numpy())
    bj = np.asarray(jax.lax.bitcast_convert_type(wj, jnp.uint8)).reshape(*shape[:-1], -1)
    assert np.array_equal(bj, threefry.words_to_bytes(wt).numpy())


@pytest.mark.parametrize("n", [1, 2, 1000, 1625, 1626, 5000, 40_000])
def test_permutation(n):
    "One shuffle round up to n = 1625, two above: both sides of the step."
    kj, kt = jax.random.key(n), threefry.key(n)
    assert np.array_equal(np.asarray(jax.random.permutation(kj, n)),
                          threefry.permutation(kt, n).numpy())


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


def test_normal_within_three_ulps():
    kj, kt = jax.random.key(41), threefry.key(41)
    worst = 0
    draws = threefry.normal_batched(torch.stack([threefry.fold_in(kt, s) for s in range(10)]),
                                    100_000)
    for s in range(10):
        a = np.asarray(jax.random.normal(jax.random.fold_in(kj, s), (100_000,)))
        b = draws[s].numpy()
        assert b.dtype == np.float32 and (np.sign(a) == np.sign(b)).all()
        worst = max(worst, int(_ulps(a, b).max()))
    assert worst <= 3, worst


def test_normal_batched_rows_are_single_draws():
    "One batched draw equals a draw per key: the epoch's eps in one call."
    keys = threefry.split(threefry.key(3), 5)
    rows = threefry.normal_batched(keys, 77)
    for k, row in zip(keys, rows):
        assert np.array_equal(row.numpy(), threefry.normal_batched(k, 77)[0].numpy())


def test_erfinv_polynomial_within_three_ulps():
    x = np.linspace(-0.9999999, 0.9999999, 200_001, dtype=np.float32)
    a = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    b = threefry.erfinv_xla(torch.from_numpy(x)).numpy()
    assert int(_ulps(a, b).max()) <= 3

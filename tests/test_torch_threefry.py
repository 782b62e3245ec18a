"""The port's threefry stream (vamb_torch/utils/threefry.py) against
jax.random, for the calls the clustering engine and VAE training make.

* Bit-identical (the uint32 words, float bit patterns and indices must be
  equal): PRNGKey(seed) and key(seed), split(key, num), fold_in,
  bits(key, shape, uint32) and its little-endian byte view, uniform(key,
  (n,)) float32, bernoulli(key, p, shape) (the random tree cuts of
  models/hier.py) and permutation(key, n).
* normal(key, (n,)) float32 (`normal_batched`), its erfinv polynomial and
  the `log` / `log1p` of XLA's CPU code (`log_xla`, `log1p_xla`), bit for
  bit: over 1,000,000 draws, and for the logs over every mantissa at a few
  exponents, a stride of mantissas at every exponent, and 0, denormals, 1,
  inf and nan (compared as int32 bit patterns, so NaN payloads count too).

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


@pytest.mark.parametrize("p", [0.0, 0.01, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("shape", [(1,), (7, 33), (2, 3, 40)])
def test_bernoulli(p, shape):
    for seed in (0, 41, 2**32 + 5):
        want = np.asarray(jax.random.bernoulli(jax.random.key(seed), p, shape))
        got = threefry.bernoulli(threefry.key(seed), p, shape)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 1000, 1625, 1626, 5000, 40_000])
def test_permutation(n):
    "One shuffle round up to n = 1625, two above: both sides of the step."
    kj, kt = jax.random.key(n), threefry.key(n)
    assert np.array_equal(np.asarray(jax.random.permutation(kj, n)),
                          threefry.permutation(kt, n).numpy())


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_normal_within_three_ulps():
    "Bit for bit now: 1,000,000 draws of `normal` from ten folded keys."
    kj, kt = jax.random.key(41), threefry.key(41)
    draws = threefry.normal_batched(torch.stack([threefry.fold_in(kt, s) for s in range(10)]),
                                    100_000)
    for s in range(10):
        a = np.asarray(jax.random.normal(jax.random.fold_in(kj, s), (100_000,)))
        b = draws[s].numpy()
        assert b.dtype == np.float32
        np.testing.assert_array_equal(_bits(b), _bits(a), err_msg=f"key {s}")


def test_normal_batched_rows_are_single_draws():
    "One batched draw equals a draw per key: the epoch's eps in one call."
    keys = threefry.split(threefry.key(3), 5)
    rows = threefry.normal_batched(keys, 77)
    for k, row in zip(keys, rows):
        assert np.array_equal(row.numpy(), threefry.normal_batched(k, 77)[0].numpy())


def test_erfinv_polynomial_within_three_ulps():
    "Bit for bit now, both branches of the polynomial (w < 5 and w >= 5)."
    x = np.linspace(-0.9999999, 0.9999999, 200_001, dtype=np.float32)
    a = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    b = threefry.erfinv_xla(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(b), _bits(a))


_LOGS = {"log": (jnp.log, threefry.log_xla), "log1p": (jnp.log1p, threefry.log1p_xla)}
_SPECIALS = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40, -1e-40,
                      1.4e-45, -1.4e-45, 1.1754942e-38, 1.1754944e-38, -1.1754944e-38, 0.5,
                      -0.5, 2.0, 3.4028235e38, -3.4028235e38, 0.41421357, -0.41421357,
                      0.41421354, -0.29289323, 0.70710677, -0.99999994], np.float32)


def _assert_same_log(name: str, x: np.ndarray) -> None:
    jfn, tfn = _LOGS[name]
    expect = np.asarray(jax.jit(jfn)(x))
    got = tfn(torch.from_numpy(x)).numpy()
    bad = np.flatnonzero(_bits(got) != _bits(expect))
    assert len(bad) == 0, (name, len(bad), x[bad[:5]], expect[bad[:5]], got[bad[:5]])


@pytest.mark.parametrize("name", list(_LOGS))
@pytest.mark.parametrize("sign,exponent", [(0, 125), (0, 126), (1, 126)])
def test_log_xla_every_mantissa(name, sign, exponent):
    """Every one of the 2^23 mantissas at a biased exponent: [0.25, 0.5)
    holds log1p's switch between its two formulas at sqrt(2) - 1, [0.5, 1)
    the log's fold at sqrt(1/2), and [-1, -0.5) log1p's steep end."""
    m = np.arange(1 << 23, dtype=np.uint32)
    _assert_same_log(name, ((np.uint32(sign) << 31) | (np.uint32(exponent) << 23) | m)
                     .view(np.float32))


@pytest.mark.parametrize("name", list(_LOGS))
def test_log_xla_every_exponent_and_specials(name):
    """A stride of 2,047 mantissas at every exponent and sign (denormals,
    inf and nan payloads included), and the edge values."""
    m = np.arange(0, 1 << 23, 4099, dtype=np.uint32)
    e = np.arange(256, dtype=np.uint32)
    words = (e[:, None] << 23) | m[None, :]
    words = np.concatenate([words, words | np.uint32(1 << 31)]).ravel()
    _assert_same_log(name, np.concatenate([words.view(np.float32), _SPECIALS]))

"""JAX's threefry-2x32 random stream, written in torch.

Both device stages of `bin default` draw from jax's stream in `vamb_tpu`:
the clustering engine one uniform per padded column on every wander step
(vamb_tpu/cluster.py:674-677, :773-777), and VAE training its epoch
permutation, dropout byte bank and latent eps (vamb_tpu/models/vae.py:
234-247, 372-377, 414-419, 453). Reproducing those draws bit for bit lets
the port cluster a latent exactly as `vamb_tpu` does on the CPU and train
on the same batches and masks. This module re-implements the calls the two
stages make, for the jax configuration the package is held against (jax
0.9, `jax_threefry_partitionable=True`, 32-bit mode):

* `PRNGKey(seed)` / `key(seed)`: in 32-bit mode jax keeps the low 32 bits
  of the seed, so the key is `(0, seed & 0xFFFFFFFF)` (jax/_src/prng.py:
  817-829 after the int64 -> int32 canonicalisation of `random_seed`).
* `split(key, num)`: the fold-like split, threefry of the 64-bit counters
  0..num-1 (prng.py:1156-1160).
* `fold_in(key, data)`: threefry of the counter pair `(0, data)`.
* `bits(key, shape)`: `bits1 ^ bits2` of the counters 0..size-1 in
  row-major order, as uint32 words.
* `uniform(key, n)`: float32 uniforms in [0, 1) from those words with the
  mantissa trick of jax/_src/random.py:435-477.
* `permutation(key, n)`: jax's `_shuffle`, `ceil(3 ln n / ln(2^32 - 1))`
  rounds of a key split, 32-bit sort keys and a stable key-value sort.
* `normal_batched(keys, n)`: `normal(key, (n,))` per key, a uniform on
  [nextafter(-1, 0), 1), then sqrt(2) times XLA's float32 `ErfInv`
  polynomial (`erfinv_xla`). The polynomial is XLA's; `log1p` inside it
  is torch's, so a value can differ from `jax.random.normal` on the CPU by
  a few ulps (tests/test_torch_threefry.py states the bound it measures).

Keys are (2,) int64 tensors holding uint32 values. All arithmetic is int64
with explicit 32-bit masks, so the same code runs on the CPU and the card.
Splits hash a handful of counters and run on the host as Python ints; the
`*_batched` draws take one key per row, so a training epoch draws every
step's eps in one call instead of one call per step.
"""

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter pairs (x1, x2) under key (k1, k2),
    20 rounds, as jax's `_threefry2x32_lowering` computes it. Keys and
    counters are Python ints or int64 tensors holding uint32 values; tensors
    broadcast, so a (S, 1) column of keys hashes S rows of counters at
    once."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int) -> torch.Tensor:
    "jax.random.PRNGKey(seed) in jax's default 32-bit mode."
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


key = PRNGKey  # jax.random.key(seed): the same threefry key data


def _words(k) -> tuple[int, int]:
    return int(k[0]), int(k[1])


def split_host(k, num: int = 2) -> list[tuple[int, int]]:
    "split(k, num) as a list of (k1, k2) Python-int pairs."
    k1, k2 = _words(k)
    return [threefry2x32(k1, k2, i >> 32, i & _MASK) for i in range(num)]


def split(k, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): a (num, 2) int64 tensor of keys.

    The few counters are hashed as Python ints (the same masked arithmetic
    as on tensors): a key split is a handful of scalars, and tensor ops on
    them would cost a dispatch each."""
    return torch.tensor(split_host(k, num), dtype=torch.int64)


def fold_in(k, data: int) -> torch.Tensor:
    "jax.random.fold_in(key, data) for a uint32 `data`."
    k1, k2 = _words(k)
    return torch.tensor(threefry2x32(k1, k2, 0, int(data) & _MASK), dtype=torch.int64)


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    "The (hi, lo) halves of the 64-bit iota 0..n-1."
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return lo >> 32, lo & _MASK


def bits_batched(keys, n: int, device=None) -> torch.Tensor:
    """`bits(keys[s], (n,))` for every key of a (S, 2) list or tensor, in
    one hash of (S, n) counters: an (S, n) int64 tensor of uint32 words."""
    kt = torch.as_tensor(keys, dtype=torch.int64).reshape(-1, 2).to(device)
    hi, lo = _counters(n, device)
    b1, b2 = threefry2x32(kt[:, :1], kt[:, 1:], hi, lo)
    return b1 ^ b2


def bits(k, shape, device=None) -> torch.Tensor:
    "jax.random.bits(key, shape, uint32) as an int64 tensor of uint32 words."
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return bits_batched([_words(k)], math.prod(shape), device).reshape(shape)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 tensor, last dim W) -> uint8 bytes (last dim 4W),
    each word little-endian: `lax.bitcast_convert_type(words, uint8)`."""
    signed = ((words ^ 0x80000000) - 0x80000000).to(torch.int32)
    return signed.contiguous().view(torch.uint8)


def _unit_floats(words: torch.Tensor) -> torch.Tensor:
    "float32 in [0, 1) from the top 23 bits of each word (exponent of 1.0)."
    return ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(k, n: int, device=None) -> torch.Tensor:
    "jax.random.uniform(key, (n,)) as float32 on `device`."
    return torch.clamp_min(_unit_floats(bits(k, n, device)), 0.0)


def permutation(k, n: int, device=None) -> torch.Tensor:
    """jax.random.permutation(key, n): jax's sort-based `_shuffle` of
    arange(n), as an int64 tensor on `device`."""
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=device)
    for _ in range(rounds):
        k, sub = split_host(k)
        order = torch.sort(bits(sub, n, device), stable=True).indices
        x = x[order]
    return x


# XLA's float32 ErfInv (Giles' single-precision approximation), the
# constants of xla/client/lib/math.cc ErfInv32 and of CHLO's erf_inv
# lowering, evaluated in the same order.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    "XLA's float32 erf_inv polynomial on a float32 tensor."
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=torch.float32, device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=torch.float32, device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_SPAN = float(np.float32(1.0) - np.float32(_NORMAL_LO))  # rounds to 2.0 in f32
_SQRT2 = float(np.float32(np.sqrt(2)))


def normal_batched(keys, n: int, device=None) -> torch.Tensor:
    """`jax.random.normal(keys[s], (n,))` float32 for every key of a (S, 2)
    list or tensor, in one draw: an (S, n) tensor."""
    u = _unit_floats(bits_batched(keys, n, device)) * _NORMAL_SPAN + _NORMAL_LO
    u = torch.clamp_min(u, _NORMAL_LO)
    return erfinv_xla(u) * _SQRT2

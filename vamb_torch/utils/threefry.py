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
  mantissa trick of jax/_src/random.py:435-477 (`uniform_batched`: one
  draw for many keys); `bernoulli(key, p, shape)` compares them with
  float32(p).
* `permutation(key, n)`: jax's `_shuffle`, `ceil(3 ln n / ln(2^32 - 1))`
  rounds of a key split, 32-bit sort keys and a stable key-value sort.
* `normal_batched(keys, n)`: `normal(key, (n,))` per key, a uniform on
  [nextafter(-1, 0), 1), then sqrt(2) times XLA's float32 `ErfInv`
  polynomial (`erfinv_xla`) with XLA's CPU `log1p` inside (`log1p_xla`),
  rounded where XLA's object code rounds: bit for bit
  `jax.random.normal` on the CPU, on the CPU and on the card alike.

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


def _counters(n: int, device, start: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    "The (hi, lo) halves of the 64-bit iota start..start+n-1."
    lo = torch.arange(start, start + n, dtype=torch.int64, device=device)
    return lo >> 32, lo & _MASK


def bits_batched(keys, n: int, device=None, start: int = 0) -> torch.Tensor:
    """`bits(keys[s], (n,))` for every key of a (S, 2) list or tensor, in
    one hash of (S, n) counters: an (S, n) int64 tensor of uint32 words.
    With `start`, words start.. of a longer draw: each word hashes its own
    counter (jax's partitionable threefry), so a slice of a draw is the
    draw of its counters."""
    kt = torch.as_tensor(keys, dtype=torch.int64).reshape(-1, 2).to(device)
    hi, lo = _counters(n, device, start)
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


def uniform_batched(keys, n: int, device=None, start: int = 0) -> torch.Tensor:
    """`jax.random.uniform(keys[s], (n,))` float32 for every key of a (S, 2)
    list or tensor, in one draw: an (S, n) tensor (with `start`, elements
    start.. of a longer draw)."""
    return torch.clamp_min(_unit_floats(bits_batched(keys, n, device, start)), 0.0)


def uniform(k, n: int, device=None, start: int = 0) -> torch.Tensor:
    """jax.random.uniform(key, (n,)) as float32 on `device` (with `start`,
    elements start.. of a longer draw)."""
    return uniform_batched([_words(k)], n, device, start)[0]


def bernoulli(k, p: float, shape, device=None) -> torch.Tensor:
    """jax.random.bernoulli(key, p, shape) (its default mode): a float32
    uniform of the same key below float32(p), as a bool tensor."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    u = uniform(k, math.prod(shape), device).reshape(shape)
    return u < float(np.float32(p))


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


# XLA's float32 `log` and `log1p` on the CPU, transcribed from the code XLA
# emits for them (`XLA_FLAGS=--xla_dump_to=DIR` on a jitted `jnp.log`,
# `jnp.log1p` or `jax.random.normal`, whose fused kernel inlines the same
# code): the operations and constants of `*.ir-with-opt.ll`, in its order.
# That IR has separate multiplies and adds, but the object code
# (`*.obj-file.*.o`, `objdump -d`) fuses every add whose operand is a
# multiply with no other use into one FMA (LLVM's contraction): 11 in `log`,
# 24 in `log1p`, 33 in the normal draw. `_fma` rounds those once, as the
# FMA does; every other step is one torch op, rounded on its own. So the
# same bits come out on the CPU and on the card. XLA's CPU code treats
# denormal inputs as zero; `_flush_denormal` does that explicitly.


def _f32(s: str) -> float:
    return float(np.float32(s))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once, as an FMA instruction rounds it: the
    product is exact in float64, TwoSum gives the float64 sum and its exact
    error, and rounding that sum to odd (its last bit set when the error is
    not 0) makes the final rounding to float32 the correct one."""
    p = a.double() * b
    c = c.double() if torch.is_tensor(c) else c
    s = p + c
    p1 = s - c
    c1 = s - p1
    err = (p - p1) + (c - c1)
    bits = s.view(torch.int64)
    to_odd = (err != 0.0) & ((bits & 1) == 0) & torch.isfinite(s)
    bits = torch.where(to_odd, bits + torch.where((err > 0.0) == (s > 0.0), 1, -1), bits)
    return bits.view(torch.float64).float()


def _sqrt(w: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (what `vsqrtps` and the
    card's `sqrt.rn` give; torch's CPU sqrt can be an ulp off): a float64
    root rounded to float32, then moved to the neighbour whose rounding
    interval holds sqrt(w), judged by exact float64 squares of the interval's
    ends."""
    s = torch.sqrt(w.double()).float()
    up = torch.nextafter(s, torch.full_like(s, float("inf")))
    down = torch.nextafter(s, torch.zeros_like(s))
    sd, wd = s.double(), w.double()
    hi = sd + (up - s).double() * 0.5
    lo = sd - (s - down).double() * 0.5
    ok = (w > 0.0) & torch.isfinite(w)
    s = torch.where(ok & (wd > hi * hi), up, s)
    return torch.where(ok & (wd < lo * lo), down, s)


_FLT_MIN = _f32("1.1754944e-38")
_SQRT_HALF = _f32("0.70710677")
# Cephes' logf polynomial, split by XLA into three interleaved chains
_LOG_P = tuple(map(_f32, ("0.070376836", "-0.1151461", "-0.12420141", "0.14249323",
                          "0.20000714", "-0.24999994", "0.116769984", "-0.16668057",
                          "0.3333333")))
_LOG_Q1 = _f32("-0.00021219444")  # ln 2 split in two: the small part,
_LOG_Q2 = _f32("0.6933594")  # then the large part
# log1p's rational approximation for |x| < sqrt(2) - 1: numerator, denominator
_LOG1P_SMALL = _f32("0.41421357")
_LOG1P_NUM = tuple(map(_f32, ("4.527e-05", "0.49854103", "6.5787325", "29.911919",
                              "60.94967", "57.112965", "20.039553")))
_LOG1P_DEN = tuple(map(_f32, ("15.062909", "83.04757", "221.7624", "309.09872",
                              "216.42789", "60.11866")))
_NAN_BITS = -1  # the NaN XLA writes: all 32 bits set
_INF_BITS = 0x7F800000
_NEG_INF_BITS = -0x800000  # 0xFF800000 as int32


def _flush_denormal(x: torch.Tensor) -> torch.Tensor:
    "Denormals to zero of the same sign, as XLA's CPU code reads them."
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def _log_core(y: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log of a flushed `y`: exponent and mantissa by integer bit
    operations, the mantissa folded into [sqrt(1/2) - 1, sqrt(2) - 1), the
    polynomial, then -inf at 0, inf at inf and NaN below 0 or at NaN."""
    not_pos = ~(y > 0.0)  # fcmp ule y, 0: <= 0 or NaN
    ne0 = y != 0.0
    ne_inf = y != float("inf")
    bits = torch.where(y > _FLT_MIN, y, _FLT_MIN).view(torch.int32)
    e = bits >> 23
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    ef = (e - 127).to(torch.float32) + 1.0
    lt = m < _SQRT_HALF
    t = torch.where(lt, m, 0.0)
    xm = m + -1.0
    e2 = ef - torch.where(lt, 1.0, 0.0)
    x = xm + t
    z = x * x
    x3 = z * x
    p = _LOG_P
    a = _fma(x, p[0], p[1])
    b = _fma(x, p[2], p[3])
    c = _fma(x, p[4], p[5])
    a = _fma(a, x, p[6])
    b = _fma(b, x, p[7])
    c = _fma(c, x, p[8])
    r = _fma(a, x3, b)
    r = _fma(r, x3, c)
    s2 = _fma(r, x3, e2 * _LOG_Q1)
    u = x - z * 0.5  # an FMA too, but z * 0.5 is exact
    res = (u + s2) + e2 * _LOG_Q2  # likewise: e2 * _LOG_Q2 is exact
    out = torch.where(not_pos, _NAN_BITS, res.view(torch.int32))
    out = torch.where(ne_inf, out, _INF_BITS)
    return torch.where(ne0, out, _NEG_INF_BITS).to(torch.int32).view(torch.float32)


def log_xla(x: torch.Tensor) -> torch.Tensor:
    "XLA's float32 `log` on the CPU (`jnp.log`), bit for bit."
    return _log_core(_flush_denormal(x))


def log1p_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 `log1p` on the CPU (`jnp.log1p`), bit for bit: the log
    of 1 + x, or for |x| < sqrt(2) - 1 the rational approximation
    x - x^2/2 + x^3 P(x)/Q(x)."""
    x = _flush_denormal(x)
    big = _log_core(x + 1.0)
    x2 = x * x
    zero = x * 0.0
    den = zero + 1.0
    for k in _LOG1P_DEN:
        den = _fma(den, x, k)
    num = zero + _LOG1P_NUM[0]
    for k in _LOG1P_NUM[1:]:
        num = _fma(num, x, k)
    ratio = num / den
    small = x + _fma(x2, -0.5, (x * x2) * ratio)
    return torch.where(x.abs() < _LOG1P_SMALL, small, big)


# XLA's float32 ErfInv (Giles' single-precision approximation), the
# constants of xla/client/lib/math.cc ErfInv32 and of CHLO's erf_inv
# lowering, evaluated in the same order.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    "XLA's float32 erf_inv polynomial on a float32 tensor, `log1p_xla` inside."
    w = -log1p_xla(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], dtype=torch.float32, device=x.device),
                           torch.tensor(_ERFINV_GE5[i], dtype=torch.float32, device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma(p, w, coef(i))  # fused in XLA's object code like the log's
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

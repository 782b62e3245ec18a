"""JAX's threefry-2x32 random stream in plain numpy, for the references.

The draws follow JAX's public definitions in its default configuration
(32-bit mode, `jax_threefry_partitionable=True`): a key is the pair
(0, seed mod 2^32); `split(key, num)` hashes the 64-bit counters 0..num-1;
`bits(key, n)` xors the two words of the hash of counters 0..n-1;
`permutation(key, n)` runs ceil(3 ln n / ln(2^32 - 1)) rounds of a key
split, 32-bit sort keys and a stable sort; `normal` maps bits to a uniform
on [nextafter(-1, 0), 1) and takes sqrt(2) erfinv of it, here in float64.
"""

import math

import numpy as np

_MASK = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _MASK


def hash2x32(k1: int, k2: int, x1, x2):
    "Threefry-2x32, 20 rounds, of counter words x1, x2 (uint64 arrays) under key (k1, k2)."
    ks = [np.uint64(k1), np.uint64(k2), np.uint64(k1 ^ k2 ^ 0x1BD11BDA)]
    a = (np.asarray(x1, np.uint64) + ks[0]) & _MASK
    b = (np.asarray(x2, np.uint64) + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + np.uint64(i + 1)) & _MASK
    return a, b


def key(seed: int) -> tuple[int, int]:
    return (0, int(seed) & 0xFFFFFFFF)


def split(k, num: int = 2) -> list[tuple[int, int]]:
    i = np.arange(num, dtype=np.uint64)
    a, b = hash2x32(k[0], k[1], i >> np.uint64(32), i & _MASK)
    return [(int(x), int(y)) for x, y in zip(a, b)]


def bits(k, n: int) -> np.ndarray:
    "n uint32 words, as uint64."
    i = np.arange(n, dtype=np.uint64)
    a, b = hash2x32(k[0], k[1], i >> np.uint64(32), i & _MASK)
    return a ^ b


def permutation(k, n: int) -> np.ndarray:
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(2**32 - 1))
    x = np.arange(n)
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(bits(sub, n), kind="stable")]
    return x


def bytes_of(words: np.ndarray) -> np.ndarray:
    "uint32 words (last axis W) as their little-endian bytes (last axis 4W)."
    w = np.asarray(words, np.uint64)
    parts = [((w >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(np.uint8) for j in range(4)]
    return np.stack(parts, axis=-1).reshape(*w.shape[:-1], 4 * w.shape[-1])


def normal(k, n: int) -> np.ndarray:
    "n standard normals, float64 (JAX's float32 draw to its rounding)."
    import torch

    unit = ((bits(k, n) >> np.uint64(9)).astype(np.float64)) / float(1 << 23)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = np.maximum(unit * 2.0 + lo, lo)
    return math.sqrt(2.0) * torch.special.erfinv(torch.from_numpy(u)).numpy()

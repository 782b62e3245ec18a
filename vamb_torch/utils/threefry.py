"""JAX's threefry-2x32 random stream, written in torch.

The clustering engine draws one uniform per padded column on every wander
step and splits its key once per attempt (vamb_tpu/cluster.py:1262,
:773-777). Reproducing those draws bit for bit lets the port cluster a
latent exactly as `vamb_tpu` does on the CPU, so this module re-implements
the three calls the engine makes, for the jax configuration the package is
held against (jax 0.9, `jax_threefry_partitionable=True`, 32-bit mode):

* `PRNGKey(seed)`: in 32-bit mode jax keeps the low 32 bits of the seed,
  so the key is `(0, seed & 0xFFFFFFFF)` (jax/_src/prng.py:817-829 after the
  int64 -> int32 canonicalisation of `random_seed`).
* `split(key)`: the fold-like split, threefry of the 64-bit counters 0 and
  1 (prng.py:1156-1160).
* `uniform(key, n)`: float32 uniforms in [0, 1) from `bits1 ^ bits2` of the
  counters 0..n-1, with the mantissa trick of jax/_src/random.py:435-477.

Keys are (2,) int64 tensors holding uint32 values. All arithmetic is int64
with explicit 32-bit masks, so the same code runs on the CPU and the card.
"""

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x1, x2):
    """The Threefry-2x32 hash of counter pairs (x1, x2) under key (k1, k2),
    20 rounds, as jax's `_threefry2x32_lowering` computes it. The counters
    are int64 tensors or Python ints holding uint32 values."""
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


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    "The (hi, lo) halves of the 64-bit iota 0..n-1."
    lo = torch.arange(n, dtype=torch.int64, device=device)
    return lo >> 32, lo & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): a (num, 2) int64 tensor of keys.

    The few counters are hashed as Python ints (the same masked arithmetic
    as on tensors): a key split is a handful of scalars, and tensor ops on
    them would cost a dispatch each."""
    k1, k2 = int(key[0]), int(key[1])
    keys = [threefry2x32(k1, k2, i >> 32, i & _MASK) for i in range(num)]
    return torch.tensor(keys, dtype=torch.int64)


def uniform(key: torch.Tensor, n: int, device=None) -> torch.Tensor:
    "jax.random.uniform(key, (n,)) as float32 on `device`."
    hi, lo = _counters(n, device)
    b1, b2 = threefry2x32(int(key[0]), int(key[1]), hi, lo)
    bits = (b1 ^ b2) >> 9 | 0x3F800000  # 23 random mantissa bits, exponent of 1.0
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)

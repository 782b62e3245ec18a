"""Neural-net building blocks as `nn.Module`s, with `vamb_tpu`'s semantics.

Semantics kept from `vamb_tpu/models/layers.py` (torch defaults used by
the reference):

* Linear: the weight is stored (nin, nout), the JAX layout, so parameter
  names and shapes are those of `model.npz`; initialised on the host with
  numpy (Kaiming-uniform a=sqrt(5) = U(+-1/sqrt(fan_in)), bias likewise),
  drawing in the same order as `vamb_tpu` so a seed gives the same weights.
* BatchNorm1d: eps 1e-5, momentum 0.1; training normalizes with the biased
  batch variance (mean of squares minus squared mean) and stores the
  unbiased variance into the running estimate; eval uses running stats.
* LeakyReLU: negative slope 0.01.
* Dropout from caller-supplied bytes: a byte survives iff it is >= a
  quantized threshold t = round(rate * 256), survivors scaled by
  1 / (1 - t/256) (layers.py:123-145). Every model draws its bytes once an
  epoch as one bank (`dropout_bank`) and rotates it by `i * 97` at step i
  (`step_bank`), as `vamb_tpu`'s VAE, Taxometer and VAEVAE do.
* Reduced precision (the VAE's bf16 training, layers.py:44-111): Linear
  casts x, w and b to a compute dtype and keeps the product and sum in it;
  BatchNorm takes its statistics and affine in float32 and casts back to
  its input's type; LeakyReLU and dropout multiply a bf16 tensor by their
  constant rounded to bf16, as jax does with a Python float beside a bf16
  array. At float32 (no compute dtype) each is the float32 operation
  unchanged.
* Data parallelism (layers.py:76-111 under `vamb_tpu`'s GSPMD, which runs
  the VAE's program over the global batch): inside `global_batch(mesh)`
  each rank holds its rows of one batch, and BatchNorm's training
  statistics are the global batch's: each rank's sums of x and x*x (and
  its row count) are added in rank order (`RankSum`, whose backward adds
  the ranks' cotangents the same way) and divided by the global row count,
  which also gives the running variance its unbiased factor. The losses'
  means over rows (`batch_mean`) become the sum over the rank's rows over
  the global batch's row count, so the ranks' losses add up to the
  global batch's loss.
"""

from contextlib import contextmanager

import numpy as np
import torch
from torch import nn

from ..utils import threefry

# the mesh whose ranks' rows form one batch, and that batch's row count,
# inside `global_batch`
_global_batch = None
_global_rows = None


@contextmanager
def global_batch(mesh, rows=None):
    """Within the block, a training-mode BatchNorm takes its statistics over
    the rows of every rank of `mesh` (None: this process's rows alone), and
    given the global batch's row count `rows`, `batch_mean` is a rank's
    share of the global batch's mean."""
    global _global_batch, _global_rows
    prev = _global_batch, _global_rows
    _global_batch, _global_rows = mesh, (None if mesh is None else rows)
    try:
        yield
    finally:
        _global_batch, _global_rows = prev


def batch_rows():
    "The global batch's row count inside `global_batch(mesh, rows)`, else None."
    return _global_rows


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of `x`, whose rows are a batch's, over all its elements:
    `torch.mean(x)` itself outside `global_batch(mesh, rows)`; inside, the
    sum of this rank's elements over the global batch's element count (rows
    times the elements a row), so the ranks' values add up to the global
    batch's mean."""
    if _global_rows is None:
        return torch.mean(x)
    per_row = int(np.prod(x.shape[1:], dtype=np.int64))
    return torch.sum(x) / (_global_rows * per_row)


class RankSum(torch.autograd.Function):
    """The rank-order sum of every rank's tensor (`Mesh.sum_ranks`). The
    backward gives each rank the rank-order sum of every rank's cotangent:
    each rank's loss reads the total, so the total loss's gradient with
    respect to one rank's summand is the sum of them all."""

    @staticmethod
    def forward(ctx, t, mesh, kind):
        ctx.mesh, ctx.kind = mesh, kind
        return mesh.sum_ranks(t, kind)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.sum_ranks(grad.contiguous(), ctx.kind + " cotangents"), None, None


class Linear(nn.Module):
    "Affine layer `x @ w + b` with the (nin, nout) weight layout."

    def __init__(self, rng: np.random.Generator, nin: int, nout: int):
        super().__init__()
        bound = 1.0 / np.sqrt(nin)
        w = rng.uniform(-bound, bound, (nin, nout)).astype(np.float32)
        b = rng.uniform(-bound, bound, (nout,)).astype(np.float32)
        self.w = nn.Parameter(torch.from_numpy(w))
        self.b = nn.Parameter(torch.from_numpy(b))

    def forward(self, x: torch.Tensor, dtype=None) -> torch.Tensor:
        """`x @ w + b`; with a compute `dtype` (bf16), x, w and b are cast
        to it and the product and the sum stay in it, while the parameters
        stay float32 (their gradients come back through the casts)."""
        if dtype is not None:
            return x.to(dtype) @ self.w.to(dtype) + self.b.to(dtype)
        return x @ self.w + self.b


class Block(nn.Module):
    """A hidden layer's Dense and BatchNorm; the model applies them in its
    order: Dense -> LeakyReLU -> Dropout -> BatchNorm in the VAE family,
    Dense -> BatchNorm -> LeakyReLU in the AAE."""

    def __init__(self, rng: np.random.Generator, nin: int, nout: int):
        super().__init__()
        self.dense = Linear(rng, nin, nout)
        self.bn = BatchNorm(nout)


class BatchNorm(nn.Module):
    """Batch normalization over dim 0 with learnable `scale`/`bias` and
    running `mean`/`var` buffers (the names of `vamb_tpu`'s trees)."""

    def __init__(self, n: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("mean", torch.zeros(n))
        self.register_buffer("var", torch.ones(n))

    def forward(self, x: torch.Tensor, base=None) -> torch.Tensor:
        """Normalize `x`. In training mode the running statistics become
        `(1 - momentum) * old + momentum * batch`, where `old` is the
        buffers or, when given, the (mean, var) pair `base`: a model that
        runs one layer several times a step and keeps the last call's
        statistics (VAEVAE) passes the step's starting buffers. In training
        mode a reduced-precision `x` is normalized in float32 and the output
        cast back to its type."""
        if not self.training:
            return (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias
        in_dtype = x.dtype
        x = x.float()
        old_mean, old_var = (self.mean, self.var) if base is None else base
        if _global_batch is None:
            mean = x.mean(dim=0)
            mean2 = (x * x).mean(dim=0)
            n = x.shape[0]
        else:  # the global batch's sums, its row count riding along
            local = torch.cat([x.sum(0), (x * x).sum(0), x.new_full((1,), x.shape[0])])
            total = RankSum.apply(local, _global_batch, "batchnorm sums")
            f = x.shape[1]
            n = total[2 * f].detach()  # a device scalar: no host sync
            mean, mean2 = total[:f] / n, total[f: 2 * f] / n
        var = mean2 - mean * mean  # biased, used for normalization
        out = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        with torch.no_grad():
            unbiased = var * (n / (n - 1).clamp_min(1) if torch.is_tensor(n) else n / max(n - 1, 1))
            self.mean.copy_((1 - self.momentum) * old_mean + self.momentum * mean)
            self.var.copy_((1 - self.momentum) * old_var + self.momentum * unbiased)
        return out.to(in_dtype)


def _in_type_of(c: float, x: torch.Tensor) -> float:
    """The constant `c` as jax applies it to `x`: rounded to bf16 where x
    is bf16 (a weak-typed Python scalar takes the array's type)."""
    return float(torch.tensor(c, dtype=x.dtype)) if x.dtype == torch.bfloat16 else c


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, _in_type_of(negative_slope, x) * x)


def dropout_threshold(rate: float) -> tuple[int, float]:
    "Quantized byte threshold and keep-scale of the byte-mask dropout."
    t = min(255, int(round(rate * 256.0)))
    return t, 1.0 / (1.0 - t / 256.0)


def dropout_from_bits(bits: torch.Tensor, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Byte-mask dropout with caller-supplied uint8 `bits` (one byte per
    element of x); rate 0 is the identity."""
    if rate == 0.0:
        return x
    t, keep_scale = dropout_threshold(rate)
    return torch.where(bits >= t, x * _in_type_of(keep_scale, x), 0.0)


def dropout_bank(key, batchsize: int, widths: list[int], device):
    """One epoch's dropout bytes for hidden layers of `widths`, in a single
    draw: `bits(key, (B, ceil(sum(widths) / 4)))` read as little-endian
    bytes, sliced in order (vamb_tpu vae.py:356-384, taxometer.py:168-183,
    vaevae.py:313-332). Returns (bytes (B, sum(widths)), widths)."""
    nwords = (sum(widths) + 3) // 4
    words = threefry.bits(key, (batchsize, nwords), device)
    return threefry.words_to_bytes(words)[:, : sum(widths)], list(widths)


def step_bank(bank, i: int):
    """Step i's dropout bytes, one (B, width) slice a layer: the epoch's
    bank rotated by `i * 97` (a uint8 add wraps), so every step gets
    distinct masks from one draw an epoch. None without a bank."""
    if bank is None:
        return None
    return torch.split(bank[0] + (i * 97) % 256, bank[1], dim=1)

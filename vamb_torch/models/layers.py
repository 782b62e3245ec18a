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
  1 / (1 - t/256) (layers.py:123-145).
"""

import numpy as np
import torch
from torch import nn


class Linear(nn.Module):
    "Affine layer `x @ w + b` with the (nin, nout) weight layout."

    def __init__(self, rng: np.random.Generator, nin: int, nout: int):
        super().__init__()
        bound = 1.0 / np.sqrt(nin)
        w = rng.uniform(-bound, bound, (nin, nout)).astype(np.float32)
        b = rng.uniform(-bound, bound, (nout,)).astype(np.float32)
        self.w = nn.Parameter(torch.from_numpy(w))
        self.b = nn.Parameter(torch.from_numpy(b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return (x - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias
        mean = x.mean(dim=0)
        mean2 = (x * x).mean(dim=0)
        var = mean2 - mean * mean  # biased, used for normalization
        out = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        n = x.shape[0]
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            self.mean.copy_((1 - self.momentum) * self.mean + self.momentum * mean)
            self.var.copy_((1 - self.momentum) * self.var + self.momentum * unbiased)
        return out


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return torch.where(x >= 0, x, negative_slope * x)


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
    return torch.where(bits >= t, x * keep_scale, 0.0)

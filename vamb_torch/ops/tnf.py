"""TNF projection: on the host (numpy/BLAS), or on a torch device.

Reference semantics (vamb/parsecontigs.py:140-158): normalize each 256-dim
4-mer count row to frequencies (zero-sum rows are kept at zero), subtract
1/256, then project with the (256, 103) kernel — all in float32.

`project_fourmers_numpy` is a copy of `vamb_tpu/ops/tnf.py`'s host path,
which both packages run by default, so `composition.npz` is bit-identical
between them. `project_fourmers_device` is the counterpart of
`vamb_tpu`'s device projection (`_project_jit`, vamb_tpu/ops/tnf.py:23-28):
row sums, zero sums set to 1, `counts / s - 1/256`, then one float32
product with the kernel (TF32 is off on the card, `device.resolve_device`).
Its products sum in another order than BLAS's, so the two paths differ by
float32 roundoff, which the 12-bit mantissa mask hides for all but the
values whose two roundings straddle a mask step.
"""

import numpy as np
import torch

from .kernel import load_tnf_kernel


def project_fourmers_numpy(fourmers: np.ndarray, kernel: np.ndarray = None) -> np.ndarray:
    "Project (N, 256) float32 4-mer counts to (N, 103) TNF features; mutates its input."
    if kernel is None:
        kernel = load_tnf_kernel()
    s = fourmers.sum(axis=1).reshape(-1, 1)
    s[s == 0] = 1.0
    fourmers *= 1 / s
    fourmers += -(1 / 256)
    return np.dot(fourmers, kernel)


def project_fourmers_device(fourmers: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Project (N, 256) float32 4-mer counts to (N, 103) TNF features on
    their device, `kernel` (256, 103) float32 on the same device. Returns the
    device tensor: the caller gathers the chunks and copies them back once."""
    s = fourmers.sum(dim=1, keepdim=True)
    s = torch.where(s == 0, 1.0, s)
    return (fourmers / s - (1.0 / 256.0)) @ kernel

"""TNF projection on the host (numpy/BLAS).

Reference semantics (vamb/parsecontigs.py:140-158): normalize each 256-dim
4-mer count row to frequencies (zero-sum rows are kept at zero), subtract
1/256, then project with the (256, 103) kernel — all in float32. Copy of
`vamb_tpu/ops/tnf.py:project_fourmers_numpy`, which `vamb_tpu` also runs by
default, so `composition.npz` is bit-identical between the two packages.
"""

import numpy as np

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

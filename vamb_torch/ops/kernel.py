"""The 256->103 TNF projection kernel.

Tetranucleotide frequencies live in a 103-dim affine subspace of R^256
(Kislyuk et al., PMC2765972): frequencies sum to one, a k-mer and its
reverse complement are indistinguishable, and k-mer overlap flow is
conserved. TNF is projected as `counts/sum - 1/256 @ K`, with K an
orthonormal basis of that subspace composed with reverse-complement
averaging.

Any two bases differ by a rotation of the 103-dim space, so only one set of
constants gives `vamb_tpu`'s (and the published tool's) output bit for bit.
`tnf_kernel.npz` is a copy of `vamb_tpu/ops/tnf_kernel.npz`, the published
projection constants; `vamb_tpu/ops/kernel.py` keeps the code that derives
a basis from first principles.
"""

import os
from functools import lru_cache

import numpy as np

_KERNEL_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tnf_kernel.npz")


@lru_cache(maxsize=1)
def load_tnf_kernel() -> np.ndarray:
    "Load the (256, 103) float32 projection kernel data asset."
    kernel = np.load(_KERNEL_PATH)["arr_0"]
    assert kernel.shape == (256, 103) and kernel.dtype == np.float32
    return kernel

"""The 256->103 TNF projection kernel.

Tetranucleotide frequencies live in a 103-dim affine subspace of R^256
(Kislyuk et al., PMC2765972; reference src/create_kernel.py:1-103) because
of three families of linear constraints:

1. frequencies sum to one (handled by shifting down by 1/256),
2. a k-mer and its reverse complement are indistinguishable (120 constraints),
3. k-mer overlap flow: sum(ABCx) = sum(xABC) for each trimer (64 constraints,
   one dependent).

An orthonormal basis L of the null space of the constraint matrix, composed
with the reverse-complement averaging matrix R, gives the projection
K = R @ L used as `counts/sum - 1/256 @ K`.

`create_dual_kernel()` regenerates such a basis from first principles (a
copy of `vamb_tpu/ops/kernel.py`'s, on the host with numpy and scipy). Any
two bases differ by a rotation of the 103-dim space, so only one set of
constants gives `vamb_tpu`'s (and the published tool's) output bit for bit.
`tnf_kernel.npz` is a copy of `vamb_tpu/ops/tnf_kernel.npz`, the published
projection constants; `load_tnf_kernel()` returns it, and the pipeline
uses nothing else.
"""

import itertools
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


def _reverse_complement(kmer: str) -> str:
    return kmer[::-1].translate(str.maketrans("ACGT", "TGCA"))


def _all_kmers(k: int):
    for tup in itertools.product("ACGT", repeat=k):
        yield "".join(tup)


def create_projection_kernel() -> np.ndarray:
    "Orthonormal basis of the TNF constraint null space, shape (256, 103)."
    from scipy.linalg import null_space

    indexof = {kmer: i for i, kmer in enumerate(_all_kmers(4))}
    equations: list[list[int]] = []

    # frequencies (shifted) sum to zero
    equations.append([1] * 256)

    # reverse-complement symmetry (canonical k-mers only; rest are redundant)
    for kmer in _all_kmers(4):
        revcomp = _reverse_complement(kmer)
        if kmer >= revcomp:
            continue
        line = [0] * 256
        line[indexof[kmer]] = 1
        line[indexof[revcomp]] = -1
        equations.append(line)

    # overlap flow: each trimer is entered as often as it is left
    for trimer in _all_kmers(3):
        line = [0] * 256
        for suffix in "ACGT":
            line[indexof[trimer + suffix]] += 1
        for prefix in "ACGT":
            line[indexof[prefix + trimer]] -= 1
        equations.append(line)

    kernel = null_space(np.array(equations)).astype(np.float32)
    assert kernel.shape == (256, 103)
    return kernel


def create_rc_kernel() -> np.ndarray:
    "Reverse-complement averaging matrix, shape (256, 256)."
    indexof = {kmer: i for i, kmer in enumerate(_all_kmers(4))}
    rc_matrix = np.zeros((256, 256), dtype=np.float32)
    for col, kmer in enumerate(_all_kmers(4)):
        revcomp = _reverse_complement(kmer)
        rc_matrix[indexof[kmer], col] += 0.5
        rc_matrix[indexof[revcomp], col] += 0.5
    return rc_matrix


def create_dual_kernel() -> np.ndarray:
    "Regenerate a (rotation-equivalent) projection kernel from the method."
    return np.dot(create_rc_kernel(), create_projection_kernel())

"""Array helpers: growable buffers, normalization, reproducibility masking.

Behavioral parity: reference vamb/vambtools.py:191-330 (PushArray, zscore,
mask_lower_bits, validate_input_array). Implementations are original; the
contracts (growth policy, zero-std guard, 12-bit mantissa truncation) match
so that serialized artifacts hash identically across platforms.
"""

from typing import Optional

import numpy as np


class PushArray:
    """Append-only 1-D numpy buffer with amortized-O(1) growth.

    Fills the same role as the reference's growable array
    (vambtools.py:191-247) for streaming feature extraction: values are
    pushed one at a time or in slices, and `take()` hands back a
    shrink-to-fit array. Capacity doubles whenever it runs out, so the
    total copy work stays linear in the number of pushed elements.
    """

    __slots__ = ["data", "length"]

    def __init__(self, dtype, start_capacity: int = 1 << 16):
        self.data: np.ndarray = np.empty(max(start_capacity, 1), dtype=dtype)
        self.length = 0

    def __len__(self) -> int:
        return self.length

    def _reserve(self, extra: int) -> None:
        needed = self.length + extra
        if needed <= len(self.data):
            return
        new_capacity = max(len(self.data), 64)
        while new_capacity < needed:
            new_capacity *= 2
        self.data.resize(new_capacity, refcheck=False)

    def append(self, value) -> None:
        self._reserve(1)
        self.data[self.length] = value
        self.length += 1

    def extend(self, values) -> None:
        n = len(values)
        self._reserve(n)
        self.data[self.length : self.length + n] = values
        self.length += n

    def take(self) -> np.ndarray:
        "Shrink to fit and return the underlying array."
        self.data.resize(self.length, refcheck=False)
        return self.data

    def clear(self) -> None:
        "Reset length to zero without freeing memory."
        self.length = 0


def zscore(
    array: np.ndarray, axis: Optional[int] = None, inplace: bool = False
) -> np.ndarray:
    """Z-score normalize `array`, optionally along `axis`, optionally in place.

    The exact arithmetic (population std, subtract-then-divide in place) is
    part of the dataset-normalization parity contract with the reference
    (vambtools.py:250-288) and is pinned by tests/test_parity_dataset.py.
    Slices with zero spread are centered but left unscaled.
    """
    if axis is not None and (axis >= array.ndim or axis < 0):
        raise np.exceptions.AxisError(str(axis))
    if inplace and not np.issubdtype(array.dtype, np.floating):
        raise TypeError("Cannot convert a non-float array to zscores")

    mean = array.mean(axis=axis)
    std = array.std(axis=axis)
    if axis is None:
        std = std if std != 0 else 1
    else:
        std[std == 0.0] = 1
        # reshape the reductions for broadcasting against the original
        keepdims = tuple(
            1 if ax == axis else dim for ax, dim in enumerate(array.shape)
        )
        mean = mean.reshape(keepdims)
        std = std.reshape(keepdims)

    if not inplace:
        return (array - mean) / std
    array -= mean
    array /= std
    return array


def mask_lower_bits(floats: np.ndarray, bits: int) -> None:
    """Zero the lowest `bits` mantissa bits of a float32 array, in place.

    Used at every serialization boundary (TNF, abundance, latent) so outputs
    are bit-stable across platforms and backends (reference
    vambtools.py:324-330; see also test_results.py's hash-based tests).
    """
    if bits < 0 or bits > 23:
        raise ValueError("Must mask between 0 and 23 bits")
    if floats.dtype != np.float32:
        raise ValueError("Can only mask bits of a float32 array")
    mask = ~np.uint32(2**bits - 1)
    u = floats.view(np.uint32)
    u &= mask


def validate_input_array(array: np.ndarray) -> np.ndarray:
    "Return an array equal to input but C-contiguous and owning its data."
    if not array.flags["C_CONTIGUOUS"]:
        array = np.ascontiguousarray(array)
    if not array.flags["OWNDATA"]:
        array = array.copy()
    assert array.flags["C_CONTIGUOUS"] and array.flags["OWNDATA"]
    return array


def numpy_inplace_maskarray(array: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Compact rows of `array` where `mask` is True, in place; return view.

    The reference offloads this to a native `overwrite_matrix`
    (vambtools.py:291-304); under XLA row-compaction is irrelevant (we mask
    instead), so a vectorized numpy implementation suffices host-side.
    """
    if len(mask) != len(array):
        raise ValueError("Lengths of array and mask must match")
    if array.ndim != 2:
        raise ValueError("Can only take a 2 dimensional-array.")
    kept = int(mask.sum())
    array[:kept] = array[mask]
    array.resize((kept, array.shape[1]), refcheck=False)
    return array

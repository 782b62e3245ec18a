"""4-mer counting: the one mandatory native op on the default path.

Semantics (parity with the reference's native `vambcore.kmercounts`, used at
vamb/vambtools.py:444-447 and cross-checked by test_vambtools.py:137-151):
a 4-base window contributes one count iff all four bases are in {A,C,G,T}
(case-insensitive); any other byte (incl. U and IUPAC ambiguity codes)
invalidates every window containing it. The k-mer index uses 2-bit codes
A=0, C=1, G=2, T=3 with the first base most significant, i.e. the position
of the k-mer in `itertools.product("ACGT", repeat=4)` order.

Two implementations:
* `_kmercounts_numpy` — vectorized LUT + bincount; the default fallback.
* a C++ shared library (`native/libvambops.so`, built by `native/build.sh`)
  loaded via ctypes when present; scalar rolling-window loop, ~10x faster on
  long contigs and far less allocation-happy.
"""

import ctypes
import os

import numpy as np

# 256-entry lookup: byte -> 2-bit code, or -1 for invalid
_LUT = np.full(256, -1, dtype=np.int8)
for _i, _base in enumerate(b"ACGT"):
    _LUT[_base] = _i
for _i, _base in enumerate(b"acgt"):
    _LUT[_base] = _i

_NATIVE = None


def _load_native():
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native",
        "libvambops.so",
    )
    if not os.path.exists(path):
        from ..native.autobuild import ensure_built

        ensure_built()
    if not os.path.exists(path):
        _NATIVE = False
        return False
    try:
        lib = ctypes.CDLL(path)
        lib.kmercounts4.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.kmercounts4.restype = None
        lib.kmercounts4_batch.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.kmercounts4_batch.restype = None
        _NATIVE = lib
        return lib
    except OSError:
        _NATIVE = False
        return False


def _kmercounts_numpy(sequence: bytes) -> np.ndarray:
    counts = np.zeros(256, dtype=np.uint32)
    n = len(sequence)
    if n < 4:
        return counts
    codes = _LUT[np.frombuffer(sequence, dtype=np.uint8)].astype(np.int32)
    valid = codes >= 0
    kidx = codes[:-3] * 64 + codes[1:-2] * 16 + codes[2:-1] * 4 + codes[3:]
    validwin = valid[:-3] & valid[1:-2] & valid[2:-1] & valid[3:]
    if validwin.any():
        counts += np.bincount(kidx[validwin], minlength=256).astype(np.uint32)
    return counts


def kmercounts(sequence: bytes) -> np.ndarray:
    "Count 4-mers of a DNA byte string into a 256-slot uint32 vector."
    lib = _load_native()
    if lib:
        counts = np.zeros(256, dtype=np.uint32)
        lib.kmercounts4(
            sequence,
            len(sequence),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return counts
    return _kmercounts_numpy(sequence)


def kmercounts_batch(seqs: list) -> np.ndarray:
    """Count 4-mers of many sequences in ONE native call: (len(seqs), 256)
    uint32. Identical per-row results to `kmercounts`; the batch entry
    point exists because per-contig ctypes call overhead dominated the
    count time for short contigs (the streaming extractor counts ~1000
    contigs per flush)."""
    n = len(seqs)
    out = np.zeros((n, 256), dtype=np.uint32)
    if n == 0:
        return out
    lib = _load_native()
    if not lib:
        for i, s in enumerate(seqs):
            out[i] = _kmercounts_numpy(s)
        return out
    blob = b"".join(seqs)
    offsets = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    lib.kmercounts4_batch(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out

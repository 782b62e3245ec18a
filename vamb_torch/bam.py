"""Python bindings for the native BAM coverage reader (native/bamcov.cpp).

Host-side copy of `vamb_tpu/bam.py` (the reference's pycoverm role,
vamb/parsebam.py:195-237): multi-threaded BAM -> per-contig trimmed-mean
depth matrix with a min-identity read filter. Files are processed in a
thread pool (ctypes releases the GIL during the native call), as pycoverm
does with at most 16 files at once. The library is built from the
checkout's source at first use; a failed build raises with the compiler's
message.
"""

import ctypes
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

from .native.autobuild import build_bamcov

_LIB = None
_LIB_LOCK = threading.Lock()
CONTIG_END_EXCLUSION = 75  # CoverM default, used by pycoverm


def _load_native():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build_bamcov())
        vp, sz = ctypes.c_void_p, ctypes.c_size_t
        lib.bamcov_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, sz]
        lib.bamcov_open.restype = vp
        lib.bamcov_n_refs.argtypes = [vp]
        lib.bamcov_n_refs.restype = ctypes.c_uint64
        lib.bamcov_ref_name.argtypes = [vp, ctypes.c_uint64]
        lib.bamcov_ref_name.restype = ctypes.c_char_p
        lib.bamcov_ref_len.argtypes = [vp, ctypes.c_uint64]
        lib.bamcov_ref_len.restype = ctypes.c_uint32
        lib.bamcov_coverage.argtypes = [
            vp, ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_char_p, sz,
        ]
        lib.bamcov_coverage.restype = ctypes.c_int
        lib.bamcov_close.argtypes = [vp]
        lib.bamcov_close.restype = None
        _LIB = lib
        return lib


def _open(lib, path: str, errbuf):
    handle = lib.bamcov_open(path.encode(), errbuf, len(errbuf))
    if not handle:
        raise ValueError(f"Error opening BAM file {path}: {errbuf.value.decode()}")
    return handle


def _names(lib, handle) -> list[str]:
    return [lib.bamcov_ref_name(handle, i).decode() for i in range(lib.bamcov_n_refs(handle))]


def _coverage_one(
    path: str, minid: float, trim_lower: float, trim_upper: float
) -> tuple[list[str], np.ndarray]:
    lib = _load_native()
    errbuf = ctypes.create_string_buffer(512)
    handle = _open(lib, path, errbuf)
    try:
        names = _names(lib, handle)
        out = np.zeros(len(names), dtype=np.float32)
        rc = lib.bamcov_coverage(
            handle, minid, trim_lower, trim_upper, CONTIG_END_EXCLUSION,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), errbuf, len(errbuf),
        )
        if rc != 0:
            raise ValueError(f"Error reading BAM file {path}: {errbuf.value.decode()}")
        return names, out
    finally:
        lib.bamcov_close(handle)


def bam_ref_names(path: str) -> list[str]:
    "Reference names from a BAM header."
    lib = _load_native()
    handle = _open(lib, path, ctypes.create_string_buffer(512))
    try:
        return _names(lib, handle)
    finally:
        lib.bamcov_close(handle)


def coverage_from_bams(
    paths: Sequence[str],
    minid: float = 0.0,
    nthreads: int = 1,
    trim_lower: float = 0.1,
    trim_upper: float = 0.1,
) -> tuple[list[str], np.ndarray]:
    """Compute the (n_refs, n_files) trimmed-mean coverage matrix.

    All BAMs must share an identical reference header (same names, same
    order), as they do when mapped against one catalogue.
    """
    if len(paths) == 0:
        raise ValueError("No BAM files given")
    with ThreadPoolExecutor(max_workers=max(1, min(nthreads, 16))) as pool:
        results = list(
            pool.map(lambda p: _coverage_one(p, minid, trim_lower, trim_upper), paths)
        )
    headers = results[0][0]
    for path, (names, _) in zip(paths, results):
        if names != headers:
            raise ValueError(
                f"BAM file {path} has different reference sequences than "
                f"{paths[0]}; all BAMs must be mapped to the same contig "
                "catalogue"
            )
    return headers, np.stack([cov for (_, cov) in results], axis=1)

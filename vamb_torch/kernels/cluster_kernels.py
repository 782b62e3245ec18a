"""The clustering engine's wander-step kernels: wrappers, plain versions,
launch counters and the on-demand build.

Two CUDA C++ kernels for sm_90a live in `csrc/cluster_kernels.cu` (whose
header notes say which TPU kernel each replaces, what bounds it on the
H100 and what its design does about it):

* `row_sweep(matrixT, idx)` replaces `vamb_tpu/ops/pallas_cluster.py`
  `row_sweep`: the distance row `0.5 - M^T M[:, idx]` of one medoid with
  `d[idx] = 0.0` exactly;
* `candidate_density_sweep(matrixT, cand, wts)` replaces
  `candidate_density_sweep` there: the local densities of C <= 32 wander
  candidates in one matrix pass, no (C, N) matrix in device memory.

Each wrapper launches its kernel for a CUDA tensor and uses the plain
PyTorch version beside it only for a CPU tensor. The source is compiled by
`nvcc` at first use into `kernels/_build/` and bound with ctypes; nothing
is compiled or imported from CUDA while this module is imported.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_MEDOID_RADIUS = 0.05
_MAX_CAND = 32  # kMaxCand in the CUDA source
_DENS_THREADS = 256  # kDensThreads in the CUDA source
_DENS_MAX_BLOCKS = 1024

_SOURCE = Path(__file__).resolve().parent / "csrc" / "cluster_kernels.cu"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
_lib_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def library_path() -> Path:
    "Where the built library lives; its name carries the source's hash."
    digest = hashlib.sha256(_SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libcluster_kernels_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the CUDA source with nvcc unless an up-to-date build exists.

    With `verbose`, ptxas reports each kernel's registers and shared memory
    (printed by the caller from the returned CompletedProcess output)."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SOURCE}:\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, end="", flush=True)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.vt_row_sweep.argtypes = [vp, ci, ci, ci, vp, vp]
            lib.vt_row_sweep.restype = ci
            lib.vt_candidate_density.argtypes = [vp, ci, ci, vp, ci, vp, vp, ci, vp, vp]
            lib.vt_candidate_density.restype = ci
            lib.vt_max_candidates.argtypes = lib.vt_density_threads.argtypes = []
            lib.vt_max_candidates.restype = lib.vt_density_threads.restype = ci
            # the scratch shape and grid size below assume the source's constants
            if (lib.vt_max_candidates(), lib.vt_density_threads()) != (_MAX_CAND, _DENS_THREADS):
                raise RuntimeError(f"{_SOURCE.name} and {__name__} disagree on kMaxCand/kDensThreads")
            _lib = lib
    return _lib


def _check_matrix(matrixT: torch.Tensor) -> None:
    if matrixT.dtype != torch.float32 or matrixT.dim() != 2:
        raise ValueError("matrixT must be a 2-D float32 tensor (F_pad, N_pad)")
    if not matrixT.is_contiguous():
        raise ValueError("matrixT must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


# ------------------------------------------------------------- row_sweep


def row_sweep_plain(matrixT: torch.Tensor, idx: int) -> torch.Tensor:
    """Plain version of `row_sweep`: the kernel's arithmetic in torch ops
    (feature-ordered f32 multiply-then-add, so it equals the kernel bit for
    bit)."""
    col = matrixT[:, idx]
    acc = torch.zeros(matrixT.shape[1], dtype=torch.float32, device=matrixT.device)
    for f in range(matrixT.shape[0]):
        acc = acc + matrixT[f] * col[f]
    d = 0.5 - acc
    d[idx] = 0.0
    return d


def row_sweep(matrixT: torch.Tensor, idx: int) -> torch.Tensor:
    """Distance row of column `idx`: `d = 0.5 - M^T M[:, idx]`, `d[idx] = 0`.

    (F_pad, N_pad) float32 -> (N_pad,) float32. Launches the CUDA kernel
    for a CUDA tensor (counted in `row_sweep.launches`), runs the plain
    version for a CPU tensor."""
    _check_matrix(matrixT)
    f_pad, n_pad = matrixT.shape
    idx = int(idx)
    if not 0 <= idx < n_pad:
        raise IndexError(f"idx {idx} outside [0, {n_pad})")
    if matrixT.device.type == "cpu":
        return row_sweep_plain(matrixT, idx)
    if matrixT.device.type != "cuda":
        raise ValueError(f"row_sweep runs on cuda or cpu, not {matrixT.device}")
    lib = _load()
    d = torch.empty(n_pad, dtype=torch.float32, device=matrixT.device)
    stream = torch.cuda.current_stream(matrixT.device).cuda_stream
    err = lib.vt_row_sweep(matrixT.data_ptr(), f_pad, n_pad, idx, d.data_ptr(), stream)
    _raise_on(err, "row_sweep")
    row_sweep.launches += 1
    return d


row_sweep.launches = 0


# ---------------------------------------------- candidate_density_sweep


def candidate_density_plain(
    matrixT: torch.Tensor, cand: torch.Tensor, wts: torch.Tensor
) -> torch.Tensor:
    """Plain version of `candidate_density_sweep` (the XLA contract of
    tests/test_pallas.py:106-129): candidate distances with the kernel's
    feature-ordered arithmetic, then one masked row sum per candidate."""
    rows = matrixT[:, cand.long()]  # (F, C)
    dot = torch.zeros(len(cand), matrixT.shape[1], dtype=torch.float32,
                      device=matrixT.device)
    for f in range(matrixT.shape[0]):
        dot = dot + rows[f][:, None] * matrixT[f][None, :]
    D = 0.5 - dot
    iota = torch.arange(matrixT.shape[1], device=matrixT.device)
    D = torch.where(iota[None, :] == cand.long()[:, None], 0.0, D)
    within = (D <= _MEDOID_RADIUS) & (wts > 0.0)[None, :]
    return torch.where(within, wts[None, :] * (_MEDOID_RADIUS - D), 0.0).sum(dim=1)


def density_blocks(n_pad: int) -> int:
    "Pass-1 grid size: a function of N only, so the sum order is fixed."
    return max(1, min(-(-n_pad // _DENS_THREADS), _DENS_MAX_BLOCKS))


def candidate_density_sweep(
    matrixT: torch.Tensor, cand: torch.Tensor, wts: torch.Tensor
) -> torch.Tensor:
    """Densities of C <= 32 candidate medoids in one matrix pass.

    matrixT (F_pad, N_pad) f32, cand (C,) integer columns, wts (N_pad,) f32
    (= lengths where kept, else 0) -> (C,) f32. Launches the two-pass CUDA
    kernel for CUDA tensors (counted in
    `candidate_density_sweep.launches`), runs the plain version for CPU
    tensors."""
    _check_matrix(matrixT)
    f_pad, n_pad = matrixT.shape
    c = int(cand.shape[0])
    if not 1 <= c <= _MAX_CAND:
        raise ValueError(f"need 1 to {_MAX_CAND} candidates, got {c}")
    if wts.shape != (n_pad,) or wts.dtype != torch.float32:
        raise ValueError("wts must be a float32 tensor of shape (N_pad,)")
    if matrixT.device.type == "cpu":
        return candidate_density_plain(matrixT, cand, wts)
    if matrixT.device.type != "cuda":
        raise ValueError(
            f"candidate_density_sweep runs on cuda or cpu, not {matrixT.device}"
        )
    if _MAX_CAND * f_pad * 4 > 48 * 1024:
        raise ValueError(f"F_pad {f_pad} exceeds the kernel's shared-memory tile")
    if cand.device != matrixT.device or wts.device != matrixT.device:
        raise ValueError("matrixT, cand and wts must be on one device")
    lib = _load()
    cand32 = cand.to(torch.int32).contiguous()
    wts = wts.contiguous()
    nblocks = density_blocks(n_pad)
    partials = torch.empty((nblocks, _MAX_CAND), dtype=torch.float32, device=matrixT.device)
    dens = torch.empty(c, dtype=torch.float32, device=matrixT.device)
    stream = torch.cuda.current_stream(matrixT.device).cuda_stream
    err = lib.vt_candidate_density(
        matrixT.data_ptr(), f_pad, n_pad, cand32.data_ptr(), c, wts.data_ptr(),
        partials.data_ptr(), nblocks, dens.data_ptr(), stream,
    )
    _raise_on(err, "candidate_density_sweep")
    candidate_density_sweep.launches += 1
    return dens


candidate_density_sweep.launches = 0


def reset_launch_counts() -> None:
    row_sweep.launches = 0
    candidate_density_sweep.launches = 0

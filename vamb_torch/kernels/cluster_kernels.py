"""The clustering engine's kernels: wrappers, plain versions, launch
counters and the on-demand build.

Seven CUDA C++ kernels for sm_90a live in `csrc/cluster_kernels.cu` (whose
notes say which TPU kernel each replaces, what bounds it on the H100 and
what its design does about it):

* `row_sweep(matrixT, idx)` replaces `vamb_tpu/ops/pallas_cluster.py`
  `row_sweep`: the distance row `0.5 - M^T M[:, idx]` of one medoid with
  `d[idx] = 0.0` exactly. Bound by bytes; at F_pad 32 a thread owns 4
  columns and has all 32 of their 16-byte feature loads in flight as
  cp.async copies, 64 threads a CTA;
* `candidate_density_sweep(matrixT, cand, wts)` replaces
  `candidate_density_sweep` there: the local densities of C wander
  candidates (any C; the Pallas kernel pads C to 32) in one matrix pass
  and one launch, no (C, N) matrix in device memory. Bound by its
  FMA-free f32 operations; a thread computes a
  (CT <= 16 candidates) x (2 columns) register tile, columns staged
  through shared memory by cp.async, candidates split into as few CTA rows
  as fill the card; the last CTA (an integer ticket) sums the CTAs' rows,
  32 candidates at a time.
  Its sums follow an order that depends on N_pad alone, which
  `density_ordered_sum` reproduces, so kernel and plain version agree bit
  for bit and the engine decides alike on the card and on the CPU;
* `gather_blocks(matrixT, bids)` replaces `gather_blocks` there: the
  subset wander's ball, KB blocks of 128 columns copied by device-resident
  block id, in a CTA per (block, 8 feature rows). Its sibling
  `gather_ball(matrixT, bids, nb, w, kept, d0)` runs the same kernel and
  launch, which also gathers each slot's column id, weight, kept flag and
  seed distance, masked past nb blocks; `gather_ball_shard` runs it on a
  shard of the matrix by local block id, each slot's column id global;
* `medoid_sweep(matrixT, idx, wts)` replaces `medoid_sweep` there: one
  medoid's distance row with its 60-bin histogram, density and close count
  in one pass and one launch, the attempt's whole payload. A thread keeps
  a private histogram row in shared memory; the sums follow an order that
  depends on N_pad alone, which `row_stats_plain` reproduces, so kernel
  and plain version agree bit for bit. The engine takes each new medoid's
  row and sums from it;
* `spec_sweep(matrixT, cols, wts)` replaces the speculative seed cache's
  batched rows (`vamb_tpu/cluster.py` :498-515, an XLA einsum, also the
  attempt lanes' final rows): S <= 8 columns' rows and sums in one pass
  over the matrix, each bit for bit `medoid_sweep`'s for its column, and
  each row's near count (d <= 0.05). A CTA a `medoid_sweep` CTA: a
  register tile computes all S rows of 2 columns a thread from each matrix
  value loaded once, then each of medoid_sweep's threads adds its columns'
  terms in its order, and the last CTA (an integer ticket) sums the CTAs'
  rows from shared memory. The engine's cache refills and the lanes' final
  rows take it;
* `row_stats(rows, wts)`: the same sums of S given rows, for a cached row
  after points were removed and for the loner flags of a burst
  (:1100-1112); bit for bit what `medoid_sweep` returns for a column whose
  row is the given one. A CTA per (`medoid_sweep` CTA, row), and a ticket
  and last CTA per row;
* `gumbel_topc(key, d, kept, tried, medoid, C)` replaces a wander step's
  draw and selection (`vamb_tpu/cluster.py` :674-681, :775-782): every
  column's masked Gumbel score with jax's threefry bits and XLA's CPU log
  spelled out rounding by rounding, and the C candidates that
  `jax.lax.top_k` takes from them (score descending, index ascending on
  equal scores), in one launch for C <= 32 and in ceil(C / 32) rounds, a
  launch each, above (round r takes the 32 largest keys below round r - 1's
  last, read on the card). Bound by its integer operations (the
  hash); the scores stay in registers as one 64-bit key a column (an
  order-preserving map of the score's bits, then the inverted index), which
  warps select by shuffle networks, CTAs through shared memory and the last
  CTA (an integer ticket) across CTAs. `gumbel_scores` runs the same kernel
  for the scores alone.

The engine's `distance_dtype="bfloat16"` stores the matrix as bfloat16.
`medoid_sweep`, `spec_sweep` and `candidate_density_sweep`, the kernels
that read it on that path, take a float32 or a bfloat16 matrix and launch
the variant of its type: the same kernel templated on the element type,
which widens each bf16 value exactly to float as it arrives and then runs
the float kernel's arithmetic in its order, so it equals the float kernel
on `matrixT.float()` bit for bit and reads half the bytes. Their plain
versions widen a bf16 matrix and reuse the float arithmetic. Their shard
entry points take a bf16 shard too, with float32 queries (the owner's
columns widened). `row_sweep` and the gathers run only inside the subset
wander, which a bf16 engine never takes, and raise on a bf16 matrix.

Each wrapper launches its kernel for a CUDA tensor and uses the plain
PyTorch version beside it only for a CPU tensor (the engine's
`wander_kernel="xla"` calls the plain versions itself, on any device). It
counts its launches in
`<wrapper>.launches`, by N_pad in `<wrapper>.launches_by_width` and, for the
wrappers that read the latent matrix, by F_pad in `<wrapper>.launches_by_fpad`
and by the matrix's type ("float32" or "bfloat16") in
`<wrapper>.launches_by_dtype` (the Gumbel kernels and `row_stats` see no
matrix: theirs stay empty). The source is compiled by `nvcc` at first use
into `kernels/_build/` and bound with ctypes; nothing is compiled or
imported from CUDA while this module is imported. The library also
counts, on the host, the launches each of its `__global__` functions was
given without an error (`device_launches`), whatever wrapper made them.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from ..utils import threefry

_MEDOID_RADIUS = 0.05
_CAND_GROUP = 32  # kCandGroup: candidates a gumbel_topc launch selects
# the density kernel's most candidates: ceil(C/16) CTA rows, at most 65,535
_DENS_MAX_CAND = 16 * 65_535
_DENS_THREADS = 128  # kDensThreads: 4 warps
_DENS_VEC = 2  # kDensVec: neighbouring columns a thread owns in a tile
_DENS_TILE_COLS = _DENS_THREADS * _DENS_VEC  # kDensTileCols
_DENS_MAX_BLOCKS = 256  # kDensMaxBlocks: the width of the last CTA's tree
_DENS_TILE = 16  # kDensTile: most candidates in one CTA's register tile
_BLOCK = 128  # kBlockCols: the subset wander's block width
_SWEEP_THREADS = 64  # kSweepThreads: medoid_sweep's threads a CTA
_SWEEP_VEC = 4  # kSweepVec: neighbouring columns a thread owns in a tile
_SWEEP_TILE_COLS = _SWEEP_THREADS * _SWEEP_VEC
_SWEEP_MAX_BLOCKS = 128  # kSweepMaxBlocks: the width of the last CTA's tree
_SWEEP_SLOTS = 64  # kSweepSlots: a CTA's partial row
_SPEC_SEEDS = 8  # kSpecSeeds: the most rows spec_sweep and row_stats take
_NBINS = 60
_DELTA_X = 0.005
_XMAX = 0.3

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


def library_path(source: Path = _SOURCE) -> Path:
    "Where the library built from `source` lives; its name carries the source's hash."
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return _BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False, source: Path = _SOURCE) -> Path:
    """Compile a CUDA source of `csrc/` (default: the clustering kernels)
    with nvcc unless an up-to-date build exists; raises with nvcc's output
    if it fails.

    With `verbose`, ptxas reports each kernel's registers and shared memory
    (printed here). Builds of different sources may run at once."""
    out = library_path(source)
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {source}:\n"
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
            for fn in (lib.vt_candidate_density, lib.vt_candidate_density_bf16):
                fn.argtypes = [vp, ci, ci, vp, ci, ci, vp, ci, vp, vp, vp, vp]
                fn.restype = ci
            lib.vt_gather_blocks.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp, vp, vp, vp, vp, vp,
                                             vp, vp]
            lib.vt_gather_blocks.restype = ci
            lib.vt_gather_ball_shard.argtypes = [vp, ci, ci, vp, ci, vp, ci, vp, vp, vp, vp, vp, vp,
                                                 vp, ci, vp]
            lib.vt_gather_ball_shard.restype = ci
            for fn in (lib.vt_medoid_sweep, lib.vt_medoid_sweep_bf16):
                fn.argtypes = [vp, ci, ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp]
                fn.restype = ci
            cu = ctypes.c_uint
            lib.vt_gumbel_topc.argtypes = [cu, cu, ci, ci, vp, vp, vp, ci, ci, vp, vp, vp, vp, vp,
                                           vp, ci, vp]
            lib.vt_gumbel_topc.restype = ci
            for suffix in ("", "_bf16"):  # the shard entry points, of either matrix type
                medoid, spec, dens = (
                    getattr(lib, f"vt_{name}_shard{suffix}")
                    for name in ("medoid_sweep", "spec_sweep", "candidate_density"))
                medoid.argtypes = [vp, ci, ci, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp]
                spec.argtypes = [vp, ci, ci, vp, *[ci] * _SPEC_SEEDS, ci, vp, vp, vp, vp, vp, vp,
                                 vp, vp]
                dens.argtypes = [vp, ci, ci, vp, vp, ci, ci, vp, ci, vp, vp, vp, vp]
                for fn in (medoid, spec, dens):
                    fn.restype = ci
            for fn in (lib.vt_spec_sweep, lib.vt_spec_sweep_bf16):
                fn.argtypes = [vp, ci, ci, *[ci] * _SPEC_SEEDS, ci, vp, vp, vp, vp, vp, vp, vp, vp]
                fn.restype = ci
            lib.vt_row_stats.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp, vp]
            lib.vt_row_stats.restype = ci
            lib.vt_launch_ids.argtypes, lib.vt_launch_ids.restype = [], ci
            lib.vt_launch_name.argtypes, lib.vt_launch_name.restype = [ci], ctypes.c_char_p
            lib.vt_launches.argtypes, lib.vt_launches.restype = [ci], ctypes.c_ulonglong
            consts = (lib.vt_cand_group, lib.vt_density_threads, lib.vt_density_tile_cols,
                      lib.vt_density_max_blocks, lib.vt_density_tile, lib.vt_sweep_threads,
                      lib.vt_sweep_vec, lib.vt_sweep_max_blocks, lib.vt_sweep_slots,
                      lib.vt_block_cols, lib.vt_spec_seeds)
            for fn in consts:
                fn.argtypes, fn.restype = [], ci
            # the scratch shapes, grid sizes and the plain versions' sum order
            # below assume the source's constants
            if tuple(fn() for fn in consts) != (_CAND_GROUP, _DENS_THREADS, _DENS_TILE_COLS,
                                                _DENS_MAX_BLOCKS, _DENS_TILE, _SWEEP_THREADS,
                                                _SWEEP_VEC, _SWEEP_MAX_BLOCKS, _SWEEP_SLOTS,
                                                _BLOCK, _SPEC_SEEDS):
                raise RuntimeError(f"{_SOURCE.name} and {__name__} disagree on its constants")
            _lib = lib
    return _lib


_MATRIX_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}


def _check_matrix(matrixT: torch.Tensor, bf16: bool = False) -> None:
    """A (F_pad, N_pad) contiguous float32 matrix or, where the kernel has a
    bf16 variant (`bf16`), a bfloat16 one."""
    if matrixT.dim() != 2 or matrixT.dtype not in (
            (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)):
        raise ValueError("matrixT must be a 2-D float32 tensor (F_pad, N_pad)"
                         + (" or a bfloat16 one" if bf16 else
                            "; only the subset wander runs this kernel, and it is float32 only"))
    if not matrixT.is_contiguous():
        raise ValueError("matrixT must be contiguous")


def _widened(matrixT: torch.Tensor) -> torch.Tensor:
    "A plain version's float32 matrix: a bf16 one widened (exact), a float32 one as it is."
    return matrixT.float() if matrixT.dtype == torch.bfloat16 else matrixT


def _launcher(lib, name: str, matrixT: torch.Tensor):
    "The C function of kernel `name` for the matrix's element type."
    return getattr(lib, name + ("_bf16" if matrixT.dtype == torch.bfloat16 else ""))


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def _count(kernel, n_pad: int, matrixT=None, launches: int = 1) -> None:
    """`launches` launches of `kernel` on the (F_pad, N_pad) matrix `matrixT`
    (or on n_pad columns of a step or of rows, no matrix): its count and its
    tallies by N_pad, by F_pad and by the matrix's type."""
    kernel.launches += launches
    kernel.launches_by_width[n_pad] = kernel.launches_by_width.get(n_pad, 0) + launches
    if matrixT is not None:
        f_pad, dtype = matrixT.shape[0], _MATRIX_DTYPES[matrixT.dtype]
        kernel.launches_by_fpad[f_pad] = kernel.launches_by_fpad.get(f_pad, 0) + launches
        kernel.launches_by_dtype[dtype] = kernel.launches_by_dtype.get(dtype, 0) + launches


def device_launches() -> dict:
    """{name of a `__global__` function of the library: the launches it was
    given without an error}, counted on the host by the library itself (its
    C entry points, after each launch's error check) since it was loaded:
    a count of a named kernel that needs no profiler. Builds and loads the
    library where that was not done yet."""
    lib = _load()
    return {lib.vt_launch_name(i).decode(): int(lib.vt_launches(i))
            for i in range(lib.vt_launch_ids())}


# ------------------------------------------------------------- row_sweep


def _row_plain(matrixT: torch.Tensor, col: torch.Tensor, idx: int) -> torch.Tensor:
    """`0.5 - M^T col` with feature-ordered f32 multiply-then-add, and d[idx]
    = 0 where idx >= 0 (a shard's query held by another rank has -1)."""
    acc = torch.zeros(matrixT.shape[1], dtype=torch.float32, device=matrixT.device)
    for f in range(matrixT.shape[0]):
        acc = acc + matrixT[f] * col[f]
    d = 0.5 - acc
    if idx >= 0:
        d[idx] = 0.0
    return d


def row_sweep_plain(matrixT: torch.Tensor, idx: int) -> torch.Tensor:
    """Plain version of `row_sweep`: the kernel's arithmetic in torch ops
    (feature-ordered f32 multiply-then-add, so it equals the kernel bit for
    bit)."""
    return _row_plain(matrixT, matrixT[:, idx], idx)


def row_sweep(matrixT: torch.Tensor, idx: int) -> torch.Tensor:
    """Distance row of column `idx`: `d = 0.5 - M^T M[:, idx]`, `d[idx] = 0`.

    (F_pad, N_pad) float32 -> (N_pad,) float32 (a bfloat16 matrix raises:
    only the subset wander runs it). Launches the CUDA kernel for a CUDA
    tensor (counted in `row_sweep.launches`), runs the plain version for a
    CPU tensor."""
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
    _count(row_sweep, n_pad, matrixT)
    return d


row_sweep.launches = 0
row_sweep.launches_by_width = {}  # N_pad -> launches
row_sweep.launches_by_fpad = {}  # F_pad -> launches
row_sweep.launches_by_dtype = {}  # the matrix's type -> launches


# ---------------------------------------------- candidate_density_sweep


def candidate_density_plain(
    matrixT: torch.Tensor, cand: torch.Tensor, wts: torch.Tensor
) -> torch.Tensor:
    """Plain version of `candidate_density_sweep` (the XLA contract of
    tests/test_pallas.py:106-129): candidate distances with the kernel's
    feature-ordered arithmetic, the masked terms, then `density_ordered_sum`,
    the kernel's summation order, so it equals the kernel bit for bit. A
    bf16 matrix is widened first, as the kernel widens it."""
    matrixT = _widened(matrixT)
    return candidate_density_shard_plain(matrixT, matrixT[:, cand.long()], cand, wts)


def candidate_density_shard_plain(
    matrixT: torch.Tensor, q: torch.Tensor, cand: torch.Tensor, wts: torch.Tensor
) -> torch.Tensor:
    """Plain version of `candidate_density_shard`: the candidates' features
    `q` (F, C), their local columns `cand` (-1 where another rank holds
    one), then `candidate_density_plain`'s arithmetic and order; a bf16
    shard widened first."""
    matrixT = _widened(matrixT)
    dot = torch.zeros(q.shape[1], matrixT.shape[1], dtype=torch.float32, device=matrixT.device)
    for f in range(matrixT.shape[0]):
        dot = dot + q[f][:, None] * matrixT[f][None, :]
    D = 0.5 - dot
    iota = torch.arange(matrixT.shape[1], device=matrixT.device)
    D = torch.where(iota[None, :] == cand.long()[:, None], 0.0, D)
    within = (D <= _MEDOID_RADIUS) & (wts > 0.0)[None, :]
    return density_ordered_sum(torch.where(within, wts[None, :] * (_MEDOID_RADIUS - D), 0.0))


def density_col_blocks(n_pad: int) -> tuple[int, int]:
    """(K, B): the density kernel's tiles a column CTA and column CTAs at
    width `n_pad`, for T tiles of 256 columns: K = ceil(T / 256), B =
    ceil(T / K) <= 256. A function of N only, so the sum order is fixed."""
    tiles = -(-n_pad // _DENS_TILE_COLS)
    k = -(-tiles // _DENS_MAX_BLOCKS)
    return k, -(-tiles // k)


def density_ordered_sum(terms: torch.Tensor) -> torch.Tensor:
    """(C, N) float32 terms, each >= +0 -> (C,) row sums in the density
    kernel's order (csrc/cluster_kernels.cu): column n = ((i*B + b)*128 +
    tid)*2 + v goes to thread tid of column CTA b, which adds its terms in
    (i, v) order; then halving trees over the 32 lanes of a warp, the 4
    warps and the B column CTAs padded with zeros to 256. Every stage is a
    separately rounded f32 tensor add."""
    c, n = terms.shape
    k, b = density_col_blocks(n)
    x = torch.nn.functional.pad(terms, (0, k * b * _DENS_TILE_COLS - n))
    x = x.view(c, k, b, _DENS_THREADS, _DENS_VEC)
    acc = torch.zeros((c, b, _DENS_THREADS), dtype=terms.dtype, device=terms.device)
    for i in range(k):
        for v in range(_DENS_VEC):
            acc = acc + x[:, i, :, :, v]
    acc = acc.view(c, b, _DENS_THREADS // 32, 32)
    acc = _halving_tree(acc)  # lanes -> (c, b, warps)
    acc = _halving_tree(acc)  # warps -> (c, b)
    return _halving_tree(torch.nn.functional.pad(acc, (0, _DENS_MAX_BLOCKS - b)))


def _halving_tree(x: torch.Tensor) -> torch.Tensor:
    "Sum the last (power-of-two) axis: x[:h] + x[h:], halving h down to 1."
    h = x.shape[-1]
    while h > 1:
        h //= 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def density_groups(c: int, col_blocks: int, sms: int) -> int:
    """Candidate groups (CTA rows) of the density kernel: at least
    ceil(C/16), more while the column CTAs alone are fewer than two an SM.
    Any count gives the same sums."""
    return min(c, max(-(-c // _DENS_TILE), -(-2 * sms // col_blocks)))


_density_ws: dict = {}


def _density_workspace(dev: torch.device, stream: int, c: int):
    """The density kernel's per-stream (C', 256) partials, C' the most
    candidates it was given on the stream rounded up to 32 (grown where a
    call brings more: calls on one stream are serialized), and int32 ticket
    (zeroed once; the kernel's last CTA resets it after every call)."""
    key = (dev.index, stream)
    ws = _density_ws.get(key)
    if ws is None or ws[0].shape[0] < c:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        rows = -(-c // _CAND_GROUP) * _CAND_GROUP
        ticket = torch.zeros(1, dtype=torch.int32, device=dev) if ws is None else ws[1]
        ws = (torch.empty((rows, _DENS_MAX_BLOCKS), dtype=torch.float32, device=dev), ticket, sms)
        _density_ws[key] = ws
    return ws


def candidate_density_sweep(
    matrixT: torch.Tensor, cand: torch.Tensor, wts: torch.Tensor
) -> torch.Tensor:
    """Densities of C candidate medoids in one matrix pass.

    matrixT (F_pad, N_pad) f32 or bf16, cand (C,) int64 or int32 columns,
    wts (N_pad,) f32 (= lengths where kept, else 0) -> (C,) f32. Launches
    the one-pass CUDA kernel of the matrix's type for CUDA tensors (ids go
    in as they are; counted in `candidate_density_sweep.launches`), runs the
    plain version for CPU tensors; both give the same bits, a bf16 matrix's
    those of its widened float32 copy."""
    _check_matrix(matrixT, bf16=True)
    f_pad, n_pad = matrixT.shape
    if cand.shape[0] < 1:
        raise ValueError("need at least one candidate")
    if wts.shape != (n_pad,) or wts.dtype != torch.float32:
        raise ValueError("wts must be a float32 tensor of shape (N_pad,)")
    if matrixT.device.type == "cpu":
        return candidate_density_plain(matrixT, cand, wts)
    return _density_launch(candidate_density_sweep, matrixT, cand, None, wts)


def _density_launch(kernel, matrixT, cand, q, wts) -> torch.Tensor:
    """One launch of the density kernel (`kernel`: its wrapper, whose count
    it adds to): the candidates' features from the matrix by `cand` or,
    given `q`, from q (the shard entry point)."""
    f_pad, n_pad = matrixT.shape
    c = int(cand.shape[0])
    if matrixT.device.type != "cuda":
        raise ValueError(f"{kernel.__name__} runs on cuda or cpu, not {matrixT.device}")
    if c > _DENS_MAX_CAND:
        raise ValueError(f"the density kernel takes at most {_DENS_MAX_CAND} candidates, not {c}")
    if _DENS_TILE * f_pad * 4 > 48 * 1024:
        raise ValueError(f"F_pad {f_pad} exceeds the kernel's shared-memory tile")
    if cand.device != matrixT.device or wts.device != matrixT.device:
        raise ValueError("matrixT, cand and wts must be on one device")
    if cand.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"cand must be int64 or int32, not {cand.dtype}")
    lib = _load()
    dev = matrixT.device
    cand = cand.contiguous()
    wts = wts.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, ticket, sms = _density_workspace(dev, stream, c)
    groups = density_groups(c, density_col_blocks(n_pad)[1], sms)
    dens = torch.empty(c, dtype=torch.float32, device=dev)
    tail = (cand.data_ptr(), int(cand.dtype == torch.int64), c, wts.data_ptr(), groups,
            partials.data_ptr(), ticket.data_ptr(), dens.data_ptr(), stream)
    if q is None:
        err = _launcher(lib, "vt_candidate_density", matrixT)(matrixT.data_ptr(), f_pad, n_pad,
                                                               *tail)
    else:
        err = _launcher(lib, "vt_candidate_density_shard", matrixT)(matrixT.data_ptr(), f_pad,
                                                                     n_pad, q.data_ptr(), *tail)
    _raise_on(err, kernel.__name__)
    _count(kernel, n_pad, matrixT)
    return dens


candidate_density_sweep.launches = 0
candidate_density_sweep.launches_by_width = {}  # N_pad -> launches
candidate_density_sweep.launches_by_fpad = {}  # F_pad -> launches
candidate_density_sweep.launches_by_dtype = {}  # the matrix's type -> launches


def _check_query(q: torch.Tensor, shape: tuple, dev) -> None:
    "A shard entry point's query features: a contiguous float32 tensor of `shape` on `dev`."
    if q.shape != shape or q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous float32 tensor of shape {shape}")
    if q.device != dev:
        raise ValueError(f"q must lie on {dev}, not {q.device}")


def _check_shard_matrix(matrixT: torch.Tensor) -> None:
    """A shard entry point's (F_pad, N_local) matrix: float32 or bfloat16
    (a bf16 engine's shard), contiguous."""
    if matrixT.dim() != 2 or matrixT.dtype not in _MATRIX_DTYPES:
        raise ValueError("matrixT must be a 2-D float32 or bfloat16 tensor (F_pad, N_local)")
    if not matrixT.is_contiguous():
        raise ValueError("matrixT must be contiguous")


def candidate_density_shard(
    matrixT: torch.Tensor, q: torch.Tensor, cand: torch.Tensor, wts: torch.Tensor
) -> torch.Tensor:
    """`candidate_density_sweep` on a shard of the matrix (f32 or bf16):
    the C candidates' features come from q (F_pad, C) f32, and `cand` (C,) holds
    each one's local column or -1 where another rank holds it (its distance
    to itself is then not forced to 0 here). Returns the shard's (C,)
    densities over its N_local columns, summed in the order of that width.
    Given a candidate's column as its features and index, it equals
    `candidate_density_sweep` bit for bit. Launches the density kernel for
    CUDA tensors (counted in `candidate_density_shard.launches`), runs the
    plain version for CPU tensors."""
    _check_shard_matrix(matrixT)
    f_pad, n_pad = matrixT.shape
    c = int(cand.shape[0])
    if c < 1:
        raise ValueError("need at least one candidate")
    if wts.shape != (n_pad,) or wts.dtype != torch.float32:
        raise ValueError("wts must be a float32 tensor of shape (N_local,)")
    _check_query(q, (f_pad, c), matrixT.device)
    if matrixT.device.type == "cpu":
        return candidate_density_shard_plain(matrixT, q, cand, wts)
    return _density_launch(candidate_density_shard, matrixT, cand, q, wts)


candidate_density_shard.launches = 0
candidate_density_shard.launches_by_width = {}  # N_local -> launches
candidate_density_shard.launches_by_fpad = {}  # F_pad -> launches
candidate_density_shard.launches_by_dtype = {}  # the matrix's type -> launches


# --------------------------------------------------------- gather_blocks


def gather_blocks_plain(matrixT: torch.Tensor, bids: torch.Tensor) -> torch.Tensor:
    """Plain version of `gather_blocks`: the XLA take of cluster.py:648-650
    as one `index_select` over the (F, NB, 128) view."""
    f_pad, n_pad = matrixT.shape
    return matrixT.view(f_pad, n_pad // _BLOCK, _BLOCK).index_select(1, bids).reshape(f_pad, -1)


def gather_ball_plain(matrixT, bids, nb: int, w, kept, d0):
    """Plain version of `gather_ball`: `gather_blocks_plain`, then the takes
    and masks of vamb_tpu/cluster.py:604-606 and 654-656 (slots past nb
    blocks: weight 0, not kept, d0 inf) and each slot's column id."""
    blocks = lambda v: v.view(-1, _BLOCK).index_select(0, bids).reshape(-1)  # noqa: E731
    lane = torch.arange(_BLOCK, dtype=torch.int32, device=bids.device)
    cols = (bids.to(torch.int32)[:, None] * _BLOCK + lane[None, :]).reshape(-1)
    valid = (torch.arange(len(bids), device=bids.device) < nb).repeat_interleave(_BLOCK)
    return (gather_blocks_plain(matrixT, bids), cols, blocks(kept) & valid,
            torch.where(valid, blocks(w), 0.0), torch.where(valid, blocks(d0), torch.inf))


def gather_ball_shard_plain(matrixT, bids, nb: int, w, kept, d0, offset: int):
    """Plain version of `gather_ball_shard`: `gather_ball_plain` on the
    shard, each slot's column id moved to the global columns."""
    xs, cols, kept_s, w_s, d0_s = gather_ball_plain(matrixT, bids, nb, w, kept, d0)
    return xs, cols + offset, kept_s, w_s, d0_s


def _check_gather(matrixT: torch.Tensor, bids: torch.Tensor) -> None:
    _check_matrix(matrixT)
    if matrixT.shape[1] % _BLOCK:
        raise ValueError(f"N_pad {matrixT.shape[1]} is not a multiple of {_BLOCK}")
    if bids.dim() != 1 or bids.shape[0] < 1:
        raise ValueError("bids must be a non-empty 1-D tensor")
    if matrixT.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gather_blocks runs on cuda or cpu, not {matrixT.device}")


def _gather_launch(matrixT, bids, side=None, kernel=None, offset: int = 0):
    """One launch of the gather kernel: the (F_pad, KB * 128) ball and, given
    `side` = (nb, w, kept, d0), the slots' ids (plus `offset`), flags,
    weights and seed distances. Counted in `kernel`'s tallies (default
    `gather_blocks`)."""
    if bids.device != matrixT.device:
        raise ValueError("matrixT and bids must be on one device")
    if matrixT.data_ptr() % 16:
        raise ValueError("matrixT must be 16-byte aligned for the vector loads")
    lib = _load()
    dev = matrixT.device
    f_pad, n_pad = matrixT.shape
    kb = int(bids.shape[0])
    bids32 = bids.to(torch.int32).contiguous()
    out = torch.empty((f_pad, kb * _BLOCK), dtype=torch.float32, device=dev)
    ptrs, outs = [0] * 8, ()
    if side is not None:
        nb, w, kept, d0 = side
        if any(v.shape != (n_pad,) or v.device != dev for v in (w, kept, d0)):
            raise ValueError("w, kept and d0 must be (N_pad,) tensors on matrixT's device")
        if w.dtype != torch.float32 or d0.dtype != torch.float32 or kept.dtype != torch.bool:
            raise ValueError("w and d0 must be float32 and kept bool")
        w, kept, d0 = w.contiguous(), kept.contiguous(), d0.contiguous()
        q = kb * _BLOCK
        outs = (torch.empty(q, dtype=torch.int32, device=dev),
                torch.empty(q, dtype=torch.bool, device=dev),
                torch.empty(q, dtype=torch.float32, device=dev),
                torch.empty(q, dtype=torch.float32, device=dev))
        ptrs = [int(nb), w.data_ptr(), kept.data_ptr(), d0.data_ptr(), *(o.data_ptr() for o in outs)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel = kernel or gather_blocks
    if kernel is gather_ball_shard:
        err = lib.vt_gather_ball_shard(matrixT.data_ptr(), f_pad, n_pad, bids32.data_ptr(), kb,
                                       out.data_ptr(), *ptrs, int(offset), stream)
    else:
        err = lib.vt_gather_blocks(matrixT.data_ptr(), f_pad, n_pad, bids32.data_ptr(), kb,
                                   out.data_ptr(), *ptrs, stream)
    _raise_on(err, kernel.__name__)
    _count(kernel, n_pad, matrixT)
    return (out, *outs)


def gather_blocks(matrixT: torch.Tensor, bids: torch.Tensor) -> torch.Tensor:
    """Copy KB column blocks of width 128 by block id: (F_pad, N_pad) f32,
    (KB,) integer ids in [0, N_pad / 128) -> (F_pad, KB * 128) f32,
    bit-exact, repeated ids included. Launches the CUDA kernel for a CUDA
    tensor (counted in `gather_blocks.launches`; no host sync on the ids;
    int32 ids go in as they are), runs the plain version for a CPU
    tensor."""
    _check_gather(matrixT, bids)
    if matrixT.device.type == "cpu":
        return gather_blocks_plain(matrixT, bids)
    return _gather_launch(matrixT, bids)[0]


def gather_ball(matrixT, bids, nb: int, w, kept, d0):
    """The subset wander's ball and its per-slot vectors in one launch of
    the gather kernel (counted in `gather_blocks.launches`): returns (xsT
    (F_pad, KB * 128), cols int32 (the column of each slot), kept bool, w,
    d0), where slots of the blocks past the first `nb` are not kept, weigh
    0 and lie at distance inf. `w` (N_pad,) f32, `kept` (N_pad,) bool, `d0`
    (N_pad,) f32. Runs the plain version for CPU tensors."""
    _check_gather(matrixT, bids)
    if matrixT.device.type == "cpu":
        return gather_ball_plain(matrixT, bids, nb, w, kept, d0)
    return _gather_launch(matrixT, bids, (nb, w, kept, d0))


gather_blocks.launches = 0
gather_blocks.launches_by_width = {}  # N_pad -> launches
gather_blocks.launches_by_fpad = {}  # F_pad -> launches
gather_blocks.launches_by_dtype = {}  # the matrix's type -> launches


def gather_ball_shard(matrixT, bids, nb: int, w, kept, d0, offset: int):
    """`gather_ball` on a shard of the matrix: (F_pad, N_local) f32 whose
    columns are the global columns offset.., (KB,) local block ids, the
    shard's (N_local,) w, kept and d0 -> (xsT (F_pad, KB * 128), cols int32
    (each slot's global column), kept, w, d0), slots past the first `nb`
    blocks masked as `gather_ball` masks them. A rank's part of the subset
    wander's ball under a mesh: the same kernel and launch as `gather_ball`,
    which adds `offset` to each slot's column id. Given `offset` 0 it equals
    `gather_ball` bit for bit. Launches the gather kernel for CUDA tensors
    (counted in `gather_ball_shard.launches`), runs the plain version for
    CPU tensors."""
    _check_gather(matrixT, bids)
    if offset < 0:
        raise ValueError(f"offset must be >= 0, not {offset}")
    if matrixT.device.type == "cpu":
        return gather_ball_shard_plain(matrixT, bids, nb, w, kept, d0, offset)
    return _gather_launch(matrixT, bids, (nb, w, kept, d0), gather_ball_shard, offset)


gather_ball_shard.launches = 0
gather_ball_shard.launches_by_width = {}  # N_local -> launches
gather_ball_shard.launches_by_fpad = {}  # F_pad -> launches
gather_ball_shard.launches_by_dtype = {}  # the matrix's type -> launches


# ---------------------------------------------------------- medoid_sweep


def sweep_col_blocks(n_pad: int) -> tuple[int, int]:
    """(K, B): medoid_sweep's tiles a CTA and CTAs at width `n_pad`, for T
    tiles of 256 columns: K = ceil(T / 128), B = ceil(T / K) <= 128. A
    function of N only, so the sum order is fixed."""
    tiles = -(-n_pad // _SWEEP_TILE_COLS)
    k = -(-tiles // _SWEEP_MAX_BLOCKS)
    return k, -(-tiles // k)


def row_stats_plain(rows: torch.Tensor, wts: torch.Tensor):
    """Plain version of `row_stats`: for each row of `rows` (S, N), the sums
    `medoid_sweep` takes of its row, in the kernel's order, and the near
    count. The order (csrc/cluster_kernels.cu): column n = ((i*B + b)*64 +
    tid)*4 + v goes to thread tid of CTA b, which adds its terms in (i, v)
    order; then halving trees over the 64 threads and over the B CTAs
    padded with zeros to 128, every stage a separately rounded f32 add. In
    the threads' loop a column adds its weight to one bin only (a
    `scatter_add_` into distinct places, so each is one rounded add), and
    adding +0 to the other sums changes none, every sum being >= +0.
    Returns (hist (S, 60), density (S,), n_close (S,) int32, n_near (S,)
    int32)."""
    s, n = rows.shape
    k, b = sweep_col_blocks(n)
    pad = k * b * _SWEEP_TILE_COLS - n
    pos = wts > 0.0
    bins = torch.clamp((rows / _DELTA_X).to(torch.int32), 0, _NBINS - 1)
    in_hist = (rows >= 0.0) & (rows <= _XMAX) & pos
    near = (rows <= _MEDOID_RADIUS) & pos
    w_hist = torch.where(in_hist, wts, 0.0)
    w_dens = torch.where(near, wts * (_MEDOID_RADIUS - rows), 0.0)

    def tiles(x):  # (S, N) -> (S, K, B, threads, vec), zeros past N
        return torch.nn.functional.pad(x, (0, pad)).view(s, k, b, _SWEEP_THREADS, _SWEEP_VEC)

    bins, w_hist, w_dens = tiles(bins.to(torch.int64)), tiles(w_hist), tiles(w_dens)
    acc = torch.zeros((s, _NBINS + 1, b, _SWEEP_THREADS), dtype=torch.float32, device=rows.device)
    for i in range(k):
        for v in range(_SWEEP_VEC):
            acc.scatter_add_(1, bins[:, None, i, :, :, v], w_hist[:, None, i, :, :, v])
            acc[:, _NBINS] += w_dens[:, i, :, :, v]
    acc = _halving_tree(acc)  # threads -> (S, 61, B)
    sums = _halving_tree(torch.nn.functional.pad(acc, (0, _SWEEP_MAX_BLOCKS - b)))
    n_close = ((rows < _MEDOID_RADIUS) & pos).sum(1).to(torch.int32)
    return sums[:, :_NBINS], sums[:, _NBINS], n_close, near.sum(1).to(torch.int32)


def spec_sweep_plain(matrixT: torch.Tensor, cols, wts: torch.Tensor):
    """Plain version of `spec_sweep`: each column's `row_sweep_plain` row
    (the same elementwise ops, batched) and `row_stats_plain`'s sums; a
    bf16 matrix widened first."""
    matrixT = _widened(matrixT)
    cols = [int(c) for c in cols]
    return spec_sweep_shard_plain(matrixT, matrixT[:, cols], cols, wts)


def spec_sweep_shard_plain(matrixT: torch.Tensor, q: torch.Tensor, cols, wts: torch.Tensor):
    """Plain version of `spec_sweep_shard`: the rows of the query features
    `q` (F, S) with `spec_sweep_plain`'s elementwise ops, rows[s, cols[s]]
    = 0 where cols[s] >= 0, then `row_stats_plain`'s sums; a bf16 shard
    widened first."""
    matrixT = _widened(matrixT)
    acc = torch.zeros((q.shape[1], matrixT.shape[1]), dtype=torch.float32, device=matrixT.device)
    for f in range(matrixT.shape[0]):
        acc = acc + matrixT[f][None, :] * q[f][:, None]
    rows = 0.5 - acc
    own = [(s, c) for s, c in enumerate(cols) if c >= 0]
    if own:
        rows[[s for s, _ in own], [c for _, c in own]] = 0.0
    return (rows, *row_stats_plain(rows, wts))


def medoid_sweep_plain(matrixT: torch.Tensor, idx: int, wts: torch.Tensor):
    """Plain version of `medoid_sweep` (the XLA contract of
    tests/test_pallas.py:40-55): `row_sweep_plain`'s row, then the
    histogram's and the density's sums in the kernel's order
    (`row_stats_plain`), so it equals the kernel bit for bit; the close
    count. A bf16 matrix is widened first."""
    matrixT = _widened(matrixT)
    return medoid_sweep_shard_plain(matrixT, matrixT[:, idx], idx, wts)


def medoid_sweep_shard_plain(matrixT: torch.Tensor, q: torch.Tensor, idx: int, wts: torch.Tensor):
    """Plain version of `medoid_sweep_shard`: the row of the query features
    q (F,) with `row_sweep_plain`'s arithmetic (d[idx] = 0 where idx >= 0),
    then `row_stats_plain`'s sums; the close count. A bf16 shard is
    widened first."""
    d = _row_plain(_widened(matrixT), q, idx)
    hist, dens, n_close, _ = row_stats_plain(d[None], wts)
    return d, hist[0], dens[0], n_close[0]


_sweep_ws: dict = {}


def _sweep_workspace(dev: torch.device, stream: int):
    """medoid_sweep's per-stream (128, 64) partial rows, (128,) close counts
    and int32 ticket (zeroed once; the last CTA resets the ticket)."""
    key = (dev.index, stream)
    ws = _sweep_ws.get(key)
    if ws is None:
        ws = (torch.zeros((_SWEEP_MAX_BLOCKS, _SWEEP_SLOTS), dtype=torch.float32, device=dev),
              torch.zeros(_SWEEP_MAX_BLOCKS, dtype=torch.int32, device=dev),
              torch.zeros(1, dtype=torch.int32, device=dev))
        _sweep_ws[key] = ws
    return ws


def medoid_sweep(matrixT: torch.Tensor, idx: int, wts: torch.Tensor):
    """One medoid's fused sweep: (F_pad, N_pad) f32 or bf16, column `idx`,
    (N_pad,) f32 weights (lengths where kept, else 0) -> (d (N_pad,) f32
    with d[idx] = 0, hist (60,) f32 over 0 <= d <= 0.3, density f32 over d
    <= 0.05, n_close int32 over d < 0.05). Launches the one-pass CUDA kernel
    of the matrix's type for a CUDA tensor (counted in
    `medoid_sweep.launches`); its d equals `row_sweep`'s on the float32
    matrix (a bf16 one widened) bit for bit and its sums the plain
    version's. Runs the plain version for a CPU tensor."""
    _check_matrix(matrixT, bf16=True)
    f_pad, n_pad = matrixT.shape
    idx = int(idx)
    if not 0 <= idx < n_pad:
        raise IndexError(f"idx {idx} outside [0, {n_pad})")
    if wts.shape != (n_pad,) or wts.dtype != torch.float32:
        raise ValueError("wts must be a float32 tensor of shape (N_pad,)")
    if matrixT.device.type == "cpu":
        return medoid_sweep_plain(matrixT, idx, wts)
    return _medoid_launch(medoid_sweep, matrixT, idx, None, wts)


def _medoid_launch(kernel, matrixT, idx: int, q, wts):
    """One launch of the medoid kernel (`kernel`: its wrapper, whose count
    it adds to): the query's features from column `idx` or, given `q`, from
    q (the shard entry point)."""
    f_pad, n_pad = matrixT.shape
    if matrixT.device.type != "cuda":
        raise ValueError(f"{kernel.__name__} runs on cuda or cpu, not {matrixT.device}")
    if wts.device != matrixT.device:
        raise ValueError("matrixT and wts must be on one device")
    lib = _load()
    dev = matrixT.device
    wts = wts.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, close_partials, ticket = _sweep_workspace(dev, stream)
    d = torch.empty(n_pad, dtype=torch.float32, device=dev)
    sums = torch.empty(_NBINS + 1, dtype=torch.float32, device=dev)  # histogram, density
    n_close = torch.empty((), dtype=torch.int32, device=dev)
    tail = (wts.data_ptr(), d.data_ptr(), partials.data_ptr(), close_partials.data_ptr(),
            ticket.data_ptr(), sums.data_ptr(), sums.data_ptr() + 4 * _NBINS, n_close.data_ptr(),
            stream)
    if q is None:
        err = _launcher(lib, "vt_medoid_sweep", matrixT)(matrixT.data_ptr(), f_pad, n_pad, idx,
                                                          *tail)
    else:
        err = _launcher(lib, "vt_medoid_sweep_shard", matrixT)(matrixT.data_ptr(), f_pad, n_pad,
                                                                q.data_ptr(), idx, *tail)
    _raise_on(err, kernel.__name__)
    _count(kernel, n_pad, matrixT)
    return d, sums[:_NBINS], sums[_NBINS], n_close


medoid_sweep.launches = 0
medoid_sweep.launches_by_width = {}  # N_pad -> launches
medoid_sweep.launches_by_fpad = {}  # F_pad -> launches
medoid_sweep.launches_by_dtype = {}  # the matrix's type -> launches


def medoid_sweep_shard(matrixT: torch.Tensor, q: torch.Tensor, idx: int, wts: torch.Tensor):
    """`medoid_sweep` on a shard of the matrix: (F_pad, N_local) f32 or bf16, the
    query's features q (F_pad,) f32, its local column `idx` or -1 where
    another rank holds it, (N_local,) weights -> (d (N_local,), hist (60,),
    density, n_close) over the shard's columns, summed in the order of that
    width. Given column idx's own features it equals `medoid_sweep` bit for
    bit. Launches the medoid kernel for a CUDA tensor (counted in
    `medoid_sweep_shard.launches`), runs the plain version for a CPU
    tensor."""
    _check_shard_matrix(matrixT)
    f_pad, n_pad = matrixT.shape
    idx = int(idx)
    if not -1 <= idx < n_pad:
        raise IndexError(f"idx {idx} outside [-1, {n_pad})")
    if wts.shape != (n_pad,) or wts.dtype != torch.float32:
        raise ValueError("wts must be a float32 tensor of shape (N_local,)")
    _check_query(q, (f_pad,), matrixT.device)
    if matrixT.device.type == "cpu":
        return medoid_sweep_shard_plain(matrixT, q, idx, wts)
    return _medoid_launch(medoid_sweep_shard, matrixT, idx, q, wts)


medoid_sweep_shard.launches = 0
medoid_sweep_shard.launches_by_width = {}  # N_local -> launches
medoid_sweep_shard.launches_by_fpad = {}  # F_pad -> launches
medoid_sweep_shard.launches_by_dtype = {}  # the matrix's type -> launches

# ------------------------------------------------------ spec_sweep, row_stats

_batch_ws: dict = {}


def _batch_workspace(dev: torch.device, stream: int):
    """The batch kernels' per-stream (8, 64, 128) partial sums (row, sum,
    CTA), (8, 128, 2) count partials and 8 int32 tickets (`row_stats`
    draws one a row, `spec_sweep` the first; each last CTA resets its
    own)."""
    key = (dev.index, stream)
    ws = _batch_ws.get(key)
    if ws is None:
        ws = (torch.zeros((_SPEC_SEEDS, _SWEEP_SLOTS, _SWEEP_MAX_BLOCKS), dtype=torch.float32,
                          device=dev),
              torch.zeros((_SPEC_SEEDS, _SWEEP_MAX_BLOCKS, 2), dtype=torch.int32, device=dev),
              torch.zeros(_SPEC_SEEDS, dtype=torch.int32, device=dev))
        _batch_ws[key] = ws
    return ws


def _batch_outputs(s: int, dev):
    "The (S, 61) sums (histogram, density) and (S, 2) counts (close, near) a batch kernel writes."
    return (torch.empty((s, _NBINS + 1), dtype=torch.float32, device=dev),
            torch.empty((s, 2), dtype=torch.int32, device=dev))


def _check_wts(wts: torch.Tensor, n_pad: int, dev) -> None:
    if wts.shape != (n_pad,) or wts.dtype != torch.float32:
        raise ValueError("wts must be a float32 tensor of shape (N_pad,)")
    if wts.device != dev:
        raise ValueError(f"wts must lie on {dev}, not {wts.device}")


def spec_sweep(matrixT: torch.Tensor, cols, wts: torch.Tensor):
    """The distance rows of S <= 8 columns and their sums in one pass over
    the matrix: (F_pad, N_pad) f32 or bf16, `cols` S column ids (ints; repeats
    allowed), (N_pad,) f32 weights (lengths where kept, else 0) -> (rows
    (S, N_pad) with rows[s, cols[s]] = 0, hist (S, 60), density (S,),
    n_close (S,) int32 over d < 0.05, n_near (S,) int32 over d <= 0.05).
    Row s and its sums equal `medoid_sweep(matrixT, cols[s], wts)` bit for
    bit. Launches the CUDA kernel of the matrix's type for a CUDA tensor
    (one launch, counted in `spec_sweep.launches`), runs the plain version
    for a CPU tensor."""
    _check_matrix(matrixT, bf16=True)
    f_pad, n_pad = matrixT.shape
    cols = [int(c) for c in cols]
    if not 1 <= len(cols) <= _SPEC_SEEDS:
        raise ValueError(f"need 1 to {_SPEC_SEEDS} columns, got {len(cols)}")
    if not all(0 <= c < n_pad for c in cols):
        raise IndexError(f"a column of {cols} lies outside [0, {n_pad})")
    _check_wts(wts, n_pad, matrixT.device)
    if matrixT.device.type == "cpu":
        return spec_sweep_plain(matrixT, cols, wts)
    return _spec_launch(spec_sweep, matrixT, cols, None, wts)


def _spec_launch(kernel, matrixT, cols: list, q, wts):
    """One launch of `spec_sweep`'s kernel (`kernel`: its wrapper, whose
    count it adds to): the S queries' features from columns `cols` or,
    given `q`, from q (the shard entry point)."""
    f_pad, n_pad = matrixT.shape
    if matrixT.device.type != "cuda":
        raise ValueError(f"{kernel.__name__} runs on cuda or cpu, not {matrixT.device}")
    lib = _load()
    dev = matrixT.device
    s = len(cols)
    wts = wts.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, count_partials, ticket = _batch_workspace(dev, stream)
    rows = torch.empty((s, n_pad), dtype=torch.float32, device=dev)
    sums, counts = _batch_outputs(s, dev)
    tail = (*cols, *[0] * (_SPEC_SEEDS - s), s, wts.data_ptr(), rows.data_ptr(),
            partials.data_ptr(), count_partials.data_ptr(), ticket.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), stream)
    if q is None:
        err = _launcher(lib, "vt_spec_sweep", matrixT)(matrixT.data_ptr(), f_pad, n_pad, *tail)
    else:
        err = _launcher(lib, "vt_spec_sweep_shard", matrixT)(matrixT.data_ptr(), f_pad, n_pad,
                                                              q.data_ptr(), *tail)
    _raise_on(err, kernel.__name__)
    _count(kernel, n_pad, matrixT)
    return rows, sums[:, :_NBINS], sums[:, _NBINS], counts[:, 0], counts[:, 1]


spec_sweep.launches = 0
spec_sweep.launches_by_width = {}  # N_pad -> launches
spec_sweep.launches_by_fpad = {}  # F_pad -> launches
spec_sweep.launches_by_dtype = {}  # the matrix's type -> launches


def spec_sweep_shard(matrixT: torch.Tensor, q: torch.Tensor, cols, wts: torch.Tensor):
    """`spec_sweep` on a shard of the matrix: (F_pad, N_local) f32 or bf16, the S <=
    8 queries' features q (F_pad, S) f32, each one's local column in `cols`
    or -1 where another rank holds it, (N_local,) weights -> (rows (S,
    N_local), hist (S, 60), density (S,), n_close (S,), n_near (S,)) over the
    shard's columns, summed in the order of that width. Given the columns'
    own features it equals `spec_sweep` bit for bit. Launches its kernel for
    a CUDA tensor (counted in `spec_sweep_shard.launches`), runs the plain
    version for a CPU tensor."""
    _check_shard_matrix(matrixT)
    f_pad, n_pad = matrixT.shape
    cols = [int(c) for c in cols]
    if not 1 <= len(cols) <= _SPEC_SEEDS:
        raise ValueError(f"need 1 to {_SPEC_SEEDS} columns, got {len(cols)}")
    if not all(-1 <= c < n_pad for c in cols):
        raise IndexError(f"a column of {cols} lies outside [-1, {n_pad})")
    _check_wts(wts, n_pad, matrixT.device)
    _check_query(q, (f_pad, len(cols)), matrixT.device)
    if matrixT.device.type == "cpu":
        return spec_sweep_shard_plain(matrixT, q, cols, wts)
    return _spec_launch(spec_sweep_shard, matrixT, cols, q, wts)


spec_sweep_shard.launches = 0
spec_sweep_shard.launches_by_width = {}  # N_local -> launches
spec_sweep_shard.launches_by_fpad = {}  # F_pad -> launches
spec_sweep_shard.launches_by_dtype = {}  # the matrix's type -> launches


def row_stats(rows: torch.Tensor, wts: torch.Tensor):
    """The sums `medoid_sweep` takes of a row, for S <= 8 given rows: (S,
    N_pad) f32 (contiguous), (N_pad,) f32 weights -> (hist (S, 60),
    density (S,), n_close (S,) int32 over d < 0.05, n_near (S,) int32 over
    d <= 0.05, each over the columns with weight > 0), bit for bit what
    `medoid_sweep` returns for a column whose row is rows[s]. Launches the
    CUDA kernel for a CUDA tensor (one launch, counted in
    `row_stats.launches`), runs the plain version for a CPU tensor."""
    if rows.dtype != torch.float32 or rows.dim() != 2 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous (S, N_pad) float32 tensor")
    s, n_pad = rows.shape
    if not 1 <= s <= _SPEC_SEEDS:
        raise ValueError(f"need 1 to {_SPEC_SEEDS} rows, got {s}")
    _check_wts(wts, n_pad, rows.device)
    if rows.device.type == "cpu":
        return row_stats_plain(rows, wts)
    if rows.device.type != "cuda":
        raise ValueError(f"row_stats runs on cuda or cpu, not {rows.device}")
    lib = _load()
    dev = rows.device
    wts = wts.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, count_partials, ticket = _batch_workspace(dev, stream)
    sums, counts = _batch_outputs(s, dev)
    err = lib.vt_row_stats(rows.data_ptr(), n_pad, s, wts.data_ptr(), partials.data_ptr(),
                           count_partials.data_ptr(), ticket.data_ptr(), sums.data_ptr(),
                           counts.data_ptr(), stream)
    _raise_on(err, "row_stats")
    _count(row_stats, n_pad)
    return sums[:, :_NBINS], sums[:, _NBINS], counts[:, 0], counts[:, 1]


row_stats.launches = 0
row_stats.launches_by_width = {}  # N_pad -> launches
row_stats.launches_by_fpad = {}  # reads no matrix: stays empty
row_stats.launches_by_dtype = {}  # reads no matrix: stays empty

# ----------------------------------------------- gumbel_topc, gumbel_scores


def gumbel_scores_plain(key, d: torch.Tensor, kept: torch.Tensor, tried: torch.Tensor,
                        medoid: int, offset: int = 0) -> torch.Tensor:
    """Plain version of `gumbel_scores`: `vamb_tpu`'s expression with jax's
    threefry uniform and XLA's CPU log (`threefry.log_xla`), bit for bit.
    With `offset` the columns are a shard's, global columns offset.. of the
    stream, and `medoid` is a global column."""
    n = d.shape[0]
    u = threefry.uniform(key, n, d.device, start=offset)
    g = -threefry.log_xla(-threefry.log_xla(u + 1e-20) + 1e-20)
    elig = (d <= _MEDOID_RADIUS) & kept & ~tried
    if 0 <= medoid - offset < n:
        elig[medoid - offset] = False
    return torch.where(elig, g, -torch.inf)


# the high word of -inf's key: a key above it is an eligible column's
_NEG_INF_HIGH = -2139095041


def topc_keys(score: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The kernel's selection key as one int64 a column: the score's bits in
    XLA's TopK integer order (-inf lowest, -0.0 below +0.0) above the
    inverted index (the global index `offset + i` for a shard's column i),
    so keys are unique and their descending order is `jax.lax.top_k`'s:
    score descending, index ascending on equal scores."""
    s = score.view(torch.int32)
    s = torch.where(s < 0, s ^ 0x7FFFFFFF, s).to(torch.int64)
    idx = torch.arange(score.shape[0], dtype=torch.int64, device=score.device) + offset
    return s * (1 << 32) + (0xFFFFFFFF - idx)


def topc_merge(keys: torch.Tensor, c: int):
    """The C largest of the ranks' `gumbel_topc_shard` keys (any shape):
    the global candidates in `jax.lax.top_k`'s order as int64 column ids,
    and whether each is eligible. The keys are unique and totally ordered,
    so the top C of the ranks' top C are the top C over the global width,
    the lowest-index ineligible columns where fewer than C are eligible."""
    top = torch.topk(keys.reshape(-1), c).values
    return 0xFFFFFFFF - (top & 0xFFFFFFFF), (top >> 32) > _NEG_INF_HIGH


def gumbel_topc_plain(key, d: torch.Tensor, kept: torch.Tensor, tried: torch.Tensor,
                      medoid: int, c: int, with_scores: bool = False):
    """Plain version of `gumbel_topc`: `gumbel_scores_plain`'s scores, then
    `torch.topk` of their unique `topc_keys`, which takes `jax.lax.top_k`'s
    indices in its order, ties and -inf slots included."""
    score = gumbel_scores_plain(key, d, kept, tried, medoid)
    cand = torch.topk(topc_keys(score), c).indices
    valid = score[cand] > -torch.inf
    return (cand, valid, score) if with_scores else (cand, valid)


def _check_step(d, kept, tried, medoid: int) -> None:
    n = d.shape[0]
    if d.dim() != 1 or d.dtype != torch.float32:
        raise ValueError("d must be a 1-D float32 tensor")
    if any(v.shape != (n,) or v.dtype != torch.bool for v in (kept, tried)):
        raise ValueError("kept and tried must be bool tensors of d's shape")
    if not 0 <= medoid < n:
        raise IndexError(f"medoid {medoid} outside [0, {n})")
    if d.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the Gumbel kernel runs on cuda or cpu, not {d.device}")
    if kept.device != d.device or tried.device != d.device:
        raise ValueError("d, kept and tried must be on one device")


_topc_ws: dict = {}


def _topc_workspace(dev: torch.device, stream: int):
    """gumbel_topc's per-stream (SMs, 32) partial key lists (int64 storage of
    the kernel's uint64 keys) and int32 ticket (zeroed once; the last CTA
    resets it), and the SM count (the most CTAs)."""
    key = (dev.index, stream)
    ws = _topc_ws.get(key)
    if ws is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        ws = (torch.empty((sms, 32), dtype=torch.int64, device=dev),
              torch.zeros(1, dtype=torch.int32, device=dev), sms)
        _topc_ws[key] = ws
    return ws


def topc_launches(c: int) -> int:
    "The Gumbel kernel's launches for C candidates: rounds of 32."
    return max(1, -(-c // _CAND_GROUP))


def _gumbel_launch(k0: int, k1: int, d, kept, tried, medoid: int, c: int, score, cand, valid,
                   offset: int = 0, keys=None, name: str = "gumbel_topc"):
    """The Gumbel kernel's launches (`topc_launches(C)`, one C call): the C
    candidates (C > 0), their keys (which C > 32 needs: a round reads the
    last key of the round before) and/or the scores; a shard's columns are
    global columns offset.."""
    lib = _load()
    dev = d.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, ticket, sms = _topc_workspace(dev, stream)
    d, kept, tried = d.contiguous(), kept.contiguous(), tried.contiguous()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = lib.vt_gumbel_topc(k0, k1, d.shape[0], offset, d.data_ptr(), kept.data_ptr(),
                             tried.data_ptr(), medoid, c, ptr(score), partials.data_ptr(),
                             ticket.data_ptr(), ptr(cand), ptr(valid), ptr(keys), sms, stream)
    _raise_on(err, name if c else "gumbel_scores")


def gumbel_topc(key, d: torch.Tensor, kept: torch.Tensor, tried: torch.Tensor, medoid: int,
                c: int, with_scores: bool = False):
    """A wander step's draw and selection: the C candidates that
    `jax.lax.top_k(score, C)` takes from `gumbel_scores`' scores (score
    descending, index ascending on equal scores; where fewer than C columns
    are eligible, the rest are the lowest-index ineligible columns,
    ascending) as int64 column ids, and whether each is eligible (its score
    > -inf). With `with_scores`, the (n,) scores too.

    `key` is a threefry key (two uint32 words), d (n,) f32, kept and tried
    (n,) bool, 1 <= C <= n. Launches the CUDA kernel for CUDA tensors (one
    launch for C <= 32, else `topc_launches(C)` rounds, counted in
    `gumbel_topc.launches`; the scores reach device memory only with
    `with_scores`), runs the plain version for CPU tensors; both give
    `vamb_tpu`'s candidates."""
    medoid, c, n = int(medoid), int(c), d.shape[0]
    _check_step(d, kept, tried, medoid)
    if not 1 <= c <= n:
        raise ValueError(f"C must lie in [1, {n}], not {c}")
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
    if d.device.type == "cpu":
        return gumbel_topc_plain((k0, k1), d, kept, tried, medoid, c, with_scores)
    cand = torch.empty(c, dtype=torch.int64, device=d.device)
    valid = torch.empty(c, dtype=torch.bool, device=d.device)
    score = torch.empty(n, dtype=torch.float32, device=d.device) if with_scores else None
    keys = torch.empty(c, dtype=torch.int64, device=d.device) if c > _CAND_GROUP else None
    _gumbel_launch(k0, k1, d, kept, tried, medoid, c, score, cand, valid, keys=keys)
    _count(gumbel_topc, n, launches=topc_launches(c))
    return (cand, valid, score) if with_scores else (cand, valid)


gumbel_topc.launches = 0
gumbel_topc.launches_by_width = {}  # n -> launches
gumbel_topc.launches_by_fpad = {}  # no matrix: stays empty
gumbel_topc.launches_by_dtype = {}  # no matrix: stays empty


def gumbel_topc_shard_plain(key, d, kept, tried, medoid: int, c: int, offset: int):
    """Plain version of `gumbel_topc_shard`: the shard's scores over its
    slice of the stream (`gumbel_scores_plain` with `offset`), then the C
    largest of their global `topc_keys`, descending."""
    score = gumbel_scores_plain(key, d, kept, tried, medoid, offset)
    return torch.topk(topc_keys(score, offset), c).values


def gumbel_topc_shard(key, d: torch.Tensor, kept: torch.Tensor, tried: torch.Tensor, medoid: int,
                      c: int, n_global: int, offset: int) -> torch.Tensor:
    """A wander step's draw and selection on a shard: its n columns are the
    global columns [offset, offset + n) of a step over `n_global` columns,
    each drawing its own uniform of the threefry stream (the stream's
    counter is the global index), and `medoid` is a global column. Returns
    the shard's C largest selection keys (C,) int64, descending, in
    `topc_keys`' order over global indices: `topc_merge` of every rank's
    keys gives `gumbel_topc`'s candidates over the global width, bit for
    bit. Launches the Gumbel kernel for CUDA tensors (`topc_launches(C)`
    launches, counted in `gumbel_topc_shard.launches`), runs the plain
    version for CPU tensors."""
    medoid, c, n, offset = int(medoid), int(c), d.shape[0], int(offset)
    if not (0 <= offset and offset + n <= n_global):
        raise ValueError(f"the shard [{offset}, {offset + n}) lies outside [0, {n_global})")
    if not 0 <= medoid < n_global:
        raise IndexError(f"medoid {medoid} outside [0, {n_global})")
    _check_step(d, kept, tried, 0)
    if not 1 <= c <= n:
        raise ValueError(f"C must lie in [1, {n}], not {c}")
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
    if d.device.type == "cpu":
        return gumbel_topc_shard_plain((k0, k1), d, kept, tried, medoid, c, offset)
    cand = torch.empty(c, dtype=torch.int64, device=d.device)
    valid = torch.empty(c, dtype=torch.bool, device=d.device)
    keys = torch.empty(c, dtype=torch.int64, device=d.device)
    _gumbel_launch(k0, k1, d, kept, tried, medoid, c, None, cand, valid, offset, keys,
                   "gumbel_topc_shard")
    _count(gumbel_topc_shard, n, launches=topc_launches(c))
    return keys


gumbel_topc_shard.launches = 0
gumbel_topc_shard.launches_by_width = {}  # N_local -> launches
gumbel_topc_shard.launches_by_fpad = {}  # no matrix: stays empty
gumbel_topc_shard.launches_by_dtype = {}  # no matrix: stays empty


def gumbel_scores(key, d: torch.Tensor, kept: torch.Tensor, tried: torch.Tensor,
                  medoid: int) -> torch.Tensor:
    """A wander step's candidate scores: for each of the n columns the
    Gumbel score `-log(-log(u + 1e-20) + 1e-20)` of u =
    `jax.random.uniform(key, (n,))`, with XLA's CPU log, where the column is
    eligible ((d <= 0.05) & kept & ~tried, not `medoid`), else -inf.

    `key` is a threefry key (two uint32 words), d (n,) f32, kept and tried
    (n,) bool. Launches `gumbel_topc`'s kernel with no selection for CUDA
    tensors (one launch, counted in `gumbel_scores.launches`), runs the
    plain version for CPU tensors; both give `vamb_tpu`'s bits."""
    medoid = int(medoid)
    _check_step(d, kept, tried, medoid)
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
    if d.device.type == "cpu":
        return gumbel_scores_plain((k0, k1), d, kept, tried, medoid)
    score = torch.empty(d.shape[0], dtype=torch.float32, device=d.device)
    _gumbel_launch(k0, k1, d, kept, tried, medoid, 0, score, None, None)
    _count(gumbel_scores, d.shape[0])
    return score


gumbel_scores.launches = 0
gumbel_scores.launches_by_width = {}  # n -> launches
gumbel_scores.launches_by_fpad = {}  # no matrix: stays empty
gumbel_scores.launches_by_dtype = {}  # no matrix: stays empty

KERNELS = (row_sweep, candidate_density_sweep, gather_blocks, medoid_sweep, gumbel_topc,
           gumbel_scores, spec_sweep, row_stats, medoid_sweep_shard, spec_sweep_shard,
           candidate_density_shard, gumbel_topc_shard, gather_ball_shard)


def reset_launch_counts() -> None:
    for kernel in KERNELS:
        kernel.launches = 0
        kernel.launches_by_width = {}
        kernel.launches_by_fpad = {}
        kernel.launches_by_dtype = {}

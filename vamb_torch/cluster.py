"""Iterative medoid clustering of L2-normalized latents, on one GPU.

Behavioral spec: `vamb_tpu/cluster.py` (itself the reference's GPU
`kept_mask` variant, vamb/cluster.py:174-177). Constants and decision
rules are identical:

* normalization: zero rows -> uniform, divide by row norm * sqrt(2) so
  cosine distance = 0.5 - x.y lies in [0, 1];
* seeds tried in descending contig-length order, cyclically;
* medoid wandering: first-improvement hill climb on length-weighted local
  density within radius 0.05, <= 25 sampled untried candidates per step;
* threshold: length-weighted 60-bin histogram of distances <= 0.3,
  smoothed with a 31-tap N(0, 0.01) kernel, first-peak/valley scan with
  the adaptive peak-valley-ratio acceptance rules;
* pvr feedback: starts 0.1, +0.1 whenever < 15 of the last 300 attempts
  were accepted; radius-0.06 fallback once pvr > 0.55.

Structure. `vamb_tpu` fuses K clusters into one `lax.while_loop`. Here the
host drives the attempts, transcribing the sequential control flow of
`tests/oracle_cluster.SequentialOracle` (proven emission-identical to that
engine by tests/test_parity_cluster.py), and the numeric steps run on the
device: each new medoid's row with its histogram, density and close
count in one sweep (`kernels.medoid_sweep`; the seeds' rows come from the
seed cache below), the per-step Gumbel
scores over the threefry stream and their top C in one launch
(`kernels.gumbel_topc`: XLA's CPU log and `jax.lax.top_k`'s order on
ties, so bit for bit `vamb_tpu`'s candidates), candidate densities
(`kernels.candidate_density_sweep`), the subset wander's ball and its
per-slot vectors in one gather (`kernels.gather_ball`), rows inside the
ball (`kernels.row_sweep`), the banded smoothing product and the valley
scan. The attempt's sums (histogram, close count, the seed's density) come
from `medoid_sweep` (or `spec_sweep` / `row_stats`, which share its code)
in an order fixed by the width, which the plain versions reproduce, and
the smoothing sums in XLA's CPU order, so the engine
decides alike on the card and on the CPU. That
kernel counts a column as kept where its weight is > 0, so contig lengths
must be positive, as they are.

It reproduces `vamb_tpu`'s `ClusterGenerator` run with
`compact_async=False`, scope and compaction included:

* wander scope: "full" climbs over all columns (cluster.py:765-858);
  "subset" climbs first inside the seed's gathered radius-0.15 ball of
  128-column blocks and falls back to the full climb on ball overflow or
  drift (cluster.py:555-748, 860-935); "auto" is subset while the live
  padded width is >= `_SUBSET_AUTO_MIN`, re-decided after each compaction;
* the compaction ladder: clusters come in batches of `batch_clusters`,
  and after batch i the surviving columns are gathered into half the live
  padded width if the survivors after batch i-1 already fit it (the one
  batch of lag of `vamb_tpu`'s pipelined dispatch, cluster.py:2257-2309).
  `vamb_tpu`'s `compact_async=True` makes that timing depend on a compile
  thread; the port has no compile step, so it has no counterpart.

Seeds come from the speculative seed cache (cluster.py:1047-1095): the
next `_SPEC_SEEDS` seeds of the cycling scan and their rows and sums from
one `kernels.spec_sweep`, each row bit for bit `medoid_sweep`'s, so a
cached row and a fresh sweep cannot be told apart; the first alive slot at
or after `spec_next` is the seed, and after a removal the cached rows'
sums follow the kept mask through one `kernels.row_stats`. A seed with no
other kept point within 0.05 is a loner and emits with no wander and no
threshold, and the cached seeds after it that are loners too emit in the
same iteration (loner bursts, :1114-1260: one flags pass and one refill
per `_SPEC_SEEDS` loners, the key split once per loner). Where the subset
wander runs, attempt lanes (:1333-1640, `attempt_batch`) follow the exact
attempt: the remaining alive cached seeds climb phase 1 one after another
against the frozen state, with the chain's next keys, their final rows
come from one `spec_sweep` and their thresholds from one batched scan,
their decisions reach the host in one sync, and the sequential acceptance
scan admits lanes by `vamb_tpu`'s conditions (a cut lane consumes no key
and reruns as an exact attempt; the lanes after one that needs the full
climb are not climbed; a loner lane's conflict region is its row within
0.3 and its ball's blocks, as `vamb_tpu` builds it). None of this changes
a decision (oracle_cluster.py:301-305): the port emits what `vamb_tpu`
emits under each setting, and groups the attempts into lanes as it does,
so the effective work count agrees too. Subset-wander attempts
take the final row from `medoid_sweep` (`row_sweep`'s arithmetic), not
from `vamb_tpu`'s batched einsum: distances that differ in the last ulp,
the divergence class the full path already has.

Random stream. Columns are padded to a multiple of 128 on every device
and the candidate Gumbel draws span the padded width (or the ball), with
one key split per attempt and one split + one uniform per wander step,
from jax's threefry stream (utils/threefry.py) — so given a latent the port
draws exactly the candidates `vamb_tpu` draws on the CPU.

Row-sharded engine (`mesh=`, cluster.py:1771-1943 and :2210-2230 of
`vamb_tpu`'s mesh engine, every scope and precision). Columns are padded to a multiple
of 128 x W on a mesh of W ranks, as `vamb_tpu` pads them (`col_tile`), so
the Gumbel draws span the width `vamb_tpu`'s mesh engine draws over, and
the compaction ladder steps in those units. Rank r holds columns [r N_pad /
W, (r + 1) N_pad / W) of the matrix, the weights and the kept mask on its
card (`P(None, axis)`); the host keeps the whole kept mask and the seed
ranks, which every rank updates alike from the emitted members, so the seed
scan needs no collective. Every rank runs the same control flow, and an
attempt moves only small payloads between ranks (`parallel.Mesh`'s
collectives, tallied in its `traffic`): the query columns' features (from
their owners), each rank's sums (the histogram, densities, close and near
counts, added in rank order), the wander step's top C keys of each shard
(merged into `jax.lax.top_k`'s order over the global width) and the emitted
members. The kernels run as their shard entry points
(`medoid_sweep_shard`, `spec_sweep_shard`, `candidate_density_shard`,
`gumbel_topc_shard`, `gather_ball_shard`; `row_stats` as it is).
Compaction rebuilds each rank's block from the host's copy of the engine
matrix, so it moves no matrix between ranks. The subset wander's ball
(`vamb_tpu` replicates it with one-hot block matmuls, cluster.py:607-643):
a rank's shard is whole 128-column blocks, so its flagged blocks take a
contiguous run of the ball's slots after those of the ranks before it; one
small integer gather gives every rank the flagged blocks' count and ids and
the seed's slot, one gather of each rank's blocks with their per-slot
vectors (`gather_ball_shard`, kind "ball", W x Q x (F_pad + 3) floats)
assembles the ball, the gathered slots bit for bit `gather_ball`'s, and
the climb inside it runs replicated on every rank with no collective.
Attempt lanes take their rows from the shards, add their members' and
conflicts' counts over the ranks exactly (integers) in the gather that
carries their decisions, and gather the emitted lanes' members in rank
order. A bfloat16 engine keeps bf16 shards; a query's features are its
owner's columns widened to float32 (exact). At W = 1 the engine gives the
unsharded engine's sums and emission bit for bit; at W > 1 each sum is the
rank-order sum of the shards' sums, which differs from the one-device
order in the last ulp (the class of "Distances are not XLA's"), and its
emission is `vamb_tpu`'s mesh engine's.

The kernels (`wander_kernel`, `vamb_tpu`'s switch of the Pallas kernels
and the XLA expressions, cluster.py:1839-1870). "auto" and "pallas" call
the CUDA kernels' wrappers, which launch the kernels on the card and run
their plain versions on the CPU; "pallas" also requires what `vamb_tpu`'s
does (a CUDA device for its TPU, no mesh, float32 distances, `maxsteps` <=
32) and raises ValueError with the same list of problems otherwise, so a
call fails in both packages or in neither. "xla" calls the plain versions
themselves on the engine's device, the card included, so the engine
launches no hand-written kernel: the kernels and their plain versions agree
bit for bit, and so the emission is the same under all three. The choice
is made once, at construction (`_wander_kernels`). `maxsteps` takes any
value: C = min(maxsteps, N_pad) candidates a step, which `gumbel_topc`
selects in rounds of 32 and the density kernel sums in one launch.

bfloat16 distances (`distance_dtype="bfloat16"`, `vamb_tpu`'s opt-in
reduced-precision mode, cluster.py:1836-1943): the engine order is taken
from the float32 normalized matrix, which is then stored as bfloat16 (round
to nearest even, as `astype(jnp.bfloat16)`), half the bytes every sweep
reads. `vamb_tpu` accumulates its bf16 products in float32, and a bf16 x
bf16 product is exact in float32, so its bf16 engine is its float32 engine
on the rounded matrix; the port's is too: `medoid_sweep`, `spec_sweep` and
`candidate_density_sweep` read the bf16 matrix and run their float32
arithmetic on the widened values. As in `vamb_tpu` the mode never takes the
subset wander ("auto" picks full sweeps; "subset" raises ValueError, :1880),
so it runs no attempt lanes ("on" raises) and never `row_sweep` or the
gather.
"""

from collections import deque
from math import ceil
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import kernels as K
from .device import resolve_device
from .kernels import topc_merge
from .log import logger
from .utils import threefry

_DEFAULT_RADIUS = 0.06
_MEDOID_RADIUS = 0.05
_DELTA_X = 0.005
_XMAX = 0.3
_NBINS = ceil(_XMAX / _DELTA_X)  # 60

# PDF of N(0, 0.01) sampled at _DELTA_X intervals over [-0.075, 0.075],
# scaled by _DELTA_X (31 taps; reference cluster.py:39-73).
_PDF_X = np.arange(-15, 16) * _DELTA_X
_NORMALPDF = (
    _DELTA_X / (0.01 * np.sqrt(2 * np.pi)) * np.exp(-0.5 * (_PDF_X / 0.01) ** 2)
).astype(np.float32)

# Histogram smoothing: the (60,)x(60,60) product with the banded Toeplitz
# matrix of the 31-tap kernel (vamb_tpu/cluster.py:107-131), summed in the
# order of XLA's CPU code for it (its row-major GEMV emitter, 8x8 tiles, as
# the object code shows). Output j adds hist[k] * M[k, j] for k < 56 in 8
# lanes (lane l takes k = l, l + 8, ..., l + 48, each step one FMA) and
# k = 56..59 in a ninth FMA chain; then the lanes fold as
# ((x0+x1)+(x2+x3))+((x4+x5)+(x6+x7)) for j < 56 and, in the emitter's
# 4-row tail tile, ((x0+x4)+(x2+x6))+((x1+x5)+(x3+x7)); the ninth chain is
# added last. `_SMOOTH_W[t]` holds step t's weights for the 9 chains.
_SMOOTH_MATRIX = np.zeros((_NBINS, _NBINS), np.float32)
for _i in range(_NBINS):
    for _j in range(_NBINS):
        if abs(_j - _i) <= 15:
            _SMOOTH_MATRIX[_i, _j] = _NORMALPDF[_j - _i + 15]
del _i, _j
_SMOOTH_LANES, _SMOOTH_STEPS, _SMOOTH_TAIL = 8, 7, 56
_SMOOTH_W = np.zeros((_SMOOTH_STEPS, _NBINS, _SMOOTH_LANES + 1), np.float32)
_SMOOTH_W[:, :, :_SMOOTH_LANES] = _SMOOTH_MATRIX[:_SMOOTH_TAIL].reshape(
    _SMOOTH_STEPS, _SMOOTH_LANES, _NBINS).transpose(0, 2, 1)
_SMOOTH_W[: _NBINS - _SMOOTH_TAIL, :, _SMOOTH_LANES] = _SMOOTH_MATRIX[_SMOOTH_TAIL:]

# The valley scan's x grid, replicating the reference's float64 accumulation
# `x += XMAX / len(histogram)` (vamb_tpu/cluster.py:134-141): the `x > 0.1`
# dead-check sits exactly on a last-ulp boundary at bin 20.
_X_GRID = np.concatenate(
    [[0.0], np.add.accumulate(np.full(_NBINS - 1, _XMAX / _NBINS))]
)
_X_GT_01 = _X_GRID > 0.1

_LANES = 128
_SUBLANES = 8
# Seed-rank sentinel, as in vamb_tpu: padding columns get distinct ranks
# >= RANK_PAD_BASE (never kept, so never a seed).
RANK_PAD_BASE = 1 << 29

# The subset wander's constants (vamb_tpu/cluster.py:417-427). Read at call
# time, so a test can patch them on both packages alike.
_SUBSET_BLOCK = 128  # ball gathers move whole 128-column blocks
_SUBSET_Q = 1 << 13  # most columns a ball may hold
_SUBSET_RADIUS = 0.15
_SUBSET_ABORT = _SUBSET_RADIUS - 2 * _MEDOID_RADIUS  # drift boundary
_SUBSET_AUTO_MIN = 1 << 18  # auto scope: subset at this live padded width and above
_DEFAULT_BATCH = 1024  # clusters per batch, the compaction ladder's clock
_SPEC_SEEDS = 8  # the seed cache's slots (vamb_tpu/cluster.py:160)


class Cluster:
    "One emitted cluster; indices refer to rows of the input matrix."

    __slots__ = [
        "medoid",
        "seed",
        "members",
        "maximal_pvr",
        "observed_pvr",
        "radius",
        "successes",
        "attempts",
    ]

    def __init__(
        self,
        medoid: int,
        seed: int,
        members: np.ndarray,
        maximal_pvr: float,
        observed_pvr: Optional[float],
        radius: Optional[float],
        successes: int,
        attempts: int,
    ):
        self.medoid = medoid
        self.seed = seed
        self.members = members
        self.maximal_pvr = maximal_pvr
        self.observed_pvr = observed_pvr
        self.radius = radius
        self.successes = successes
        self.attempts = attempts

    @property
    def kind_str(self) -> str:
        if self.observed_pvr is not None:
            return "normal"
        return "loner" if self.radius is None else "fallback"

    def as_tuple(self) -> tuple[int, np.ndarray]:
        return (self.medoid, self.members)


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def engine_order(
    matrix: np.ndarray, lengths: np.ndarray, rng_seed: int
) -> tuple[np.ndarray, np.ndarray]:
    """Geometry-local engine column order + per-column seed ranks (host
    numpy copy of vamb_tpu/cluster.py:228-260).

    Columns are sorted by the sign pattern of 16 seeded random projections;
    `ranks[i]` is column i's position in the stable descending-length
    order, which the seed scan follows. Returns (order, ranks): `order`
    maps engine column -> original row. `matrix` must be normalized.
    """
    n = len(matrix)
    by_len = np.argsort(lengths.astype(np.float32), kind="stable")[::-1]
    rank_of_original = np.empty(n, np.int64)
    rank_of_original[by_len] = np.arange(n)
    rng = np.random.default_rng(rng_seed)
    proj = matrix @ rng.standard_normal((matrix.shape[1], 16)).astype(np.float32)
    code = np.zeros(n, np.uint32)
    for k in range(16):
        code = (code << np.uint32(1)) | (proj[:, k] > 0)
    order = np.argsort(code, kind="stable")
    ranks = rank_of_original[order].astype(np.int32)
    return order, ranks


def normalize(matrix: np.ndarray, inplace: bool = False) -> np.ndarray:
    """Prepare latents for cosine distance: dist = 0.5 - x.y in [0, 1].

    All-zero rows are replaced by the uniform vector first (reference
    cluster.py:653-669).
    """
    if not inplace:
        matrix = matrix.copy()
    zero_rows = (matrix == 0).all(axis=1)
    matrix[zero_rows] = 1 / matrix.shape[1]
    norms = np.linalg.norm(matrix, axis=1, keepdims=True) * np.sqrt(2)
    matrix /= norms
    return matrix


def smooth_histogram(hist: torch.Tensor) -> torch.Tensor:
    """The banded-matrix smoothing of the 60-bin histogram (..., 60) in XLA's
    CPU order (`_SMOOTH_W`): elementwise ops, each FMA rounded once by
    `threefry._fma`, so the card, the CPU and `vamb_tpu` give the same bits."""
    lead = hist.shape[:-1]
    tail = torch.nn.functional.pad(hist[..., _SMOOTH_TAIL:], (0, _SMOOTH_STEPS - _NBINS + _SMOOTH_TAIL))
    h = torch.cat([hist[..., :_SMOOTH_TAIL].reshape(*lead, _SMOOTH_STEPS, _SMOOTH_LANES),
                   tail[..., None]], -1)  # (..., step, chain)
    w = torch.as_tensor(_SMOOTH_W, device=hist.device)
    acc = torch.zeros((*lead, _NBINS, _SMOOTH_LANES + 1), dtype=torch.float32, device=hist.device)
    for t in range(_SMOOTH_STEPS):
        acc = threefry._fma(h[..., t, None, :], w[t], acc)
    x = [acc[..., lane] for lane in range(_SMOOTH_LANES)]
    pairs = ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]))
    halves = ((x[0] + x[4]) + (x[2] + x[6])) + ((x[1] + x[5]) + (x[3] + x[7]))
    folded = torch.cat([pairs[..., :_SMOOTH_TAIL], halves[..., _SMOOTH_TAIL:]], -1)
    return folded + acc[..., _SMOOTH_LANES]


def find_threshold(hist: torch.Tensor, pvr: float):
    """Smoothed-histogram valley scan in closed form (transcribed from
    vamb_tpu/cluster.py:281-339, itself property-tested against the
    reference's sequential state machine), of one histogram (60,) or of a
    batch (..., 60) at once: every step is elementwise or an exact
    reduction along the bins, so a batch's rows are each row's own.

    Returns device tensors (threshold, observed_pvr, found) of the batch's
    shape; threshold < 0 means none was found."""
    dev = hist.device
    densities = smooth_histogram(hist)
    lead = densities.shape[:-1]
    xs = torch.as_tensor(_X_GRID.astype(np.float32), device=dev)
    x_gt_01 = torch.as_tensor(_X_GT_01, device=dev)
    i = torch.arange(_NBINS, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    pvr_t = torch.tensor(pvr, dtype=torch.float32, device=dev)

    def at(x, idx):  # x[..., idx] for a batch of indices
        return x.gather(-1, idx[..., None])[..., 0]

    # Running peak: until the peak is over, peak == cumulative max.
    run_max_incl = torch.cummax(densities, -1).values
    run_max_excl = torch.cat([torch.zeros((*lead, 1), device=dev), run_max_incl[..., :-1]], -1)

    # Peak is over at the first index with density < 60% of running max.
    po_mask = densities < 0.6 * run_max_incl
    po_exists = po_mask.any(-1)
    po_idx = torch.argmax(po_mask.to(torch.int32), -1)
    peak = at(run_max_incl, po_idx)
    po = po_idx[..., None]

    # Dead: still rising past x = 0.1 while the peak is not over.
    pre_po = torch.where(po_exists[..., None], i < po, True)
    rising = densities > run_max_excl
    dead = (rising & x_gt_01 & pre_po).any(-1)

    # After the peak: running minimum seeded with densities[po_idx].
    seeded = torch.where(i >= po, densities, inf)
    cummin_incl = torch.cummin(seeded, -1).values
    m_prev = torch.cat([inf.expand(*lead, 1), cummin_incl[..., :-1]], -1)
    after = i > po

    # A second peak (> 1.5x the minimum so far) stops the scan.
    brk = after & (densities > 1.5 * m_prev)
    brk_exists = brk.any(-1)
    brk_idx = torch.argmax(brk.to(torch.int32), -1)
    in_range = after & torch.where(brk_exists[..., None], i < brk_idx[..., None], True)

    # The threshold is the x of the last new minimum, i.e. the first index
    # attaining the final minimum.
    new_min = in_range & (densities < m_prev)
    range_min = torch.where(in_range, densities, inf).amin(-1)
    dam = torch.minimum(at(densities, po_idx), range_min)
    has_event = new_min.any(-1)
    thr_pos = torch.argmax((new_min & (densities == dam[..., None])).to(torch.int32), -1)
    thr = torch.where(
        po_exists & has_event & (dam < pvr_t * peak), xs[thr_pos], -1.0
    )
    found = (~dead) & (thr >= 0.0) & (thr <= 0.2 + pvr_t)
    observed_pvr = dam / torch.clamp_min(peak, 1e-30)
    return thr, observed_pvr, found


class ClusterGenerator:
    """Iterative medoid cluster generator. Iterate to get `Cluster`s.

    Inputs mirror `vamb_tpu.cluster.ClusterGenerator`:
        matrix: (obs x features) float32 latent matrix
        lengths: contig lengths (density/histogram weights)
        maxsteps: candidates sampled per medoid-wander step [25]
        windowsize: window length for success counting [300]
        minsuccesses: min successes per window before pvr bump [15]
        destroy: normalize `matrix` in place to save memory
        normalized: matrix is already normalized
        rng_seed: seed for the candidate-sampling RNG
        batch_clusters: clusters per batch, the compaction clock [1024]
        compact: shrink the matrix as points are clustered [True]
        compact_min_pad: never compact below this padded width [65536]
        wander_scope: "auto", "subset" or "full" (see the module notes)
        attempt_batch: "auto", "on" or "off": attempt lanes after each
            exact attempt; "auto" runs them wherever the subset wander
            runs, "on" requires the subset scope (else ValueError)
        device: "cuda" (default) or "cpu"
        mesh: a `parallel.Mesh` to row-shard the engine over (its device
            is the engine's), or None

    Under each setting it emits what `vamb_tpu`'s generator emits with
    `compact_async=False` on the CPU. `distance_dtype` is "float32" or
    "bfloat16" (full scope only; see the module notes); `wander_kernel`
    "auto", "pallas" (the CUDA kernels, where `vamb_tpu` would take its
    Pallas kernels; else ValueError) or "xla" (the kernels' plain versions
    on the engine's device). Each compaction is
    logged and recorded in `compactions` as (clusters emitted, old width,
    new width); `subset_counts` counts the exact attempts' subset wanders
    and how many fell back to the full climb because the ball overflowed
    or the medoid drifted; `lane_counts` counts the cache's refills, the
    loner bursts, the loners they emitted and the bursts the batch's
    capacity stopped, the lane passes, the lanes
    climbed and admitted, the lanes deferred, and the passes cut by each
    of the acceptance scan's reasons: (a) a conflict with an admitted
    lane's members, (b) a pvr bump, (c) a lane that needs the full climb,
    (d) the batch's capacity or no points left. A list in `sums_trace`
    receives each attempt's decision inputs (seed, medoid, histogram bytes,
    density, close count; a loner seed's near count), for comparisons.

    The work counters are `vamb_tpu`'s (cluster.py:2064-2093): `n_dists`,
    the distance evaluations made, and `n_dists_effective`, those the
    reference's sequential sampler would have made, both float32 sums of
    `vamb_tpu`'s terms added in its order (see `_Tally`): the effective
    count equals `vamb_tpu`'s value on the same latent and settings, and
    so does the raw one where no lane went unclimbed. `vamb_tpu` climbs the
    lanes after one that needs the full climb, which decide nothing; the
    port does not, and its raw count holds only the evaluations it makes.
    `emitted_total` is the clusters decided, those not yet returned
    included; `dist_terms` the exact sums of N over the terms where the two
    accounting families differ (full-scope wander steps, the subset
    wander's final rows) and the lanes not climbed. `drain()` waits for
    the engine's queued device work.
    """

    def __init__(
        self,
        matrix: np.ndarray,
        lengths: np.ndarray,
        maxsteps: int = 25,
        windowsize: int = 300,
        minsuccesses: int = 15,
        destroy: bool = False,
        normalized: bool = False,
        rng_seed: int = 0,
        device="cuda",
        batch_clusters: int = _DEFAULT_BATCH,
        distance_dtype: str = "float32",
        compact: bool = True,
        compact_min_pad: int = 1 << 16,
        wander_kernel: str = "auto",
        wander_scope: str = "auto",
        attempt_batch: str = "auto",
        mesh=None,
    ):
        if matrix.dtype != np.float32:
            raise ValueError("Matrix must be of dtype float32")
        if maxsteps < 1:
            raise ValueError(f"maxsteps must be a positive integer, not {maxsteps}")
        if windowsize < 1:
            raise ValueError(f"windowsize must be at least 1, not {windowsize}")
        if minsuccesses < 1 or minsuccesses > windowsize:
            raise ValueError(
                f"minsuccesses must be between 1 and windowsize, not {minsuccesses}"
            )
        if batch_clusters < 1:
            raise ValueError(f"batch_clusters must be at least 1, not {batch_clusters}")
        if len(matrix) < 1:
            raise ValueError("Matrix must have at least 1 observation.")
        if len(lengths) != len(matrix):
            raise ValueError("N sequences in lengths and matrix do not match")
        _check_values(distance_dtype, wander_kernel, wander_scope, attempt_batch)
        self._mesh = mesh
        self.device = resolve_device(device if mesh is None else mesh.device)
        bf16 = distance_dtype == "bfloat16"
        if wander_kernel == "pallas":  # vamb_tpu/cluster.py:1847-1862, the card for its TPU
            problems = []
            if self.device.type != "cuda":
                problems.append("requires a CUDA device")
            if mesh is not None:
                problems.append("does not support a sharded mesh")
            if bf16:
                problems.append("requires float32 distances")
            if maxsteps > 32:
                problems.append("requires maxsteps <= 32")
            if problems:
                raise ValueError("wander_kernel='pallas' " + "; ".join(problems))
        self._kernels = _wander_kernels(plain=wander_kernel == "xla")
        # the raw count's family: the hand-written kernels add `vamb_tpu`'s
        # "pallas" terms (cluster.py:842, :927-929), the plain versions its
        # "xla" terms; a mesh adds its mesh engine's, which are "xla"'s
        self._kernel_terms = (wander_kernel != "xla" and self.device.type == "cuda"
                              and mesh is None)
        if wander_scope == "subset" and bf16:  # vamb_tpu/cluster.py:1880-1881
            raise ValueError("wander_scope='subset' requires float32 distances")
        self._dtype = torch.bfloat16 if bf16 else torch.float32
        # vamb_tpu pads a mesh's columns to 128 x W (col_tile, :1882-1888)
        self._col_tile = _LANES * (1 if mesh is None else mesh.size)
        n_pad = _pad_to(len(matrix), self._col_tile)
        # vamb_tpu/cluster.py:1901-1920: lanes ride the subset wander, which
        # "auto" takes at float32 only
        self._use_subset = wander_scope == "subset" or (
            wander_scope == "auto" and not bf16 and n_pad >= _SUBSET_AUTO_MIN
        )
        if attempt_batch == "on" and not self._use_subset:
            raise ValueError(
                "attempt_batch='on' requires the subset wander path "
                "(wander_scope 'subset', or 'auto' above the size floor)"
            )
        self._attempt_batch = attempt_batch

        if mesh is not None and mesh.size > 1:
            # every rank clusters rank 0's latent: ranks that encoded it apart
            # could differ by an ulp, and their engine orders with it
            matrix, lengths = (mesh.broadcast(torch.as_tensor(np.asarray(a), device=self.device), 0,
                                              "inputs").cpu().numpy() for a in (matrix, lengths))
        if not normalized:
            matrix = normalize(matrix, inplace=destroy)

        n, f = matrix.shape
        f_pad = _pad_to(f, _SUBLANES)
        order, ranks_np = engine_order(matrix, lengths, rng_seed)
        padded_t = np.zeros((f_pad, n_pad), np.float32)
        padded_t[:f, :n] = matrix.T[:, order]
        ranks = np.arange(n_pad, dtype=np.int64) + RANK_PAD_BASE
        ranks[:n] = ranks_np
        kept = np.zeros(n_pad, bool)
        kept[:n] = True
        lengths_pad = np.pad(lengths.astype(np.float32)[order], (0, n_pad - n))
        if mesh is not None:
            self._set_shard(padded_t, ranks, lengths_pad, kept)
        else:
            # the order above is the float32 matrix's; bf16 rounds after it (:1943)
            self._set_columns(torch.as_tensor(padded_t, device=self.device).to(self._dtype), ranks,
                              torch.as_tensor(lengths_pad, device=self.device), kept)

        self.n_points = n
        self.C = min(maxsteps, n_pad)
        self.maxsteps = maxsteps
        self.minsuccesses = minsuccesses
        self._order = order  # engine column -> original index
        # pvr accumulates in f32 exactly like vamb_tpu's device scalar
        self.pvr = np.float32(0.1)
        self.attempts: deque = deque(maxlen=windowsize)
        self.successes = 0
        self.order_pos = 0
        self.key = threefry.PRNGKey(rng_seed)
        self.n_remaining = n
        self.n_emitted_clusters = 0

        # scope: decided at construction, re-read at each live width
        self._scope = wander_scope
        self._subset_q = min(_SUBSET_Q, n_pad)
        self._set_scope()
        # compaction ladder
        self._batch_clusters = batch_clusters
        self._compact = compact
        self._compact_min_pad = compact_min_pad
        self._in_batch = 0  # clusters emitted in the current batch
        self._remaining_at_batch_start = n
        self.compactions: list[tuple[int, int, int]] = []
        self.subset_counts = {"attempts": 0, "overflow": 0, "drift": 0}
        self.lane_counts = dict.fromkeys(
            ("refills", "bursts", "burst_loners", "burst_capacity_stops", "passes", "lanes",
             "admitted", "deferred", "cut_conflict", "cut_pvr", "cut_full", "cut_capacity"), 0)
        self._queue: deque = deque()  # clusters an iteration emitted, not yet returned
        self._tally = _Tally()
        self.dist_terms = {"full_steps": 0, "final_rows": 0, "unclimbed_lanes": 0}
        self._removals = 0  # points removed so far: the cached sums' clock
        self.sums_trace: Optional[list] = None
        self._clear_cache()

    def __repr__(self) -> str:
        return (
            f"ClusterGenerator({self.n_points} points, "
            f"{self.n_emitted_clusters} clusters)"
        )

    def __iter__(self):
        return self

    # -- the work counters (vamb_tpu/cluster.py:356-363, :2064-2093) -------

    @property
    def n_dists(self) -> float:
        """Raw medoid-to-point distance evaluations so far, in `vamb_tpu`'s
        accounting for the code family that runs (float32)."""
        return float(self._tally.raw)

    @property
    def n_dists_effective(self) -> float:
        """Reference-equivalent distance evaluations so far: one row a seed
        and, a wander step, the candidates the reference's one-at-a-time
        sampler would have evaluated (float32; the same on every device)."""
        return float(self._tally.eff)

    @property
    def emitted_total(self) -> int:
        "Clusters decided so far, those queued but not yet returned included."
        return self.n_emitted_clusters

    def drain(self) -> None:
        """Wait for the engine's queued device work, so that none of it runs
        into whatever the caller times next. The port keeps no batch in
        flight, so this changes no later emission."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the live columns: the compaction ladder and the wander scope ------

    def _set_columns(self, matrixT, ranks, lengths, kept, offset: int = 0) -> None:
        """Install the live (F_pad, N_local) matrix and its per-column
        arrays: the whole width's (N_local = N_pad), or a shard's from
        global column `offset`."""
        self.matrixT = matrixT
        self.ranks = ranks  # host int64 seed ranks, travelling with columns
        self.lengths = lengths
        self.kept = kept  # host mirror of kept_t, the whole width
        self.n_pad = len(kept)
        self.offset, self.n_loc = offset, matrixT.shape[1]
        self._kept_t = torch.as_tensor(kept[offset:offset + self.n_loc], device=self.device)
        self._unsynced: list = []  # removed columns not yet cleared in _kept_t
        self.iota = torch.arange(self.n_loc, device=self.device) + offset  # the global columns

    def _set_shard(self, padded_t: np.ndarray, ranks, lengths: np.ndarray, kept) -> None:
        """Install this rank's block of the (F_pad, N_pad) float32 host
        matrix (in the engine's type) and its lengths, keeping both whole on
        the host for the compactions."""
        self._host_t, self._host_lengths = padded_t, lengths
        lo, hi = self._mesh.block(len(kept))
        block = torch.as_tensor(padded_t[:, lo:hi], device=self.device).to(self._dtype)
        self._set_columns(block.contiguous(), ranks,
                          torch.as_tensor(lengths[lo:hi], device=self.device), kept, lo)

    @property
    def kept_t(self) -> torch.Tensor:
        """The kept mask on the device, the removals since its last use
        applied in one launch (a burst's loners need not pay one each)."""
        if self._unsynced:
            rows = np.concatenate(self._unsynced) - self.offset
            self._unsynced = []
            rows = rows[(rows >= 0) & (rows < self.n_loc)]
            self._kept_t[torch.as_tensor(rows, device=self.device)] = False
        return self._kept_t

    def _set_scope(self) -> None:
        "The subset wander's ball size Q at the live width, 0 for full sweeps."
        subset_here = self._scope == "subset" or (
            self._use_subset and self.n_pad >= _SUBSET_AUTO_MIN
        )
        self.Q = min(self._subset_q, self.n_pad) if subset_here else 0
        self._lanes_here = subset_here and self._attempt_batch != "off"

    def _next_target(self) -> Optional[int]:
        "Next (halved) padded width on the ladder, or None (cluster.py:2110-2116)."
        t = self.n_pad // 2
        t -= t % self._col_tile
        return t if t >= max(self._compact_min_pad, self._col_tile) else None

    def _end_batch(self) -> None:
        """Close a batch of `batch_clusters` clusters: compact if the
        survivors at the batch's start already fit the next ladder width
        (`vamb_tpu` decides one batch late, cluster.py:2183-2197)."""
        target = self._next_target()
        start = self._remaining_at_batch_start
        if (self._compact and target is not None and 0 < start
                and _pad_to(start, self._col_tile) <= target):
            self._compact_to(target)
        self._remaining_at_batch_start = self.n_remaining
        self._in_batch = 0

    def _compact_to(self, target: int) -> None:
        """Gather the surviving columns, in engine order, into a `target`-wide
        matrix (`_compact_arrays`, cluster.py:1710-1738): ranks travel with
        their columns, so `order_pos` stays a rank threshold; padding
        columns repeat column 0, unkept and weightless."""
        survivors = np.flatnonzero(self.kept)
        n2 = len(survivors)
        idx2old = np.zeros(target, np.int64)
        idx2old[:n2] = survivors
        ranks = np.arange(target, dtype=np.int64) + RANK_PAD_BASE
        ranks[:n2] = self.ranks[survivors]
        kept = np.zeros(target, bool)
        kept[:n2] = True
        old = self.n_pad
        if self._mesh is not None:  # each rank's new block, from the host's copy
            self._set_shard(self._host_t[:, idx2old],
                            ranks, np.where(kept, self._host_lengths[idx2old], 0.0), kept)
        else:
            idx_t = torch.as_tensor(idx2old, device=self.device)
            lengths = torch.where(torch.as_tensor(kept, device=self.device),
                                  self.lengths[idx_t], 0.0)
            self._set_columns(self.matrixT[:, idx_t].contiguous(), ranks, lengths, kept)
        self._order = self._order[survivors]
        self._set_scope()
        self._clear_cache()  # _compact_arrays, cluster.py:1731-1737
        self.compactions.append((self.n_emitted_clusters, old, target))
        logger.info(
            f"\tCompacted the engine matrix from {old} to {target} columns after "
            f"{self.n_emitted_clusters} clusters ({n2} points left); wander scope "
            f"{'subset, Q ' + str(self.Q) if self.Q else 'full'}"
        )

    # -- the speculative seed cache (cluster.py:1047-1095) -----------------

    def _clear_cache(self) -> None:
        "Empty the seed cache (at the start and at each compaction): the next attempt refills it."
        self._spec_cols = None  # the cached seeds' columns, in scan order
        self._spec_d = None  # their (S, N_pad) rows
        self._spec_next = _SPEC_SEEDS  # the first slot the seed scan may take
        self._stats = None  # the rows' (hist, density, n_close, n_near) ...
        self._stats_at = -1  # ... under the kept mask after this many removals
        self._near = None  # n_near on the host, once fetched
        self._wk, self._wk_at = None, -1  # the weights, and the removals they follow

    def _weights(self) -> torch.Tensor:
        "The columns' weights: lengths where kept, else 0 (fixed between removals)."
        if self._wk_at != self._removals:
            self._wk, self._wk_at = torch.where(self.kept_t, self.lengths, 0.0), self._removals
        return self._wk

    def _next_seeds(self) -> list[int]:
        """The next `_SPEC_SEEDS` columns of the cycling seed scan from rank
        `order_pos` (next_seeds_batch, cluster.py:543-553): kept columns by
        ascending rank, wrapping to the smallest kept rank (ref
        cluster.py:342-384), repeated where fewer are kept."""
        cols = np.flatnonzero(self.kept)
        ranks = self.ranks[cols]

        def smallest(sel):
            "The (at most S) columns of `sel` with the smallest ranks, ascending."
            if len(sel) > _SPEC_SEEDS:
                sel = sel[np.argpartition(ranks[sel], _SPEC_SEEDS - 1)[:_SPEC_SEEDS]]
            return cols[sel[np.argsort(ranks[sel])]]

        seeds = list(smallest(np.flatnonzero(ranks >= self.order_pos)))
        if len(seeds) < _SPEC_SEEDS:
            wrap = smallest(np.arange(len(cols)))
            seeds += [wrap[i % len(wrap)] for i in range(_SPEC_SEEDS - len(seeds))]
        return [int(c) for c in seeds]

    def _refill(self) -> None:
        "Fill the cache from `order_pos`: the seeds' rows and sums in one `spec_sweep` (:1069-1076)."
        self._spec_cols = self._next_seeds()
        self._spec_d, *stats = self._spec(self._spec_cols, self._weights())
        self._stats, self._stats_at, self._near = tuple(stats), self._removals, None
        self._spec_next = 0
        self.lane_counts["refills"] += 1
        self._tally.add(raw=_f32(_SPEC_SEEDS) * _f32(self.n_pad))  # the cache's rows (:1075)

    def _slot_stats(self):
        """The cached rows' (hist, density, n_close) under the current kept
        mask, and their near counts (d <= 0.05) on the host: the refill's
        while no point was removed since, else one `row_stats` of the S
        rows (the loner flags of cluster.py:1104-1112)."""
        if self._stats_at != self._removals:
            self._stats = self._row_stats(self._spec_d, self._weights())
            self._stats_at, self._near = self._removals, None
        if self._near is None:
            self._near = self._stats[3].tolist()
        return (*self._stats[:3], self._near)

    def _alive(self, start: int) -> list[int]:
        "The cache's slots at or after `start` whose seed is still kept."
        if self._spec_cols is None:
            return []
        return [s for s in range(start, _SPEC_SEEDS) if self.kept[self._spec_cols[s]]]

    def _next_seed(self) -> tuple[int, int]:
        """The attempt's seed: the first alive slot at or after `spec_next`,
        which is the cycling scan's next seed (cached slots are the scan
        from the fill position, and points are only removed), refilling the
        cache when there is none. Returns (slot, column)."""
        alive = self._alive(self._spec_next)
        if not alive:
            self._refill()
            alive = [0]
        return alive[0], self._spec_cols[alive[0]]

    # -- the reference control flow, one rule per method ------------------

    def _update_successes(self, success: bool) -> bool:
        """The success window + pvr bump (ref cluster.py:386-413). A bump
        restarts the seed scan and so forces a refill (cluster.py:1317-1329).
        Returns whether it bumped."""
        if len(self.attempts) == self.attempts.maxlen:
            self.successes -= self.attempts.popleft()
        self.successes += success
        self.attempts.append(success)
        if (
            len(self.attempts) == self.attempts.maxlen
            and self.successes < self.minsuccesses
        ):
            self.pvr = np.float32(self.pvr + np.float32(0.1))
            self.attempts.clear()
            self.successes = 0
            self.order_pos = 0
            self._spec_next = _SPEC_SEEDS
            return True
        return False

    def _step(self, key, d, kept, tried, medoid, n: int, matrixT, wk):
        """One wander step's draws: split the key, Gumbel top-C over the n
        eligible-untried columns in `jax.lax.top_k`'s order (one launch),
        their densities in one sweep. Returns (key, cand, cand_valid, dens)."""
        key, k1 = threefry.split_host(key)
        cand, cand_valid = self._kernels.gumbel_topc(k1, d, kept, tried, medoid, self.C)
        return key, cand, cand_valid, self._kernels.candidate_density_sweep(matrixT, cand, wk)

    def _climb(self, medoid: int, sweep, density, tried, key, wk):
        """First-improvement hill climb over all columns (ref :415-450) from
        any state: each step samples up to C eligible untried points, jumps
        to the first (in sampled order) that beats the current density and
        takes the new medoid's row and sums from `medoid_sweep`. `sweep` is
        the current medoid's (d, hist, density, n_close). Returns (medoid,
        sweep)."""
        kept_t = self.kept_t
        while True:
            if self._mesh is None:
                key, cand, cand_valid, dens = self._step(
                    key, sweep[0], kept_t, tried, medoid, self.n_pad, self.matrixT, wk)
            else:
                key, cand, cand_valid, dens = self._shard_step(key, sweep[0], kept_t, tried,
                                                               medoid, wk)
            better = cand_valid & (dens > density)
            # one host sync per step: which candidate (if any) won, and
            # which were valid (the step's effective count)
            better_h, valid_h = torch.stack([better, cand_valid]).cpu().numpy()
            self._count_full_step(int(np.argmax(better_h)) + 1 if better_h.any()
                                  else int(valid_h.sum()))
            if not better_h.any():
                return medoid, sweep
            j = int(np.argmax(better_h))
            self._set_tried(tried, cand[: j + 1])
            medoid = int(cand[j])
            sweep = self._sweep(medoid, wk)
            density = dens[j]

    def _wander(self, seed: int, sweep, wk, key):
        """The full-scope wander (cluster.py:850-858) from the sweep of a
        seed with a kept neighbour within 0.05. Returns (medoid, its sweep)."""
        tried = torch.zeros(self.n_loc, dtype=torch.bool, device=self.device)
        self._set_tried(tried, seed)
        return self._climb(seed, sweep, sweep[2], tried, key, wk)

    def _subset_phase1(self, seed: int, d0, density, wk, key, tally):
        """Phase 1 of the subset wander (subset_phase1, cluster.py:555-748;
        oracle_cluster.py:473-561) from a seed with a kept neighbour within
        0.05: the first KB = Q/128 blocks (ascending) holding a kept column
        within 0.15 of the seed, gathered with their per-slot vectors
        (`_ball`), and the climb inside them, each step's draw a Q-wide
        uniform and its densities a `candidate_density_sweep` over the ball,
        replicated on every rank under a mesh. `density` is the seed's
        sweep's: every column within 0.05 of the seed lies in a flagged
        block. Returns (medoid, status, density, key, block_any, ball):
        status "done", or "overflow" (more than KB blocks flagged; the
        medoid is the seed) or "drift" (the medoid moved past
        `_SUBSET_ABORT` from the seed), where the climb must go on over all
        columns; `block_any` the flagged blocks of this rank's columns (a
        lane's conflict region); `ball` (cols, tried_s, nb) of the gathered
        slots, None on overflow. Each step's counts go to `tally`."""
        B, Q = _SUBSET_BLOCK, self.Q
        kept_t, dev = self.kept_t, self.device
        block_any = (kept_t & (d0 <= _SUBSET_RADIUS)).view(-1, B).any(dim=1)
        ball = self._ball(seed, block_any, Q // B, wk, kept_t, d0)
        if ball is None:
            return seed, "overflow", density, key, block_any, None
        xsT, cols, kept_s, wk_s, d0_s, nb, before = ball
        slot = before * B + seed % B
        tried_s = torch.zeros(Q, dtype=torch.bool, device=dev)
        tried_s[slot] = True
        d_s, medoid, status = d0_s, seed, "done"
        while True:
            key, cand, cand_valid, dens = self._step(key, d_s, kept_s, tried_s, slot, Q, xsT, wk_s)
            better = cand_valid & (dens > density)
            # one host sync per step: the winner, its slot and column, its
            # drift and the valid candidates (float64 holds all exactly)
            better_h, cand_h, col_h, drift_h, valid_h = torch.stack(
                [better.to(torch.float64), cand.to(torch.float64),
                 cols[cand].to(torch.float64), d0_s[cand].to(torch.float64),
                 cand_valid.to(torch.float64)]
            ).cpu().numpy()
            # C x Q evaluated, `upto` x N effective (:722-723)
            upto = int(np.argmax(better_h)) + 1 if better_h.any() else int(valid_h.sum())
            tally.add(raw=_f32(self.C) * _f32(Q), eff=_f32(upto) * _f32(self.n_pad))
            if not better_h.any():
                break
            j = int(np.argmax(better_h))
            tried_s[cand[: j + 1]] = True
            slot, medoid = int(cand_h[j]), int(col_h[j])
            d_s = self._kernels.row_sweep(xsT, slot)
            density = dens[j]
            if drift_h[j] > np.float32(_SUBSET_ABORT):
                status = "drift"
                break
        return medoid, status, density, key, block_any, (cols, tried_s, nb)

    @staticmethod
    def _flagged_ids(block_any: torch.Tensor, kb: int) -> torch.Tensor:
        """The first kb flagged blocks' ids, ascending, then zeros (the
        ball's padding slots gather block 0, masked by the gather), built on
        the device with no host sync: block b goes to slot (flagged blocks
        up to b) - 1; other blocks land in a spare slot kb that is cut off."""
        dev = block_any.device
        upto = torch.cumsum(block_any, 0)
        dest = torch.where(block_any & (upto <= kb), upto - 1, kb)
        bids = torch.zeros(kb + 1, dtype=torch.int32, device=dev)
        bids.scatter_(0, dest, torch.arange(len(block_any), dtype=torch.int32, device=dev))
        return bids[:kb]

    def _ball(self, seed: int, block_any, kb: int, wk, kept_t, d0):
        """The seed's ball from the flagged blocks `block_any` of this rank's
        columns: (xsT (F_pad, Q), cols, kept, w, d0 of its slots, nb, the
        flagged blocks before the seed's), or None where more than kb blocks
        are flagged. One host sync for the counts; under a mesh
        `_ball_shards`."""
        if self._mesh is not None:
            return self._ball_shards(seed, block_any, kb, wk, kept_t, d0)
        B = _SUBSET_BLOCK
        nb, before = torch.stack([block_any.sum(), block_any[: seed // B].sum()]).tolist()
        if nb > kb:
            return None
        bids = self._flagged_ids(block_any, kb)
        return (*self._kernels.gather_ball(self.matrixT, bids, nb, wk, kept_t, d0), nb, before)

    def _ball_shards(self, seed: int, block_any, kb: int, wk, kept_t, d0):
        """`_ball` under a mesh. A rank's columns are whole blocks, so its
        flagged blocks fill the ball's slots after those of the ranks before
        it. One integer gather (kind "ball counts") brings every rank's
        flagged count, its flagged blocks before the seed's and the global
        ids of its first kb flagged blocks: the overflow and the seed's slot
        are decided alike on every rank. Then each rank's blocks with their
        per-slot vectors (`gather_ball_shard`, padded to kb blocks) in one
        gather (kind "ball", W x (F_pad + 3) x Q floats), laid out in rank
        order: the gathered slots are `gather_ball`'s bit for bit, and the
        padding slots hold zero features (no decision reads them), weight
        0, not kept, d0 inf."""
        B, Q, mesh = _SUBSET_BLOCK, kb * _SUBSET_BLOCK, self._mesh
        first = self.offset // B  # this rank's first global block
        bids = self._flagged_ids(block_any, kb)
        before_mine = block_any[: max(0, seed // B - first)].sum()
        mine = torch.cat([torch.stack([block_any.sum(), before_mine]), bids.long() + first])
        counts = mesh.all_gather(mine, "ball counts").cpu()  # (W, 2 + kb), one host sync
        nbs = counts[:, 0].tolist()
        nb, before = sum(nbs), int(counts[:, 1].sum())
        if nb > kb:
            return None
        xs, _, kept_p, w_p, d0_p = self._kernels.gather_ball_shard(
            self.matrixT, bids, nbs[mesh.rank], wk, kept_t, d0, self.offset)
        f = xs.shape[0]
        packed = torch.cat([xs, w_p[None], kept_p.float()[None], d0_p[None]])
        parts = mesh.all_gather(packed, "ball")  # (W, F_pad + 3, Q)
        take = torch.cat([r * Q + torch.arange(n * B) for r, n in enumerate(nbs)]).to(self.device)
        ball = torch.zeros((f + 3, Q), dtype=torch.float32, device=self.device)
        ball[f + 2] = torch.inf
        ball[:, : nb * B] = parts.permute(1, 0, 2).reshape(f + 3, -1)[:, take]
        gids = torch.zeros(kb, dtype=torch.int64)
        gids[:nb] = torch.cat([counts[r, 2: 2 + n] for r, n in enumerate(nbs)])
        cols = (gids[:, None] * B + torch.arange(B)).reshape(-1).to(torch.int32).to(self.device)
        return ball[:f].contiguous(), cols, ball[f + 1] > 0.5, ball[f], ball[f + 2], nb, before

    def _wander_subset(self, seed: int, sweep, wk, key):
        """The two-phase subset wander (cluster.py:555-748, 860-935):
        phase 1 and, if the ball overflowed or the medoid drifted, the full
        climb with `tried` and the density carried over. Returns (medoid,
        its sweep)."""
        self.subset_counts["attempts"] += 1
        medoid, status, density, key, _, ball = self._subset_phase1(seed, sweep[0], sweep[2], wk,
                                                                    key, self._tally)
        if status == "done":
            return medoid, sweep if medoid == seed else self._sweep(medoid, wk)
        self.subset_counts[status] += 1
        if medoid != seed:  # the moved medoid's row for the full climb (:907-909)
            self._tally.add(raw=self.n_pad)
        tried = torch.zeros(self.n_loc, dtype=torch.bool, device=self.device)
        if ball is None:
            self._set_tried(tried, seed)
        else:  # the ball's tried slots, on this rank's own columns
            cols, tried_s, nb = ball
            loc = self._local(cols[: nb * _SUBSET_BLOCK].long())
            mine = loc >= 0
            tried[loc[mine]] = tried_s[: nb * _SUBSET_BLOCK][mine]
        if medoid != seed:
            sweep = self._sweep(medoid, wk)
        return self._climb(medoid, sweep, density, tried, key, wk)

    def _decide(self, n_close, found, thr):
        """An attempt's outcome from its decision inputs on the host (ref
        :457, :550-600): (kind, radius), kind "loner", "normal",
        "fallback" or "reject"."""
        if n_close == 1:
            return "loner", None
        if found:
            return "normal", np.float32(thr)
        if self.pvr > np.float32(0.55):
            return "fallback", np.float32(_DEFAULT_RADIUS)
        return "reject", None

    def _account(self, kind: str) -> bool:
        "The window update of an outcome (ref :582, :599-600). Returns whether pvr bumped."
        if kind == "reject":
            return self._update_successes(False)
        if kind == "normal" and self.pvr < np.float32(0.55):
            return self._update_successes(True)
        return False

    def _count_full_step(self, upto: int) -> None:
        """A full-scope wander step's counts (:842-848): C x N evaluated (and
        under the kernels the medoid's row again), `upto` x N effective."""
        n = self.n_pad
        self._tally.add(raw=self.C * n, eff=_f32(upto) * _f32(n))
        if self._kernel_terms:
            self._tally.add(raw=n)
        self.dist_terms["full_steps"] += n

    def _count_attempt_rows(self) -> None:
        """An attempt's rows after its wander: under the subset wander the
        final row (:927-934; one row under the kernels, the plain versions'
        8-row product else), then the histogram pass (:1264-1271)."""
        n = self.n_pad
        if self.Q:
            self._tally.add(raw=n if self._kernel_terms else _f32(_SPEC_SEEDS) * _f32(n))
            self.dist_terms["final_rows"] += n
        self._tally.add(raw=n)

    def __next__(self) -> Cluster:
        while not self._queue:
            if self.n_remaining == 0:
                raise StopIteration
            if self._in_batch == self._batch_clusters:
                self._end_batch()
            self._attempt()
        return self._queue.popleft()

    def _attempt(self) -> None:
        """One round of `vamb_tpu`'s attempt (cluster.py:1047-1649): the seed
        from the cache, wander, threshold, emit or reject; after a loner
        seed its burst; then, where the subset wander runs, the lanes."""
        slot, seed = self._next_seed()
        self.order_pos = int(self.ranks[seed]) + 1
        self._spec_next = slot + 1
        hist, dens, n_close, near = self._slot_stats()
        self.key, sub = threefry.split_host(self.key)
        self._tally.add(eff=self.n_pad)  # the reference's one row a seed (:852)
        if near[slot] == 1:  # a loner: no wander, no threshold (ref :457, :550-562)
            if self.sums_trace is not None:
                self.sums_trace.append((seed, near[slot]))
            self._commit(self._record(seed, seed, "loner", None, None), np.array([seed]))
            self._count_attempt_rows()
            self._burst(slot)
        else:
            wk = self._weights()  # kept is frozen per attempt
            sweep = (self._spec_d[slot], hist[slot], dens[slot], n_close[slot])
            wander = self._wander_subset if self.Q else self._wander
            medoid, (d, hist_m, dens_m, close_m) = wander(seed, sweep, wk, sub)
            self._count_attempt_rows()
            if self.sums_trace is not None:
                self.sums_trace.append((seed, medoid, hist_m.cpu().numpy().tobytes(),
                                        float(dens_m), int(close_m)))
            thr_t, opvr_t, found_t = find_threshold(hist_m, float(self.pvr))
            # one host sync for the attempt's decision
            close_h, thr, opvr, found = torch.stack(
                [close_m.to(torch.float32), thr_t, opvr_t, found_t.to(torch.float32)]
            ).cpu().numpy()
            kind, radius = self._decide(close_h, found, thr)
            if kind != "reject":
                members = np.array([medoid]) if kind == "loner" else self._members(d, radius)
                self._commit(self._record(medoid, seed, kind, radius, opvr), members)
            self._account(kind)
        if self._lanes_here:
            self._lanes()

    def _burst(self, slot0: int) -> None:
        """Emit the consecutive cached seeds after the loner seed in
        `slot0` that are loners too (burst_extension, cluster.py:1114-1260):
        a loner has no neighbour within 0.05, so removing it changes no
        other seed's neighbourhood, and each splits the key once, as its own
        attempt would. Dead slots are skipped; an alive non-loner, the
        batch's capacity or no points left ends the burst; a used-up cache
        is refilled from `order_pos`, as the next attempt's miss would, and
        the burst goes on."""
        if self._in_batch >= self._batch_clusters or self.n_remaining == 0:
            return
        self.lane_counts["bursts"] += 1
        start = slot0 + 1
        while True:
            near = self._slot_stats()[3]  # the loner flags: one pass, one sync
            loners, stopped = 0, False
            for s in range(start, _SPEC_SEEDS):
                c = self._spec_cols[s]
                if not self.kept[c]:
                    continue
                if near[s] != 1:
                    stopped = True
                    break
                if self._in_batch >= self._batch_clusters:
                    self.lane_counts["burst_capacity_stops"] += 1
                    stopped = True
                    break
                self.key = threefry.split_host(self.key)[0]
                self.order_pos = int(self.ranks[c]) + 1
                self._commit(self._record(c, c, "loner", None, None), np.array([c]))
                self.lane_counts["burst_loners"] += 1
                loners += 1
            # a loner's seed row and histogram pass, added once a pass (:1204-1207)
            term = _f32(loners) * _f32(self.n_pad)
            self._tally.add(raw=term, eff=term)
            if stopped or self._in_batch >= self._batch_clusters or self.n_remaining == 0:
                return
            self._refill()
            start = 0

    def _lanes(self) -> None:
        """Speculative attempt lanes (lanes_extension, cluster.py:1333-1640):
        each alive cached seed after the exact attempt runs as the next
        attempt against the frozen state, with the key chain's next link:
        its phase-1 climb (one lane after another, as `vamb_tpu`'s scan
        runs them; a loner seed climbs not), then all lanes' final rows and
        sums from one `spec_sweep`, their thresholds from one batched scan
        and their decisions, members' counts and conflicts in one host
        sync (under a mesh one gather, the counts each rank's partial added
        exactly). The sequential acceptance scan admits lanes while (a) no
        admitted lane removed a point of this lane's region (its row within
        0.3, and its gathered blocks), (b) no admitted lane bumped the pvr,
        (c) the lane finished inside the ball, (d) the batch has room and
        points are left; each admitted lane is exactly the next sequential
        attempt, and a cut lane consumes no key and reruns as an exact
        attempt."""
        K = self._batch_clusters
        alive = self._alive(self._spec_next)
        if not alive or self._in_batch >= K or self.n_remaining == 0:
            return
        counts, dev = self.lane_counts, self.device
        counts["passes"] += 1
        wk = self._weights()
        _, dens, _, near = self._slot_stats()
        links, key = [], self.key  # the chain: one split a processed attempt
        for _ in alive:
            key, sub = threefry.split_host(key)
            links.append((key, sub))
        medoids, blocks, tallies = [], [], []
        for i, ((_, sub), s) in enumerate(zip(links, alive)):
            seed = self._spec_cols[s]
            tallies.append(_Tally(eff=self.n_pad))  # a lane counts from (0, N) (:1433-1436)
            counts["lanes"] += 1
            if near[s] == 1:
                medoids.append(seed)
                blocks.append(s)  # its ball's blocks, below
                continue
            medoid, status, _, _, block_any, _ = self._subset_phase1(
                seed, self._spec_d[s], dens[s], wk, sub, tallies[-1])
            if status != "done":
                # (c): this lane and the ones after it rerun as exact
                # attempts; `vamb_tpu` climbs the later ones all the same
                # (:1439-1444), for its raw count alone, and the port not
                self.dist_terms["unclimbed_lanes"] += sum(near[s2] != 1 for s2 in alive[i + 1:])
                break
            medoids.append(medoid)
            blocks.append(block_any)
        n = len(medoids)
        cut = "full" if n < len(alive) else None
        emitted, admitted = [], 0
        if n:
            rows, hist, _, n_close, _ = self._spec(medoids, wk)
            thr, opvr, found = find_threshold(hist, float(self.pvr))
            radius = torch.where(found, thr, _DEFAULT_RADIUS if self.pvr > np.float32(0.55) else -1.0)
            med_t = torch.as_tensor(medoids, device=dev)
            sel = torch.where((n_close == 1)[:, None], self.iota[None, :] == med_t[:, None],
                              rows <= radius[:, None]) & self.kept_t
            loners = [b for b in blocks if isinstance(b, int)]
            if loners:
                loner_blocks = dict(zip(loners, self._loner_blocks(loners)))
                blocks = [loner_blocks[b] if isinstance(b, int) else b for b in blocks]
            ball = torch.stack(blocks)
            region = (rows <= _XMAX) | ball.repeat_interleave(_SUBSET_BLOCK, dim=1)
            # hits[k, r]: how many of lane k's members lie in lane r's region
            # (one small product; integers, exact in float32 below 2^24)
            hits = sel.to(torch.float32) @ region.to(torch.float32).T
            # one host sync for all lanes' decisions, then the members' and
            # the hits' counts (float64 holds them exactly); under a mesh the
            # counts are each rank's, added over the ranks in the same gather
            host = torch.cat([
                torch.stack([n_close.double(), thr.double(), opvr.double(),
                             found.double()]).flatten(),
                sel.sum(1).double(), hits.double().flatten(),
            ])
            if self._mesh is not None:
                parts = self._mesh.all_gather(host, "lane decisions")
                host = torch.cat([parts[0, : 4 * n], parts[:, 4 * n:].sum(0)])
            host = host.cpu().numpy()
            close_h, thr_h, opvr_h, found_h, size_h = host[: 5 * n].reshape(5, n)
            hits_h = host[5 * n:].reshape(n, n) > 0
            in_batch, n_left = self._in_batch, self.n_remaining
            for r, s in enumerate(alive[:n]):
                if in_batch >= K or n_left == 0:
                    cut = "capacity"
                    break
                if any(hits_h[k, r] for _, k in emitted):
                    cut = "conflict"
                    break
                admitted += 1
                seed = self._spec_cols[s]
                self.key = links[r][0]
                self.order_pos = int(self.ranks[seed]) + 1
                self._spec_next = s + 1
                kind, rad = self._decide(close_h[r], found_h[r], thr_h[r])
                if kind != "reject":
                    emitted.append((self._record(medoids[r], seed, kind, rad, opvr_h[r]), r))
                    in_batch += 1
                    n_left -= int(size_h[r])
                if self._account(kind):
                    cut = "pvr" if r + 1 < len(alive) else None
                    break
        counts["admitted"] += admitted
        counts["deferred"] += len(alive) - admitted
        # raw: every climbed lane's climb, the 8 final rows and their 8
        # histogram passes; effective: the processed lanes' (:1592-1600). The
        # lane sums are multiples of 128 far below 2^31, exact in any order
        climbs, processed = _Tally(), _Tally()
        for i, t in enumerate(tallies):
            climbs.add(raw=t.raw)
            if i < admitted:
                processed.add(eff=t.eff)
        self._tally.add(raw=climbs.raw)
        self._tally.add(raw=_f32(2 * _SPEC_SEEDS) * _f32(self.n_pad), eff=processed.eff)
        if cut is not None:
            counts["cut_" + cut] += 1
        # the emitted lanes' members in one sync (under a mesh one gather of
        # every rank's, in rank order: ascending), then their removal in order
        wide = [r for rec, r in emitted if rec.radius is not None]
        members = {}
        if wide:
            nz = torch.nonzero(sel[wide])
            if self._mesh is not None:  # (lane, global column) as one int64 each
                coded = self._mesh.gather_rows(nz[:, 0] * self.n_pad + nz[:, 1] + self.offset,
                                               "lane members")
                nz = torch.stack([coded // self.n_pad, coded % self.n_pad], 1)
            nz = nz.cpu().numpy()
            for i, r in enumerate(wide):
                members[r] = nz[nz[:, 0] == i, 1]
        for rec, r in emitted:
            self._commit(rec, members.get(r, np.array([medoids[r]])))

    def _loner_blocks(self, slots: list) -> torch.Tensor:
        """The ball blocks of the loner lanes in cache `slots`, which climb
        not: as `vamb_tpu` gathers them with no climb (:742-744), the first
        KB blocks, in global order, holding a kept column within 0.15 of the
        seed, a part of the lane's conflict region. (L, N_local / 128) on
        this rank's columns; under a mesh one gather brings the flagged
        counts of the ranks before it."""
        B, kb = _SUBSET_BLOCK, self.Q // _SUBSET_BLOCK
        near = (self._spec_d[slots] <= _SUBSET_RADIUS) & self.kept_t
        flagged = near.view(len(slots), -1, B).any(dim=2)
        upto = torch.cumsum(flagged, dim=1)
        if self._mesh is not None:
            counts = self._mesh.all_gather(flagged.sum(dim=1), "lane balls")  # (W, L)
            upto = upto + counts[: self._mesh.rank].sum(dim=0)[:, None]
        return flagged & (upto <= kb)

    def _members(self, d: torch.Tensor, radius: np.float32) -> np.ndarray:
        sel = (d <= float(radius)) & self.kept_t
        ids = torch.nonzero(sel).squeeze(1)
        if self._mesh is not None:  # every shard's, in rank order: ascending
            ids = self._mesh.gather_rows(ids + self.offset, "members")
        return ids.cpu().numpy()

    # -- the numeric steps, on the whole width or on this rank's shard ------

    def _local(self, cols: torch.Tensor) -> torch.Tensor:
        "Global columns' local indices on this rank, -1 where another rank holds one."
        loc = cols - self.offset
        return torch.where((loc >= 0) & (loc < self.n_loc), loc, -1)

    def _local_host(self, col: int) -> int:
        "`_local` of one column given on the host."
        return col - self.offset if 0 <= col - self.offset < self.n_loc else -1

    def _set_tried(self, tried: torch.Tensor, cols) -> None:
        "Mark global columns `cols` (an int or a tensor) tried in this rank's (N_local,) mask."
        if self._mesh is None:
            tried[cols] = True
            return
        loc = self._local(torch.as_tensor(cols, device=self.device).reshape(-1))
        tried[loc[loc >= 0]] = True

    def _features(self, cols: torch.Tensor) -> torch.Tensor:
        """The (F_pad, k) float32 features of global columns `cols` (device
        int64), each from the rank that holds it (a bf16 shard's widened,
        exactly): one gather of every rank's (F_pad, k) with zeros where it
        holds none, then the owner's slice."""
        loc = self._local(cols)
        mine = torch.where(loc[None, :] >= 0, self.matrixT[:, loc.clamp_min(0)].float(), 0.0)
        parts = self._mesh.all_gather(mine, "query features")  # (W, F_pad, k)
        owner = torch.div(cols, self.n_loc, rounding_mode="floor")
        return parts[owner, :, torch.arange(len(cols), device=cols.device)].T.contiguous()

    def _shard_sums(self, hist, dens, *counts):
        """Every rank's (S, 60) histograms, (S,) densities and (S,) integer
        counts in one gather (float64 holds them all exactly): the sums
        added in rank order in float32, the counts exactly."""
        packed = torch.cat([hist.double(), dens.double()[:, None],
                            torch.stack(counts, 1).double()], 1)
        parts = self._mesh.all_gather(packed, "sums")
        total = parts[0, :, : _NBINS + 1].float()
        for r in range(1, self._mesh.size):
            total = total + parts[r, :, : _NBINS + 1].float()
        cnt = parts[:, :, _NBINS + 1:].sum(0).to(torch.int32)
        return (total[:, :_NBINS], total[:, _NBINS], *cnt.unbind(1))

    def _sweep(self, col: int, wk):
        "Column `col`'s (row, hist, density, n_close): `medoid_sweep`, or its shard entry point."
        if self._mesh is None:
            return self._kernels.medoid_sweep(self.matrixT, col, wk)
        q = self._features(torch.tensor([col], device=self.device))[:, 0]
        d, hist, dens, close = self._kernels.medoid_sweep_shard(self.matrixT, q,
                                                               self._local_host(col), wk)
        hist, dens, close = self._shard_sums(hist[None], dens[None], close[None])
        return d, hist[0], dens[0], close[0]

    def _spec(self, cols: list, wk):
        "`spec_sweep` of global columns `cols`, or its shard entry point and the rank-order sums."
        if self._mesh is None:
            return self._kernels.spec_sweep(self.matrixT, cols, wk)
        rows, *sums = self._kernels.spec_sweep_shard(
            self.matrixT, self._features(torch.tensor(cols, device=self.device)),
            [self._local_host(c) for c in cols], wk)
        return (rows, *self._shard_sums(*sums))

    def _row_stats(self, rows, wk):
        "`row_stats` of the rows on this rank's columns, and the rank-order sums."
        sums = self._kernels.row_stats(rows, wk)
        return sums if self._mesh is None else self._shard_sums(*sums)

    def _shard_step(self, key, d, kept, tried, medoid: int, wk):
        """A full-climb wander step on the shards: each rank's top C keys
        over its slice of the Gumbel stream (`gumbel_topc_shard`), merged
        into the global candidates, their features from their owners and
        each rank's densities of them (`candidate_density_shard`), added in
        rank order. A shard narrower than C gives all its keys. Returns (key,
        cand (global), cand_valid, dens)."""
        key, k1 = threefry.split_host(key)
        keys = self._kernels.gumbel_topc_shard(k1, d, kept, tried, medoid, min(self.C, self.n_loc),
                                               self.n_pad, self.offset)
        cand, cand_valid = topc_merge(self._mesh.all_gather(keys, "wander keys"), self.C)
        dens = self._kernels.candidate_density_shard(self.matrixT, self._features(cand),
                                                     self._local(cand), wk)
        return key, cand, cand_valid, self._mesh.sum_ranks(dens, "candidate densities")

    def _record(self, medoid: int, seed: int, kind: str, radius, observed_pvr) -> Cluster:
        """A cluster's record with the window as it stands before the
        outcome's update (ref :551-598); its members come at `_commit`."""
        return Cluster(
            int(self._order[medoid]),
            int(self._order[seed]),
            None,
            float(self.pvr),
            float(observed_pvr) if kind == "normal" else None,
            None if kind == "loner" else float(radius),
            self.successes,
            len(self.attempts),
        )

    def _commit(self, rec: Cluster, members_rows: np.ndarray) -> None:
        "Remove a cluster's members (engine columns, ascending) and queue its record."
        rec.members = self._order[members_rows].astype(np.int64)  # in engine column order
        self.kept[members_rows] = False
        self._unsynced.append(members_rows)
        self.n_remaining -= len(members_rows)
        self._removals += len(members_rows)
        self.n_emitted_clusters += 1
        self._in_batch += 1
        self._queue.append(rec)


_f32 = np.float32


class _Tally:
    """Float32 distance-evaluation counters, each term rounded to float32
    and added as `vamb_tpu`'s device scalars add it (cluster.py:356-363):
    `raw`, the evaluations made, and `eff`, the reference-equivalent ones.
    Every term is a multiple of 128 (N and Q are), so the sums are exact
    below 2^31 and round as `vamb_tpu`'s above it."""

    __slots__ = ("raw", "eff")

    def __init__(self, raw=0.0, eff=0.0):
        self.raw, self.eff = _f32(raw), _f32(eff)

    def add(self, raw=0.0, eff=0.0) -> None:
        self.raw = _f32(self.raw + _f32(raw))
        self.eff = _f32(self.eff + _f32(eff))


def _wander_kernels(plain: bool) -> SimpleNamespace:
    """The numeric steps the engine calls, by name: the CUDA kernels'
    wrappers, or with `plain` (`wander_kernel="xla"`) their plain versions,
    called on the engine's device, the card included, so that no
    hand-written kernel is launched (`vamb_tpu`'s XLA expressions)."""
    names = ("gumbel_topc", "candidate_density_sweep", "row_sweep", "gather_ball", "medoid_sweep",
             "spec_sweep", "row_stats", "gumbel_topc_shard", "candidate_density_shard",
             "gather_ball_shard", "medoid_sweep_shard", "spec_sweep_shard")
    if not plain:
        return SimpleNamespace(**{name: getattr(K, name) for name in names})
    plain_of = {name: name + "_plain" for name in names}
    plain_of["candidate_density_sweep"] = "candidate_density_plain"
    kernels = {name: getattr(K, plain_of[name]) for name in names}
    # the shard's plain version takes no global width
    kernels["gumbel_topc_shard"] = (
        lambda key, d, kept, tried, medoid, c, n_global, offset:
        K.gumbel_topc_shard_plain(key, d, kept, tried, medoid, c, offset))
    return SimpleNamespace(**kernels)


def _check_values(distance_dtype, wander_kernel, wander_scope, attempt_batch):
    "Reject values of the engine's switches that name no setting."
    if distance_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"distance_dtype must be float32/bfloat16, not {distance_dtype}")
    if wander_kernel not in ("auto", "pallas", "xla"):
        raise ValueError(f"wander_kernel must be auto/pallas/xla, not {wander_kernel}")
    if wander_scope not in ("auto", "subset", "full"):
        raise ValueError(f"wander_scope must be auto/subset/full, not {wander_scope}")
    if attempt_batch not in ("auto", "on", "off"):
        raise ValueError(f"attempt_batch must be auto/on/off, not {attempt_batch}")

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
device: the seed's and each new medoid's row with its histogram, density
and close count in one sweep (`kernels.medoid_sweep`), the per-step Gumbel
scores over the threefry stream and their top C in one launch
(`kernels.gumbel_topc`: XLA's CPU log and `jax.lax.top_k`'s order on
ties, so bit for bit `vamb_tpu`'s candidates), candidate densities
(`kernels.candidate_density_sweep`), the subset wander's ball and its
per-slot vectors in one gather (`kernels.gather_ball`), rows inside the
ball (`kernels.row_sweep`), the banded smoothing product and the valley
scan. The attempt's sums (histogram, close count, the seed's density) come
from `medoid_sweep` in an order fixed by the width, which its plain version
reproduces, and the smoothing sums in XLA's CPU order, so the engine
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

The speculative seed cache, loner bursts and attempt lanes of `vamb_tpu`
change no decision (oracle_cluster.py:301-305), so they are left out
(ROADMAP queue 1, item 4). Subset-wander attempts take the final row from
`medoid_sweep` (`row_sweep`'s arithmetic), not from `vamb_tpu`'s batched
einsum: distances that differ in the last ulp, the divergence class the
full path already has.

Random stream. Columns are padded to a multiple of 128 on every device
and the candidate Gumbel draws span the padded width (or the ball), with
one key split per attempt and one split + one uniform per wander step,
from jax's threefry stream (utils/threefry.py) — so given a latent the port
draws exactly the candidates `vamb_tpu` draws on the CPU.
"""

from collections import deque
from math import ceil
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .kernels import candidate_density_sweep, gather_ball, gumbel_topc, medoid_sweep, row_sweep
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
# Seed-rank sentinels, as in vamb_tpu: padding columns get distinct ranks
# >= RANK_PAD_BASE (never kept, so they never win a scan); RANK_NONE is the
# masked-scan identity.
RANK_PAD_BASE = 1 << 29
RANK_NONE = 1 << 30

# The subset wander's constants (vamb_tpu/cluster.py:417-427). Read at call
# time, so a test can patch them on both packages alike.
_SUBSET_BLOCK = 128  # ball gathers move whole 128-column blocks
_SUBSET_Q = 1 << 13  # most columns a ball may hold
_SUBSET_RADIUS = 0.15
_SUBSET_ABORT = _SUBSET_RADIUS - 2 * _MEDOID_RADIUS  # drift boundary
_SUBSET_AUTO_MIN = 1 << 18  # auto scope: subset at this live padded width and above
_DEFAULT_BATCH = 1024  # clusters per batch, the compaction ladder's clock


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
    reference's sequential state machine).

    Returns device scalars (threshold, observed_pvr, found); threshold < 0
    means none was found."""
    dev = hist.device
    densities = smooth_histogram(hist)
    xs = torch.as_tensor(_X_GRID.astype(np.float32), device=dev)
    x_gt_01 = torch.as_tensor(_X_GT_01, device=dev)
    i = torch.arange(_NBINS, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    pvr_t = torch.tensor(pvr, dtype=torch.float32, device=dev)

    # Running peak: until the peak is over, peak == cumulative max.
    run_max_incl = torch.cummax(densities, 0).values
    run_max_excl = torch.cat([torch.zeros(1, device=dev), run_max_incl[:-1]])

    # Peak is over at the first index with density < 60% of running max.
    po_mask = densities < 0.6 * run_max_incl
    po_exists = po_mask.any()
    po_idx = torch.argmax(po_mask.to(torch.int32))
    peak = run_max_incl[po_idx]

    # Dead: still rising past x = 0.1 while the peak is not over.
    pre_po = torch.where(po_exists, i < po_idx, True)
    rising = densities > run_max_excl
    dead = (rising & x_gt_01 & pre_po).any()

    # After the peak: running minimum seeded with densities[po_idx].
    seeded = torch.where(i >= po_idx, densities, inf)
    cummin_incl = torch.cummin(seeded, 0).values
    m_prev = torch.cat([inf.reshape(1), cummin_incl[:-1]])
    after = i > po_idx

    # A second peak (> 1.5x the minimum so far) stops the scan.
    brk = after & (densities > 1.5 * m_prev)
    brk_exists = brk.any()
    brk_idx = torch.argmax(brk.to(torch.int32))
    in_range = after & torch.where(brk_exists, i < brk_idx, True)

    # The threshold is the x of the last new minimum, i.e. the first index
    # attaining the final minimum.
    new_min = in_range & (densities < m_prev)
    range_min = torch.where(in_range, densities, inf).min()
    dam = torch.minimum(densities[po_idx], range_min)
    has_event = new_min.any()
    thr_pos = torch.argmax((new_min & (densities == dam)).to(torch.int32))
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
        device: "cuda" (default) or "cpu"

    With its defaults it emits what `vamb_tpu`'s generator emits with
    `compact_async=False` on the CPU. `attempt_batch` takes "auto" and
    "off" (both mean no attempt lanes, which change no decision);
    `distance_dtype="float32"` and `wander_kernel="auto"` are the only
    values ported. Each compaction is logged and recorded in `compactions`
    as (clusters emitted, old width, new width); `subset_counts` counts the
    subset wander's attempts and how many fell back to the full climb
    because the ball overflowed or the medoid drifted.
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
    ):
        if matrix.dtype != np.float32:
            raise ValueError("Matrix must be of dtype float32")
        if maxsteps < 1:
            raise ValueError(f"maxsteps must be a positive integer, not {maxsteps}")
        if maxsteps > 32:
            raise ValueError(f"maxsteps must be at most 32 (the density kernel's limit), not {maxsteps}")
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
        _check_unported(distance_dtype, wander_kernel, wander_scope, attempt_batch)
        self.device = resolve_device(device)

        if not normalized:
            matrix = normalize(matrix, inplace=destroy)

        n, f = matrix.shape
        n_pad = _pad_to(n, _LANES)
        f_pad = _pad_to(f, _SUBLANES)
        order, ranks_np = engine_order(matrix, lengths, rng_seed)
        padded_t = np.zeros((f_pad, n_pad), np.float32)
        padded_t[:f, :n] = matrix.T[:, order]
        ranks = np.arange(n_pad, dtype=np.int64) + RANK_PAD_BASE
        ranks[:n] = ranks_np
        kept = np.zeros(n_pad, bool)
        kept[:n] = True
        lengths_pad = np.pad(lengths.astype(np.float32)[order], (0, n_pad - n))
        self._set_columns(torch.as_tensor(padded_t, device=self.device), ranks,
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
        self._use_subset = wander_scope == "subset" or (
            wander_scope == "auto" and n_pad >= _SUBSET_AUTO_MIN
        )
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

    def __repr__(self) -> str:
        return (
            f"ClusterGenerator({self.n_points} points, "
            f"{self.n_emitted_clusters} clusters)"
        )

    def __iter__(self):
        return self

    # -- the live columns: the compaction ladder and the wander scope ------

    def _set_columns(self, matrixT, ranks, lengths, kept) -> None:
        "Install the live (F_pad, N_pad) matrix and its per-column arrays."
        self.matrixT = matrixT
        self.ranks = ranks  # host int64 seed ranks, travelling with columns
        self.lengths = lengths
        self.kept = kept  # host mirror of kept_t
        self.kept_t = torch.as_tensor(kept, device=self.device)
        self.n_pad = matrixT.shape[1]
        self.iota = torch.arange(self.n_pad, device=self.device)

    def _set_scope(self) -> None:
        "The subset wander's ball size Q at the live width, 0 for full sweeps."
        subset_here = self._scope == "subset" or (
            self._use_subset and self.n_pad >= _SUBSET_AUTO_MIN
        )
        self.Q = min(self._subset_q, self.n_pad) if subset_here else 0

    def _next_target(self) -> Optional[int]:
        "Next (halved) padded width on the ladder, or None (cluster.py:2110-2116)."
        t = self.n_pad // 2
        t -= t % _LANES
        return t if t >= max(self._compact_min_pad, _LANES) else None

    def _end_batch(self) -> None:
        """Close a batch of `batch_clusters` clusters: compact if the
        survivors at the batch's start already fit the next ladder width
        (`vamb_tpu` decides one batch late, cluster.py:2183-2197)."""
        target = self._next_target()
        start = self._remaining_at_batch_start
        if self._compact and target is not None and 0 < start and _pad_to(start, _LANES) <= target:
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
        idx_t = torch.as_tensor(idx2old, device=self.device)
        lengths = torch.where(torch.as_tensor(kept, device=self.device),
                              self.lengths[idx_t], 0.0)
        old = self.n_pad
        self._set_columns(self.matrixT[:, idx_t].contiguous(), ranks, lengths, kept)
        self._order = self._order[survivors]
        self._set_scope()
        self.compactions.append((self.n_emitted_clusters, old, target))
        logger.info(
            f"\tCompacted the engine matrix from {old} to {target} columns after "
            f"{self.n_emitted_clusters} clusters ({n2} points left); wander scope "
            f"{'subset, Q ' + str(self.Q) if self.Q else 'full'}"
        )

    # -- the reference control flow, one rule per method ------------------

    def _next_seed(self) -> tuple[int, int]:
        """Kept column with the smallest seed rank at or after `order_pos`,
        wrapping to the smallest kept rank (ref cluster.py:342-384).
        Returns (column, rank)."""
        kept_ranks = np.where(self.kept, self.ranks, RANK_NONE)
        ahead = np.where(kept_ranks >= self.order_pos, kept_ranks, RANK_NONE)
        r = int(ahead.min())
        if r >= RANK_NONE:
            r = int(kept_ranks.min())
        return int(np.argmax(kept_ranks == r)), r

    def _update_successes(self, success: bool) -> None:
        "The success window + pvr bump (ref cluster.py:386-413)."
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

    def _step(self, key, d, kept, tried, medoid, n: int, matrixT, wk):
        """One wander step's draws: split the key, Gumbel top-C over the n
        eligible-untried columns in `jax.lax.top_k`'s order (one launch),
        their densities in one sweep. Returns (key, cand, cand_valid, dens)."""
        key, k1 = threefry.split_host(key)
        cand, cand_valid = gumbel_topc(k1, d, kept, tried, medoid, self.C)
        return key, cand, cand_valid, candidate_density_sweep(matrixT, cand, wk)

    def _climb(self, medoid: int, sweep, density, tried, key, wk):
        """First-improvement hill climb over all columns (ref :415-450) from
        any state: each step samples up to C eligible untried points, jumps
        to the first (in sampled order) that beats the current density and
        takes the new medoid's row and sums from `medoid_sweep`. `sweep` is
        the current medoid's (d, hist, density, n_close). Returns (medoid,
        sweep)."""
        kept_t = self.kept_t
        while True:
            key, cand, cand_valid, dens = self._step(
                key, sweep[0], kept_t, tried, medoid, self.n_pad, self.matrixT, wk)
            better = cand_valid & (dens > density)
            # one host sync per step: which candidate (if any) won
            better_h = better.cpu().numpy()
            if not better_h.any():
                return medoid, sweep
            j = int(np.argmax(better_h))
            tried[cand[: j + 1]] = True
            medoid = int(cand[j])
            sweep = medoid_sweep(self.matrixT, medoid, wk)
            density = dens[j]

    def _wander(self, seed: int, sweep, wk, key):
        """The full-scope wander (cluster.py:850-858) from the seed's sweep.
        Returns (medoid, its sweep)."""
        d0, _, density, _ = sweep
        tried = torch.zeros(self.n_pad, dtype=torch.bool, device=self.device)
        tried[seed] = True
        if int(((d0 <= _MEDOID_RADIUS) & self.kept_t & ~tried).sum()) == 0:
            return seed, sweep
        return self._climb(seed, sweep, density, tried, key, wk)

    def _wander_subset(self, seed: int, sweep, wk, key):
        """The two-phase subset wander (cluster.py:555-748, 860-935;
        oracle_cluster.py:473-561). Phase 1 climbs inside the seed's ball:
        the first KB = Q/128 blocks (ascending) holding a kept column within
        0.15 of the seed, gathered with their per-slot vectors by
        `gather_ball`, each step's draw a Q-wide uniform and its densities a
        `candidate_density_sweep` over the ball. Phase 2, the full climb
        with `tried` and the density carried over, runs if the ball
        overflowed or the medoid drifted past `_SUBSET_ABORT` from the seed.
        The seed's density is its sweep's: every column within 0.05 of the
        seed lies in a flagged block. Returns (medoid, its sweep)."""
        B = _SUBSET_BLOCK
        Q, nblk = self.Q, self.n_pad // B
        kb = Q // B
        kept_t, dev = self.kept_t, self.device
        d0, _, density, _ = sweep
        near = (d0 <= _MEDOID_RADIUS) & kept_t
        block_any = (kept_t & (d0 <= _SUBSET_RADIUS)).view(nblk, B).any(dim=1)
        # one host sync: neighbours to climb to, flagged blocks, and flagged
        # blocks before the seed's (its slot in the ball)
        n_near, nb, before = torch.stack([
            (near & (self.iota != seed)).sum(), block_any.sum(), block_any[: seed // B].sum()
        ]).tolist()
        if n_near == 0:
            return seed, sweep
        self.subset_counts["attempts"] += 1
        medoid = seed
        if nb <= kb:
            # the flagged block ids, ascending, built on the card with no
            # host sync: block b goes to slot (flagged blocks up to b) - 1;
            # unflagged blocks land in a spare slot kb that is cut off, and
            # the ball's padding slots gather block 0, masked by the gather
            dest = torch.where(block_any, torch.cumsum(block_any, 0) - 1, kb)
            bids = torch.zeros(kb + 1, dtype=torch.int32, device=dev)
            bids.scatter_(0, dest, torch.arange(nblk, dtype=torch.int32, device=dev))
            xsT, cols, kept_s, wk_s, d0_s = gather_ball(self.matrixT, bids[:kb], nb, wk, kept_t, d0)
            slot = before * B + seed % B
            tried_s = torch.zeros(Q, dtype=torch.bool, device=dev)
            tried_s[slot] = True
            d_s, drifted = d0_s, False
            while True:
                key, cand, cand_valid, dens = self._step(
                    key, d_s, kept_s, tried_s, slot, Q, xsT, wk_s)
                better = cand_valid & (dens > density)
                # one host sync per step: the winner, its slot and column,
                # and its drift (float64 holds all of them exactly)
                better_h, cand_h, col_h, drift_h = torch.stack(
                    [better.to(torch.float64), cand.to(torch.float64),
                     cols[cand].to(torch.float64), d0_s[cand].to(torch.float64)]
                ).cpu().numpy()
                if not better_h.any():
                    break
                j = int(np.argmax(better_h))
                tried_s[cand[: j + 1]] = True
                slot, medoid = int(cand_h[j]), int(col_h[j])
                d_s = row_sweep(xsT, slot)
                density = dens[j]
                if drift_h[j] > np.float32(_SUBSET_ABORT):
                    drifted = True
                    break
            if not drifted:
                return medoid, sweep if medoid == seed else medoid_sweep(self.matrixT, medoid, wk)
            self.subset_counts["drift"] += 1
            tried = torch.zeros(self.n_pad, dtype=torch.bool, device=dev)
            tried[cols[: nb * B]] = tried_s[: nb * B]
        else:  # the ball overflows: climb over all columns from the seed
            self.subset_counts["overflow"] += 1
            tried = torch.zeros(self.n_pad, dtype=torch.bool, device=dev)
            tried[seed] = True
        if medoid != seed:
            sweep = medoid_sweep(self.matrixT, medoid, wk)
        return self._climb(medoid, sweep, density, tried, key, wk)

    def __next__(self) -> Cluster:
        if self.n_remaining == 0:
            raise StopIteration
        if self._in_batch == self._batch_clusters:
            self._end_batch()
        while True:
            seed, seed_rank = self._next_seed()
            self.order_pos = seed_rank + 1
            wk = torch.where(self.kept_t, self.lengths, 0.0)  # kept is frozen per attempt
            sweep = medoid_sweep(self.matrixT, seed, wk)
            self.key, sub = threefry.split(self.key)
            if self.Q:
                medoid, sweep = self._wander_subset(seed, sweep, wk, sub)
            else:
                medoid, sweep = self._wander(seed, sweep, wk, sub)

            d, hist, _, n_close_t = sweep
            thr_t, opvr_t, found_t = find_threshold(hist, float(self.pvr))
            # one host sync for the attempt's decision
            n_close, thr, opvr, found = torch.stack(
                [n_close_t.to(torch.float32), thr_t, opvr_t, found_t.to(torch.float32)]
            ).cpu().numpy()

            if n_close == 1.0:  # loner (ref :457, :550-562)
                return self._emit(medoid, seed, np.array([medoid]), None, None)
            if not found:
                if self.pvr > np.float32(0.55):  # fallback (ref :566-580)
                    radius = np.float32(_DEFAULT_RADIUS)
                    return self._emit(
                        medoid, seed, self._members(d, radius), float(radius), None
                    )
                self._update_successes(False)  # reject (ref :582)
                continue
            rec = self._emit(
                medoid, seed, self._members(d, thr), float(thr), float(opvr)
            )
            if self.pvr < np.float32(0.55):  # ref :599-600
                self._update_successes(True)
            return rec

    def _members(self, d: torch.Tensor, radius: np.float32) -> np.ndarray:
        sel = (d <= float(radius)) & self.kept_t
        return torch.nonzero(sel).squeeze(1).cpu().numpy()

    def _emit(self, medoid, seed, members_rows, radius, observed_pvr) -> Cluster:
        "Cluster record with the pre-update successes/attempts (ref :551-598)."
        rec = Cluster(
            int(self._order[medoid]),
            int(self._order[seed]),
            self._order[members_rows].astype(np.int64),  # in engine column order
            float(self.pvr),
            observed_pvr,
            radius,
            self.successes,
            len(self.attempts),
        )
        self.kept[members_rows] = False
        self.kept_t[torch.as_tensor(members_rows, device=self.device)] = False
        self.n_remaining -= len(members_rows)
        self.n_emitted_clusters += 1
        self._in_batch += 1
        return rec


def _check_unported(distance_dtype, wander_kernel, wander_scope, attempt_batch):
    "Reject the `vamb_tpu` engine switches this port does not implement yet."
    if distance_dtype != "float32":
        if distance_dtype == "bfloat16":
            raise NotImplementedError(
                "bfloat16 distances are not ported yet (ROADMAP queue 1, item 4: "
                "bfloat16 distances)"
            )
        raise ValueError(f"distance_dtype must be float32/bfloat16, not {distance_dtype}")
    if wander_kernel != "auto":
        if wander_kernel in ("pallas", "xla"):
            raise NotImplementedError(
                f"wander_kernel={wander_kernel!r} names a TPU-package path; the "
                "port always uses its CUDA kernels on the card (pass 'auto')"
            )
        raise ValueError(f"wander_kernel must be auto/pallas/xla, not {wander_kernel}")
    if wander_scope not in ("auto", "subset", "full"):
        raise ValueError(f"wander_scope must be auto/subset/full, not {wander_scope}")
    if attempt_batch not in ("auto", "off"):
        if attempt_batch == "on":
            raise NotImplementedError(
                "attempt_batch='on' is not ported yet (ROADMAP queue 1, item 4: "
                "attempt lanes and the speculative seed cache)"
            )
        raise ValueError(f"attempt_batch must be auto/on/off, not {attempt_batch}")

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
device: seed rows and the medoid's row (`kernels.row_sweep`), the
per-step Gumbel top-k over the threefry stream, candidate densities
(`kernels.candidate_density_sweep`), the histogram, the banded smoothing
product and the valley scan. This is the full-scope wander of
`vamb_tpu` (`wander_scope="full"`, no attempt lanes, no compaction) on its
kernel branch (cluster.py:765-842).

The speculative seed cache and loner bursts of `vamb_tpu` change no
decision, so they are left out (ROADMAP queue 1, item 4, stage 3).

Random stream. Columns are padded to a multiple of 128 on every device
and the candidate Gumbel draws span the padded width, with one key split
per attempt and one split + one uniform per wander step, from jax's
threefry stream (utils/threefry.py) — so given a latent the port draws
exactly the candidates `vamb_tpu` draws on the CPU.
"""

from collections import deque
from math import ceil
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .kernels import candidate_density_sweep, row_sweep
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

# Histogram smoothing as one (60,)x(60,60) product with the banded Toeplitz
# matrix of the 31-tap kernel, as vamb_tpu/cluster.py:107-131 does.
_SMOOTH_MATRIX = np.zeros((_NBINS, _NBINS), np.float32)
for _i in range(_NBINS):
    for _j in range(_NBINS):
        if abs(_j - _i) <= 15:
            _SMOOTH_MATRIX[_i, _j] = _NORMALPDF[_j - _i + 15]
del _i, _j

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
    "The banded-matrix smoothing of the 60-bin histogram."
    return hist @ torch.as_tensor(_SMOOTH_MATRIX, device=hist.device)


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


def histogram(d: torch.Tensor, lengths: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
    """Length-weighted 60-bin histogram of kept distances in [0, 0.3], as a
    compare-and-reduce (a deterministic sum; no atomics)."""
    bins = torch.clamp((d / _DELTA_X).to(torch.int32), 0, _NBINS - 1)
    w = torch.where((d >= 0.0) & (d <= _XMAX) & kept, lengths, 0.0)
    sel = torch.nonzero(w).squeeze(1)
    onehot = bins[sel, None] == torch.arange(_NBINS, device=d.device)[None, :]
    return torch.where(onehot, w[sel, None], 0.0).sum(dim=0)


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
        device: "cuda" (default) or "cpu"

    The remaining `vamb_tpu` switches are accepted only at the values this
    port implements: `wander_scope` "auto"/"full" (auto means full until the
    subset wander is ported), `attempt_batch` "auto"/"off",
    `compact=False`, `distance_dtype="float32"`, `wander_kernel="auto"`.
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
        distance_dtype: str = "float32",
        wander_kernel: str = "auto",
        wander_scope: str = "auto",
        attempt_batch: str = "auto",
        compact: bool = False,
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
        if len(matrix) < 1:
            raise ValueError("Matrix must have at least 1 observation.")
        if len(lengths) != len(matrix):
            raise ValueError("N sequences in lengths and matrix do not match")
        _check_unported(distance_dtype, wander_kernel, wander_scope, attempt_batch, compact)
        self.device = resolve_device(device)

        if not normalized:
            matrix = normalize(matrix, inplace=destroy)

        n, f = matrix.shape
        n_pad = _pad_to(n, _LANES)
        f_pad = _pad_to(f, _SUBLANES)
        order, ranks_np = engine_order(matrix, lengths, rng_seed)
        padded_t = np.zeros((f_pad, n_pad), np.float32)
        padded_t[:f, :n] = matrix.T[:, order]
        self.ranks = np.arange(n_pad, dtype=np.int64) + RANK_PAD_BASE
        self.ranks[:n] = ranks_np

        dev = self.device
        self.matrixT = torch.as_tensor(padded_t, device=dev)
        self.lengths = torch.as_tensor(
            np.pad(lengths.astype(np.float32)[order], (0, n_pad - n)), device=dev
        )
        kept = np.zeros(n_pad, bool)
        kept[:n] = True
        self.kept = kept  # host mirror of kept_t
        self.kept_t = torch.as_tensor(kept, device=dev)
        self.iota = torch.arange(n_pad, device=dev)

        self.n_points = n
        self.n_pad = n_pad
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

    def __repr__(self) -> str:
        return (
            f"ClusterGenerator({self.n_points} points, "
            f"{self.n_emitted_clusters} clusters)"
        )

    def __iter__(self):
        return self

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

    def _wander(self, seed: int, d0: torch.Tensor, key: torch.Tensor):
        """First-improvement hill climb on local density (ref :415-450),
        drawing the candidates of each step from the threefry stream.

        Each step samples up to C eligible untried points by Gumbel top-k,
        gets all their densities from one `candidate_density_sweep`, jumps
        to the first candidate (in sampled order) that beats the current
        density, and takes the new medoid's distance row from `row_sweep`.
        Returns (medoid, d)."""
        kept_t, lengths, iota = self.kept_t, self.lengths, self.iota
        wk = torch.where(kept_t, lengths, 0.0)  # kept is frozen per attempt
        tried = torch.zeros(self.n_pad, dtype=torch.bool, device=self.device)
        tried[seed] = True
        near = (d0 <= _MEDOID_RADIUS) & kept_t
        density = torch.where(near, lengths * (_MEDOID_RADIUS - d0), 0.0).sum()
        if int((near & ~tried).sum()) == 0:
            return seed, d0

        medoid, d = seed, d0
        while True:
            key, k1 = threefry.split(key)
            u = threefry.uniform(k1, self.n_pad, self.device)
            elig = (d <= _MEDOID_RADIUS) & kept_t & ~tried & (iota != medoid)
            gumbel = -torch.log(-torch.log(u + 1e-20) + 1e-20)
            score = torch.where(elig, gumbel, -torch.inf)
            cand = torch.topk(score, self.C, sorted=True).indices
            cand_valid = elig[cand]
            dens = candidate_density_sweep(self.matrixT, cand, wk)
            better = cand_valid & (dens > density)
            # one host sync per step: which candidate (if any) won
            better_h = better.cpu().numpy()
            if better_h.any():
                j = int(np.argmax(better_h))
                tried[cand[: j + 1]] = True
                medoid = int(cand[j])
                d = row_sweep(self.matrixT, medoid)
                density = dens[j]
            else:
                return medoid, d

    def __next__(self) -> Cluster:
        if self.n_remaining == 0:
            raise StopIteration
        while True:
            seed, seed_rank = self._next_seed()
            self.order_pos = seed_rank + 1
            d0 = row_sweep(self.matrixT, seed)
            self.key, sub = threefry.split(self.key)
            medoid, d = self._wander(seed, d0, sub)

            kept_t = self.kept_t
            n_close_t = ((d < _MEDOID_RADIUS) & kept_t).sum()
            hist = histogram(d, self.lengths, kept_t)
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
        return rec


def _check_unported(distance_dtype, wander_kernel, wander_scope, attempt_batch, compact):
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
    if wander_scope not in ("auto", "full"):
        if wander_scope == "subset":
            raise NotImplementedError(
                "wander_scope='subset' is not ported yet (ROADMAP queue 1, item 4, "
                "stage 5: subset wander with gather_blocks)"
            )
        raise ValueError(f"wander_scope must be auto/subset/full, not {wander_scope}")
    if attempt_batch not in ("auto", "off"):
        if attempt_batch == "on":
            raise NotImplementedError(
                "attempt_batch='on' is not ported yet (ROADMAP queue 1, item 4, "
                "stage 5: attempt lanes)"
            )
        raise ValueError(f"attempt_batch must be auto/on/off, not {attempt_batch}")
    if compact:
        raise NotImplementedError(
            "compaction is not ported yet (ROADMAP queue 1, item 4, stage 4: "
            "compaction ladder)"
        )

"""Plain reference of Vamb's medoid clustering rule, to judge a job's
emitted clusters one by one (Nissen et al., Nat Biotechnol 2021;
vamb/cluster.py).

Points are L2-normalized latents (an all-zero row becomes uniform) scaled
by 1/sqrt(2), so the cosine distance is 0.5 - x.y. Clusters are emitted in
order, and the points a cluster takes leave the pool. So given the clusters
in emission order, the pool at cluster k is every point that no earlier
cluster took, and the rule is:

* a cluster takes exactly the pool's points within its radius of its
  medoid, the medoid among them;
* a normal cluster's radius is the threshold of the valley scan over the
  length-weighted 60-bin histogram of the pool's distances to its medoid
  up to 0.3, smoothed with the 31-tap N(0, 0.01) kernel: the first
  peak (not past x = 0.1), over once the density falls under 60% of it,
  then the last new minimum before a rise to 1.5 times the minimum. A
  fallback cluster (radius 0.06) comes only where that scan finds no
  threshold at the largest peak-valley ratio, 0.6;
* a loner takes its medoid alone, and no other pool point lies within the
  medoid radius 0.05 of it;
* every point ends in exactly one cluster.

The distances, histograms and scans are computed here in float64 from the
raw latent and lengths. A point on the wrong side of its cluster's radius
is misassigned; its gap is how far from the radius its distance lies.
Rounding in the program's float32 distances misassigns only points within
about 1e-6 of a radius. A radius is wrong where it is not the scan's
threshold; where moving every distance by `EDGE` moves the threshold (a
distance on a bin's edge), each of those thresholds is taken as right.
The medoid's choice (the wander) is not judged here.
"""

import numpy as np
import torch

LONER_RADIUS = 0.05
FALLBACK_RADIUS = 0.06
DELTA_X, XMAX, NBINS = 0.005, 0.3, 60
MAX_PVR = 0.6
EDGE = 1e-6
_PDF_X = np.arange(-15, 16) * DELTA_X
_PDF = DELTA_X / (0.01 * np.sqrt(2 * np.pi)) * np.exp(-0.5 * (_PDF_X / 0.01) ** 2)
# densities = histogram @ _SMOOTH: the kernel centred on each bin, zero past the ends
_SMOOTH = np.zeros((NBINS, NBINS))
for _i in range(NBINS):
    for _j in range(max(0, _i - 15), min(NBINS, _i + 16)):
        _SMOOTH[_i, _j] = _PDF[_j - _i + 15]
del _i, _j


def normalized(latent: np.ndarray, device) -> torch.Tensor:
    x = torch.as_tensor(latent, device=device, dtype=torch.float64)
    zero = (x == 0).all(dim=1)
    x[zero] = 1.0 / x.shape[1]
    return x / (x.norm(dim=1, keepdim=True) * np.sqrt(2.0))


def threshold_bin(densities) -> "int | None":
    """Vamb's valley scan of smoothed densities (60,) at the peak-valley
    ratio MAX_PVR: the bin of the threshold, or None where it finds none."""
    peak, peak_over, at_min, thr = 0.0, False, None, None
    x = 0.0
    for i, dens in enumerate(densities):
        if not peak_over and dens > peak:
            if x > 0.1:  # the first peak may not lie past x = 0.1
                return None
            peak = dens
        if not peak_over and dens < 0.6 * peak:
            peak_over, at_min = True, dens
        if peak_over and dens > 1.5 * at_min:  # a second peak ends the scan
            break
        if peak_over and dens < at_min:
            at_min = dens
            if dens < MAX_PVR * peak:
                thr = i
        x += XMAX / NBINS
    if thr is not None and thr * DELTA_X > 0.2 + MAX_PVR:
        return None
    return thr


def _histograms(d, pool, weights):
    "The (B, 60) length-weighted histograms of the pool's distances `d` (B, N) up to XMAX."
    inside = pool & (d >= 0) & (d <= XMAX)
    bins = torch.clamp(torch.floor(d / DELTA_X), 0, NBINS - 1).long()
    w = torch.where(inside, weights[None, :], torch.zeros_like(d))
    return torch.zeros((d.shape[0], NBINS), dtype=d.dtype, device=d.device).scatter_add_(1, bins, w)


def _radius_wrong(kind: str, radius, thresholds: set) -> bool:
    "A normal or fallback cluster's radius against the thresholds the scan gives."
    if kind == "fallback":
        return None not in thresholds
    return int(round(radius / DELTA_X)) not in thresholds


def check(latent: np.ndarray, lengths: np.ndarray, clusters: list, device,
          block: int = 128) -> dict:
    """Judge `clusters` [(medoid, members, radius or None, kind)] in
    emission order against the rule above, `kind` "normal", "fallback" or
    "loner". Returns the widest misassigned point's gap, the points in no
    cluster or in several, the clusters with a misassigned point, the
    normal and fallback clusters whose radius is wrong, and the clusters
    judged."""
    n = len(latent)
    x = normalized(latent, device)
    weights = torch.as_tensor(lengths, dtype=torch.float64, device=device)
    smooth = torch.as_tensor(_SMOOTH, device=device)
    owner = torch.full((n,), -1, dtype=torch.int64, device=device)
    doubled = 0
    for k, (_, members, *_) in enumerate(clusters):
        m = torch.as_tensor(np.asarray(members, np.int64), device=device)
        doubled += int((owner[m] >= 0).sum()) + (len(m) - len(torch.unique(m)))
        owner[m] = k
    missing = int((owner < 0).sum())
    # a point that two clusters took counts for the later one: the earlier
    # one is then judged as if it had not taken it
    gap, bad, radius_wrong = 0.0, 0, 0
    for lo in range(0, len(clusters), block):
        part = clusters[lo: lo + block]
        ks = torch.arange(lo, lo + len(part), device=device)
        med = torch.as_tensor([c[0] for c in part], device=device)
        radius = torch.as_tensor([LONER_RADIUS if c[2] is None else c[2] for c in part],
                                 dtype=torch.float64, device=device)
        d = 0.5 - x[med] @ x.T  # (B, N)
        d[torch.arange(len(part), device=device), med] = 0.0
        pool = (owner[None, :] >= ks[:, None]) | (owner[None, :] < 0)
        taken = owner[None, :] == ks[:, None]
        loner = torch.as_tensor([c[2] is None for c in part], device=device)[:, None]
        within = (d <= radius[:, None]) & pool
        itself = torch.nn.functional.one_hot(med, n).bool()
        # a cluster takes the pool within its radius; a loner takes itself,
        # and a pool point within 0.05 of it other than itself is misassigned
        wrong = torch.where(loner, (taken != itself) | (within & ~itself), taken != within)
        g = torch.where(wrong, (d - radius[:, None]).abs(), torch.zeros_like(d))
        gap = max(gap, float(g.max()))
        bad += int(wrong.any(dim=1).sum())
        scanned = [j for j, c in enumerate(part) if c[3] != "loner"]
        if scanned:
            rows = torch.as_tensor(scanned, device=device)
            dens = []
            for shift in (0.0, -EDGE, EDGE):
                moved = d[rows] + shift
                moved[torch.arange(len(scanned), device=device), med[rows]] = 0.0
                dens.append((_histograms(moved, pool[rows], weights) @ smooth).cpu().numpy())
            for r, j in enumerate(scanned):
                thresholds = {threshold_bin(v[r]) for v in dens}
                radius_wrong += _radius_wrong(part[j][3], part[j][2], thresholds)
    return {"misassigned_gap": gap, "partition_errors": doubled + missing,
            "clusters_wrong": bad, "radius_errors": radius_wrong, "clusters": len(clusters)}

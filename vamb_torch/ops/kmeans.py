"""Weighted K-means (Lloyd's algorithm) in torch, on the card or the CPU.

Port of `vamb_tpu/ops/kmeans.py`, which replaces the reference's
sklearn.cluster.KMeans in reclustering (reference vamb/reclustering.py:
141-147: explicit init centers, n_init=1, length sample weights), with its
semantics: squared-Euclidean assignment, weighted centroid update, an
empty cluster keeps its previous center (sklearn would reassign the
farthest point), convergence when the squared center shift falls below
tol * mean(var(X, axis=0)), at most 300 iterations, then a final
assignment against the converged centers. The products are f32 matmuls
with no TF32 (`device.resolve_device` turns it off on the card); rows are
not padded (`vamb_tpu` pads them to a power of two for XLA's compile cache,
with zero weights that change no sum).
"""

import numpy as np
import torch

from ..device import resolve_device


def _assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    d2 = (
        torch.sum(x * x, dim=1, keepdim=True)
        - 2 * (x @ centers.T)
        + torch.sum(centers * centers, dim=1)[None, :]
    )
    return torch.argmin(d2, dim=1)


def _update(x, w, centers, labels, n_clusters: int) -> torch.Tensor:
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(x.dtype) * w[:, None]
    sums = onehot.T @ x
    counts = torch.sum(onehot, dim=0)
    return torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts, min=1e-30)[:, None], centers
    )


def kmeans(
    x: np.ndarray,
    n_clusters: int,
    init_centers: np.ndarray,
    sample_weight: np.ndarray,
    tol: float = 1e-4,
    max_iter: int = 300,
    device="cuda",
) -> np.ndarray:
    "Weighted K-means labels for `x` given explicit initial centers."
    x = np.asarray(x, np.float32)
    assert init_centers.shape == (n_clusters, x.shape[1])
    dev = resolve_device(device)
    scaled_tol = np.float32(tol * float(np.mean(np.var(x, axis=0))))
    xt = torch.as_tensor(x, device=dev)
    w = torch.as_tensor(np.asarray(sample_weight).astype(np.float32), device=dev)
    centers = torch.as_tensor(init_centers.astype(np.float32), device=dev)
    labels = _assign(xt, centers)
    centers = _update(xt, w, centers, labels, n_clusters)
    for _ in range(1, max_iter):
        labels = _assign(xt, centers)
        new_centers = _update(xt, w, centers, labels, n_clusters)
        shift = torch.sum(torch.square(new_centers - centers))
        centers = new_centers
        if float(shift) <= scaled_tol:  # one host sync an iteration
            break
    return _assign(xt, centers).cpu().numpy()

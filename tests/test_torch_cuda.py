"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor vamb_tpu, so it also runs on a machine
that has only PyTorch; there, skip the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Without a card each test skips: a CUDA kernel has no CPU mode. Tolerances
are chip_smoke.py's: distances atol 1e-6 with d[idx] == 0.0 exactly (both
sides add the same products in the same order), densities and histograms
rtol 1e-5 (the kernels sum in another order than the plain versions), the
gather array-equal, medoid_sweep's row equal to row_sweep's and its close
count exact.
"""

import numpy as np
import pytest
import torch

from vamb_torch import kernels as K


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _clumpy(n, f, seed):
    "(f, n) float32 columns of norm 1/sqrt(2) in tight clumps, as the engine's latents."
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(max(1, n // 100), f))
    x = centers[rng.integers(0, len(centers), n)] + rng.normal(scale=0.03, size=(n, f))
    x /= np.linalg.norm(x, axis=1, keepdims=True) * np.sqrt(2)
    lengths = rng.integers(2000, 50_000, n).astype(np.float32)
    return np.ascontiguousarray(x.T.astype(np.float32)), lengths


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100_000, 100_003, 300_032])
def test_row_sweep_matches_plain(cuda, n):
    mT = torch.as_tensor(_clumpy(n, 32, seed=n)[0], device=cuda)
    for idx in (0, 37, n - 1):
        d = K.row_sweep(mT, idx)
        torch.testing.assert_close(d, K.row_sweep_plain(mT, idx), atol=1e-6, rtol=0)
        assert float(d[idx]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100_000, 100_003, 300_032])
@pytest.mark.parametrize("zero_half", [False, True])
def test_candidate_density_matches_plain(cuda, n, zero_half):
    mT_np, lengths = _clumpy(n, 32, seed=n)
    rng = np.random.default_rng(n + 1)
    if zero_half:
        lengths[rng.permutation(n)[: n // 2]] = 0.0
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    for c in (1, 25, 32):
        cand = torch.as_tensor(rng.choice(n, size=c, replace=False), device=cuda)
        torch.testing.assert_close(
            K.candidate_density_sweep(mT, cand, w), K.candidate_density_plain(mT, cand, w),
            rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pad", [128 * 64, 300_032])
def test_gather_blocks_matches_plain(cuda, n_pad):
    rng = np.random.default_rng(n_pad)
    mT = torch.as_tensor(rng.normal(size=(32, n_pad)).astype(np.float32), device=cuda)
    nb = n_pad // 128
    for ids in (np.sort(rng.choice(nb, 64, replace=False)), np.array([5, 0, 0, nb - 1])):
        bids = torch.as_tensor(ids.astype(np.int32), device=cuda)
        assert torch.equal(K.gather_blocks(mT, bids), K.gather_blocks_plain(mT, bids))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100_000, 300_032])
@pytest.mark.parametrize("zero_half", [False, True])
def test_medoid_sweep_matches_plain(cuda, n, zero_half):
    mT_np, lengths = _clumpy(n, 32, seed=n)
    if zero_half:
        lengths[np.random.default_rng(n).permutation(n)[: n // 2]] = 0.0
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    for idx in (0, 37, n - 1):
        d, hist, dens, n_close = K.medoid_sweep(mT, idx, w)
        d_p, hist_p, dens_p, close_p = K.medoid_sweep_plain(mT, idx, w)
        assert torch.equal(d, K.row_sweep(mT, idx)) and float(d[idx]) == 0.0
        torch.testing.assert_close(d, d_p, atol=1e-6, rtol=0)
        torch.testing.assert_close(hist, hist_p, rtol=1e-5, atol=0)
        torch.testing.assert_close(dens, dens_p, rtol=1e-5, atol=0)
        assert int(n_close) == int(close_p)

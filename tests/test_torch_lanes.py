"""The clustering engine's seed cache, loner bursts and attempt lanes, and
the two kernels they run on, held against vamb_tpu on the CPU.

* `spec_sweep` and `row_stats` (their plain versions, which the wrappers
  run for CPU tensors) against `medoid_sweep_plain` column by column, bit
  for bit: each row and its histogram, density and close count are what
  `medoid_sweep` gives for that column (for `row_stats`, for a column
  whose row is the given one), at S 1, 3 and 8, with all and with half the
  points removed; the near count is the count of kept columns within 0.05.
  A row does not depend on the other columns of its batch (the port's
  counterpart of tests/test_cluster.py::test_batched_row_composition_independent),
  and the rows agree with `vamb_tpu`'s `spec_batch` expression
  (cluster.py:498-515, jitted) within atol 2e-7, as `row_sweep` does.
* The batched valley scan: each row of a batch equals the scan of that
  histogram alone and `vamb_tpu`'s `_find_threshold_device` under `jax.jit`.
* The engine against `vamb_tpu.cluster.ClusterGenerator(...,
  compact_async=False)` with the same `attempt_batch` ("on" and "off"),
  field by field as tests/test_torch_cluster.py compares, on: clumps with
  noise; vamb_tpu's rejection-heavy inputs (900 uniform points in 32
  dimensions: every point is a loner, so one burst after another empties
  the run) and the same uniform regime in 8 dimensions, where rejections
  bump the pvr and a bump cuts the lanes after it; one dense clump a
  lane's ball overflows (its lanes need the full climb); a loner tail of
  clumps and isolated points, run to the end in batches of 8 clusters, so
  bursts stop at the batch's capacity; and the compaction ladder at subset
  scope, which empties the cache at each compaction. Each run states which
  of the lanes' cut reasons and bursts it reached. Then the port's "on",
  "off" and "auto" runs emit alike.

The CUDA kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vamb_torch import cluster as t_cluster
from vamb_torch import kernels as K
from vamb_torch.cluster import ClusterGenerator as TorchGenerator

from vamb_tpu import cluster as j_cluster

from .test_parity_cluster import clumpy_latents
from .test_torch_cluster import _LIKE_JAX, _assert_same_emission, _clumpy_data


def _batch_inputs(n, seed, removed):
    "Clumpy normalized columns and their weights, half of them 0 where points are `removed`."
    mT, lengths = _clumpy_data(n, seed=seed)
    wts = lengths.astype(np.float32)
    if removed:
        wts[np.random.default_rng(seed).permutation(n)[: n // 2]] = 0.0
    return torch.from_numpy(mT), torch.from_numpy(wts)


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("removed", [False, True])
def test_spec_sweep_and_row_stats_equal_medoid_sweep(s, removed):
    n = 5 * 256 + 3  # pads the tile layout, several CTAs
    mT, wts = _batch_inputs(n, seed=s, removed=removed)
    cols = [int(c) for c in np.random.default_rng(s).choice(n, s, replace=False)]
    cols[-1] = n - 1
    rows, hist, dens, n_close, n_near = K.spec_sweep(mT, cols, wts)
    assert rows.shape == (s, n) and hist.shape == (s, 60)
    assert n_close.dtype == torch.int32 and n_near.dtype == torch.int32
    stats = K.row_stats(rows.contiguous(), wts)
    for j, col in enumerate(cols):
        d, h, dn, c = K.medoid_sweep(mT, col, wts)
        assert torch.equal(rows[j], d) and float(rows[j, col]) == 0.0
        assert torch.equal(hist[j], h) and torch.equal(dens[j], dn) and torch.equal(n_close[j], c)
        assert int(n_near[j]) == int(((d <= 0.05) & (wts > 0)).sum())
        for got, want in zip(stats, (hist, dens, n_close, n_near)):
            assert torch.equal(got[j], want[j])
    assert int(n_near.max()) > 1 and float(hist.sum()) > 0  # neighbours within 0.05, a histogram


@pytest.mark.parametrize("trial", range(3))
def test_spec_sweep_row_is_composition_independent(trial):
    "A row depends only on its own column: alone, with others, repeated."
    n = 2048
    mT, wts = _batch_inputs(n, seed=10 + trial, removed=False)
    rng = np.random.default_rng(trial)
    cols = [int(c) for c in rng.integers(0, n, 8)]
    batch = K.spec_sweep(mT, cols, wts)
    for j, col in enumerate(cols):
        for other in ([col], [col] * 8, [int(rng.integers(n)), col, int(rng.integers(n))]):
            alone = K.spec_sweep(mT, other, wts)
            k = other.index(col)
            for a, b in zip(batch, alone):
                assert torch.equal(a[j], b[k]), (trial, j, other)


@pytest.mark.parametrize("s", [1, 3, 8])
def test_spec_sweep_rows_match_vamb_tpu_spec_batch(s):
    """`vamb_tpu`'s speculative rows (spec_batch, cluster.py:498-515: one
    HIGHEST-precision einsum, self-distances zeroed) within atol 2e-7, the
    tolerance `row_sweep` is held to."""
    n = 4096
    mT, wts = _batch_inputs(n, seed=20 + s, removed=False)

    @jax.jit
    def spec_batch(matrixT, seeds):
        rows = matrixT[:, seeds]
        D = 0.5 - jnp.einsum("fc,fn->cn", rows, matrixT, precision=jax.lax.Precision.HIGHEST,
                             preferred_element_type=jnp.float32)
        iota = jnp.arange(matrixT.shape[1])
        return jnp.where(iota[None, :] == seeds[:, None], 0.0, D)

    cols = np.random.default_rng(s).choice(n, s, replace=False).astype(np.int32)
    want = np.asarray(spec_batch(jnp.asarray(mT.numpy()), jnp.asarray(cols)))
    got = K.spec_sweep(mT, cols.tolist(), wts)[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-7)
    assert (got[np.arange(s), cols] == 0.0).all()


@pytest.mark.parametrize("pvr", [0.1, 0.3, 0.6])
def test_find_threshold_batched_rows_are_each_rows_own(pvr):
    """The lanes' batched valley scan: row r of a batch is the scan of
    histogram r alone, and `vamb_tpu`'s jitted `_find_threshold_device`,
    bit for bit (on engine-like histograms: one or two peaks, empty bins)."""
    rng = np.random.default_rng(int(pvr * 10))
    x = np.arange(60)
    hist = np.stack([
        np.exp(-(x - rng.integers(0, 20)) ** 2 / rng.uniform(2, 40)) * 1e6
        + np.exp(-(x - rng.integers(20, 60)) ** 2 / rng.uniform(2, 40)) * rng.uniform(0, 1e6)
        for _ in range(64)]).astype(np.float32)
    hist[rng.random(hist.shape) < 0.2] = 0.0
    thr, opvr, found = t_cluster.find_threshold(torch.as_tensor(hist), pvr)
    scan = jax.jit(j_cluster._find_threshold_device)
    assert 0 < int(found.sum()) < len(hist)
    for r, h in enumerate(hist):
        one = t_cluster.find_threshold(torch.as_tensor(h), pvr)
        want = scan(jnp.asarray(h), jnp.float32(pvr))
        for got, a, b in zip((thr, opvr, found), one, want):
            assert got[r].numpy().tobytes() == a.numpy().tobytes() == np.asarray(b).tobytes(), r


# -------------------------------------------------------------- engine


def _uniform(n, dim, seed):
    rng = np.random.default_rng(seed)
    matrix = rng.normal(size=(n, dim)).astype(np.float32)
    return matrix, rng.integers(2000, 10_000, n).astype(np.float32)


def _dense_clumps(n_clumps, per, seed):
    "Tight 16-wide clumps, each larger than a 512-column ball."
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clumps, 16))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    matrix = np.concatenate([c + 0.02 * rng.normal(size=(per, 16)) for c in centers])
    return matrix.astype(np.float32), rng.integers(2000, 50_000, len(matrix)).astype(np.float32)


def _loner_tail(n_clumps, per, n_isolated, seed):
    "Clumps and isolated random directions (about 0.5 apart in 32 dimensions: loners)."
    matrix, lengths = clumpy_latents(n_clumps, per, 32, seed=seed)
    rng = np.random.default_rng(seed + 1)
    loners = rng.normal(size=(n_isolated, 32)).astype(np.float32)
    return (np.concatenate([matrix, loners]),
            np.concatenate([lengths, rng.integers(2000, 50_000, n_isolated).astype(np.float32)]))


# label: (data, generator arguments, patched module constants, the lane
# counters and subset fallbacks the run with lanes on must reach)
_REGIMES = {
    "clumps with noise": (
        lambda: clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2),
        {"rng_seed": 7, "windowsize": 60, "wander_scope": "subset"}, {},
        ("admitted", "cut_conflict", "bursts")),
    "uniform, vamb_tpu's rejection-heavy inputs": (
        lambda: _uniform(900, 32, seed=31),
        {"rng_seed": 11, "windowsize": 40, "minsuccesses": 5, "wander_scope": "subset"}, {},
        ("burst_loners", "refills")),
    "uniform in 8 dimensions: pvr bumps": (
        lambda: _uniform(600, 8, seed=31),
        {"rng_seed": 11, "windowsize": 40, "minsuccesses": 5, "wander_scope": "subset"}, {},
        ("admitted", "cut_pvr", "cut_conflict", "cut_full")),
    "dense clumps: lanes overflow": (
        lambda: _dense_clumps(6, 600, seed=8),
        {"rng_seed": 3, "wander_scope": "subset"}, {"_SUBSET_Q": 1 << 9},
        ("cut_full", "overflow")),
    "loner tail in batches of 8": (
        lambda: _loner_tail(20, 25, 700, seed=5),
        {"rng_seed": 5, "batch_clusters": 8, "compact": False, "wander_scope": "subset"}, {},
        ("burst_loners", "burst_capacity_stops", "admitted")),
    "compaction ladder at subset scope": (
        lambda: clumpy_latents(70, 30, 32, seed=5),
        {"rng_seed": 5, "compact": True, "compact_min_pad": 128, "batch_clusters": 8,
         "wander_scope": "subset"}, {"_SUBSET_Q": 1 << 9},
        ("admitted", "refills")),
}


@pytest.fixture
def patch_both(monkeypatch):
    "Set a module constant of both engines for the test's duration."
    def patch(name, value):
        monkeypatch.setattr(j_cluster, name, value)
        monkeypatch.setattr(t_cluster, name, value)
    return patch


@pytest.mark.parametrize("attempt_batch", ["on", "off"])
@pytest.mark.parametrize("regime", list(_REGIMES))
def test_engine_matches_vamb_tpu(regime, attempt_batch, patch_both):
    data, kwargs, consts, reached = _REGIMES[regime]
    for name, value in consts.items():
        patch_both(name, value)
    matrix, lengths = data()
    gen = _assert_same_emission(matrix, lengths, jax_kwargs=_LIKE_JAX,
                                attempt_batch=attempt_batch, **kwargs)
    counts = {**gen.lane_counts, **gen.subset_counts}
    if attempt_batch == "off":
        assert counts["passes"] == 0, counts
        reached = [k for k in reached if k not in gen.lane_counts or k.startswith(("burst", "refill"))]
    assert all(counts[k] > 0 for k in reached), (reached, counts)
    if regime.startswith("compaction"):
        assert [c[1:] for c in gen.compactions] == [(2176, 1024), (1024, 512)]


@pytest.mark.parametrize("regime", ["clumps with noise", "uniform in 8 dimensions: pvr bumps"])
def test_attempt_batch_settings_emit_alike(regime):
    "The port's 'on', 'off' and 'auto' runs (auto: lanes at subset scope) emit alike."
    data, kwargs, _, _ = _REGIMES[regime]
    matrix, lengths = data()
    runs = {ab: list(TorchGenerator(matrix.copy(), lengths, device="cpu", attempt_batch=ab, **kwargs))
            for ab in ("on", "off", "auto")}
    fields = lambda c: (c.medoid, c.seed, c.kind_str, c.radius, c.observed_pvr,  # noqa: E731
                        c.maximal_pvr, c.successes, c.attempts, c.members.tolist())
    on, off, auto = ([fields(c) for c in runs[ab]] for ab in ("on", "off", "auto"))
    assert on == off == auto and len(on) > 0

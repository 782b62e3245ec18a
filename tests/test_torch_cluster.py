"""The port's clustering engine and its kernels held against vamb_tpu.

* The plain versions of `row_sweep` / `candidate_density_sweep` (what the
  wrappers run for CPU tensors) against `vamb_tpu.ops.pallas_cluster` in
  interpret mode, as tests/test_pallas.py runs the Pallas kernels, with that
  file's tolerances: d atol 2e-7 and d[idx] == 0.0 exactly, densities
  rtol 1e-5 (f32 sums in another order). The density's plain version sums
  in the CUDA kernel's order: held against a float64 sum (rtol 1e-6) and,
  on a case whose f32 sum depends on the order, against a scalar
  simulation of the order the CUDA source describes.
* `gather_blocks` / `medoid_sweep` plain versions against the same
  module's interpret-mode kernels: the gather array-equal, medoid_sweep
  with test_pallas.py's tolerances (d atol 2e-7, hist rtol 1e-6, density
  rtol 1e-5, n_close exact). medoid_sweep's plain version sums in the CUDA
  kernel's order: held against float64 sums (rtol 1e-6) and, on a case
  whose f32 sums depend on the order, against a numpy simulation of the
  order the CUDA source describes. `gather_ball`'s side vectors against
  `vamb_tpu`'s takes and masks (cluster.py:604-606, 654-656), array-equal.
* The engine on the CPU against `vamb_tpu.cluster.ClusterGenerator` with
  `compact_async=False`, field by field as tests/test_parity_cluster.py's
  `assert_same_emission` compares: members (in emission order), medoid,
  seed and kind exactly, radius atol 1e-7, observed pvr rtol 1e-5, pvr
  atol 1e-6. First the full-scope regimes of that file; then the subset
  wander on its regimes (both engines with attempt lanes left at auto, so
  on at subset scope; tests/test_torch_lanes.py holds "on" and "off"), the
  compaction ladder, and auto scope with
  the subset floor patched low on both packages, so that the subset wander,
  the ladder and the switch back to full sweeps all happen in one run.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vamb_torch import kernels as K
from vamb_torch.cluster import ClusterGenerator as TorchGenerator
from vamb_torch.cluster import engine_order, normalize
from vamb_torch import cluster as t_cluster

from vamb_tpu import cluster as j_cluster
from vamb_tpu.ops import pallas_cluster as P

from .test_parity_cluster import clumpy_latents


def _data(n, f=40, seed=0):
    "tests/test_pallas.py's make_data: normalized columns, ~10% zero weights."
    rng = np.random.default_rng(seed)
    m = rng.normal(size=(n, 32)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True) * np.sqrt(2)
    mT = np.zeros((f, n), np.float32)
    mT[:32] = m.T
    wts = np.where(rng.random(n) < 0.9, rng.integers(2000, 50_000, n), 0).astype(np.float32)
    return mT, wts


def _clumpy_data(n, seed):
    "Columns in tight clumps, so densities sum many terms (engine-like)."
    m, lengths = clumpy_latents(-(-n // 30), 30, 32, seed=seed)
    mT = np.ascontiguousarray(normalize(m[:n]).T)
    return mT, lengths[:n]


# ------------------------------------------------------------- kernels


@pytest.mark.parametrize("idx", [0, 123, 4095])
def test_row_sweep_plain_matches_pallas(idx):
    n = P.pallas_pad_multiple()
    mT, _ = _data(n, seed=3)
    expect = np.asarray(P.row_sweep(jnp.asarray(mT), idx, interpret=True))
    got = K.row_sweep(torch.from_numpy(mT), idx).numpy()
    np.testing.assert_allclose(got, expect, atol=2e-7)
    assert got[idx] == 0.0


@pytest.mark.parametrize("c", [1, 7, 25, 32])
@pytest.mark.parametrize("clumpy", [False, True])
def test_candidate_density_plain_matches_pallas(c, clumpy):
    n = P.pallas_pad_multiple()
    if clumpy:
        mT, lengths = _clumpy_data(n, seed=c)
        wts = np.where(np.arange(n) % 3 == 0, 0.0, lengths).astype(np.float32)
    else:
        mT, wts = _data(n, seed=2)
    cand = np.random.default_rng(c).choice(n, size=c, replace=False).astype(np.int32)
    expect = np.asarray(P.candidate_density_sweep(
        jnp.asarray(mT), jnp.asarray(cand), jnp.asarray(wts), interpret=True))
    got = K.candidate_density_sweep(
        torch.from_numpy(mT), torch.from_numpy(cand), torch.from_numpy(wts)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def _density_terms(mT, cand, wts):
    "The masked density terms (C, N) in numpy f32, feature-ordered like the contract."
    rows = mT[:, cand]
    dot = np.zeros((len(cand), mT.shape[1]), np.float32)
    for f in range(mT.shape[0]):
        dot = dot + rows[f][:, None] * mT[f][None, :]
    D = np.float32(0.5) - dot
    D[np.arange(len(cand)), cand] = 0.0
    within = (D <= np.float32(0.05)) & (wts > 0)[None, :]
    return np.where(within, wts[None, :] * (np.float32(0.05) - D), np.float32(0.0))


def _simulated_density_order(terms):
    """Row sums of (C, N) f32 terms in the order the CUDA source's note
    describes, one scalar add at a time: tiles of 256 columns (thread tid
    owns columns 2*tid and 2*tid+1 of a tile), K = ceil(T/256) tiles a
    column CTA, B = ceil(T/K) CTAs, CTA b taking tiles b, b+B, ...; each
    thread adds in order from 0, then halving trees over 32 lanes, 4 warps
    and 256 CTA slots (zeros past B)."""
    def tree(xs):
        while len(xs) > 1:
            h = len(xs) // 2
            xs = [np.float32(xs[i] + xs[i + h]) for i in range(h)]
        return xs[0]

    c, n = terms.shape
    tiles = -(-n // 256)
    k = -(-tiles // 256)
    b_count = -(-tiles // k)
    out = []
    for row in terms:
        ctas = []
        for b in range(b_count):
            threads = []
            for tid in range(128):
                acc = np.float32(0.0)
                for t in range(b, tiles, b_count):
                    for v in range(2):
                        col = t * 256 + 2 * tid + v
                        if col < n:
                            acc = np.float32(acc + row[col])
                threads.append(acc)
            warps = [tree(threads[w * 32:(w + 1) * 32]) for w in range(4)]
            ctas.append(tree(warps))
        out.append(tree(ctas + [np.float32(0.0)] * (256 - b_count)))
    return np.array(out, np.float32)


@pytest.mark.parametrize("n", [1_000, 5 * 256 + 3, 140_000])
def test_candidate_density_plain_sums_accurately(n):
    """The ordered plain version against a float64 sum of the same f32
    terms, at widths that pad the tile layout, span several column CTAs
    and (140,000: 547 tiles) give a CTA more than one tile."""
    mT, lengths = _clumpy_data(n, seed=n)
    wts = np.where(np.arange(n) % 4 == 1, 0.0, lengths).astype(np.float32)
    cand = np.random.default_rng(n).choice(n, size=6, replace=False)
    got = K.candidate_density_plain(torch.from_numpy(mT), torch.from_numpy(cand),
                                    torch.from_numpy(wts)).numpy()
    expect = _density_terms(mT, cand, wts).astype(np.float64).sum(axis=1)
    assert (expect > 0).all()
    np.testing.assert_allclose(got, expect, rtol=1e-6)


@pytest.mark.parametrize("n", [4 * 256 + 100, 140_000])
def test_candidate_density_plain_sums_in_the_kernels_order(n):
    """A constructed case whose f32 sum depends on the order: every column
    equals the candidate's (D = 0 exactly), so the terms are w * 0.05 with
    a few weights of 1e9 among small ones. The plain version must give the
    bits of the order the CUDA source describes, which differ from a
    left-to-right sum."""
    rng = np.random.default_rng(n)
    mT = np.zeros((8, n), np.float32)
    mT[:2] = 0.5  # |x|^2 = 0.5 exactly, so D = 0.5 - 0.5 = 0
    wts = rng.integers(1, 1000, n).astype(np.float32)
    wts[rng.choice(n, 5, replace=False)] = 1e9
    wts[rng.random(n) < 0.1] = 0.0
    cand = np.array([0, n - 1])
    terms = _density_terms(mT, cand, wts)
    got = K.candidate_density_plain(torch.from_numpy(mT), torch.from_numpy(cand),
                                    torch.from_numpy(wts)).numpy()
    np.testing.assert_array_equal(got, _simulated_density_order(terms))
    left_to_right = np.cumsum(terms, axis=1, dtype=np.float32)[:, -1]
    assert not np.array_equal(got, left_to_right)


@pytest.mark.parametrize("kb", [4, 64])
def test_gather_blocks_plain_matches_pallas(kb):
    "tests/test_pallas.py's gather contract: array-equal."
    rng = np.random.default_rng(3)
    f_pad, nb = 32, 256
    mT = rng.normal(size=(f_pad, nb * 128)).astype(np.float32)
    bids = np.sort(rng.choice(nb, kb, replace=False)).astype(np.int32)
    expect = np.asarray(P.gather_blocks(jnp.asarray(mT), jnp.asarray(bids), block=128,
                                        interpret=True))
    got = K.gather_blocks(torch.from_numpy(mT), torch.from_numpy(bids)).numpy()
    np.testing.assert_array_equal(got, expect)


def test_gather_blocks_plain_repeated_ids():
    "Overflow clamping repeats block 0; the copy must still be exact."
    rng = np.random.default_rng(4)
    mT = rng.normal(size=(32, 64 * 128)).astype(np.float32)
    bids = np.array([5, 0, 0, 63], np.int32)
    expect = np.asarray(P.gather_blocks(jnp.asarray(mT), jnp.asarray(bids), block=128,
                                        interpret=True))
    got = K.gather_blocks(torch.from_numpy(mT), torch.from_numpy(bids)).numpy()
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("idx,removed", [(0, False), (37, False), (4095, False), (5, True)])
def test_medoid_sweep_plain_matches_pallas(idx, removed):
    """tests/test_pallas.py's tolerances: d atol 2e-7, hist rtol 1e-6,
    density rtol 1e-5, n_close exact; d[idx] == 0.0."""
    n = P.pallas_pad_multiple()
    mT, wts = _data(n, seed=1 if removed else 0)
    if removed:
        wts[: n // 2] = 0.0  # half the points removed
    d_j, hist_j, dens_j, close_j = P.medoid_sweep(jnp.asarray(mT), idx, jnp.asarray(wts),
                                                  interpret=True)
    d, hist, dens, n_close = K.medoid_sweep(torch.from_numpy(mT), idx, torch.from_numpy(wts))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=2e-7)
    assert float(d[idx]) == 0.0
    np.testing.assert_array_equal(d.numpy(), K.row_sweep(torch.from_numpy(mT), idx).numpy())
    np.testing.assert_allclose(hist.numpy(), np.asarray(hist_j), rtol=1e-6)
    np.testing.assert_allclose(float(dens), float(dens_j), rtol=1e-5)
    assert int(n_close) == int(close_j) and n_close.dtype == torch.int32


def _sweep_terms(mT, idx, wts):
    """numpy f32: the medoid's row (feature-ordered, as the contract) and the
    (61, N) terms of its 60 histogram bins and its density."""
    col = mT[:, idx]
    acc = np.zeros(mT.shape[1], np.float32)
    for f in range(mT.shape[0]):
        acc = acc + mT[f] * col[f]
    d = np.float32(0.5) - acc
    d[idx] = 0.0
    pos = wts > 0
    bins = np.clip((d / np.float32(0.005)).astype(np.int32), 0, 59)
    in_hist = (d >= 0) & (d <= np.float32(0.3)) & pos
    terms = np.zeros((61, len(d)), np.float32)
    terms[bins[in_hist], np.flatnonzero(in_hist)] = wts[in_hist]
    terms[60] = np.where((d <= np.float32(0.05)) & pos, wts * (np.float32(0.05) - d), 0)
    return d, terms


def _simulated_sweep_order(terms):
    """Row sums of (R, N) f32 terms in the order medoid_sweep's CUDA note
    describes, one f32 add at a time (all rows at once): tiles of 256
    columns (thread tid owns columns 4*tid .. 4*tid+3 of a tile), K =
    ceil(T/128) tiles a CTA, B = ceil(T/K) CTAs, CTA b taking tiles b, b+B,
    ...; each thread adds in order from 0, then halving trees over its 64
    threads and over 128 CTA slots (zeros past B)."""
    def tree(xs):
        while len(xs) > 1:
            h = len(xs) // 2
            xs = [xs[i] + xs[i + h] for i in range(h)]
        return xs[0]

    r, n = terms.shape
    tiles = -(-n // 256)
    k = -(-tiles // 128)
    b_count = -(-tiles // k)
    ctas = []
    for b in range(b_count):
        threads = []
        for tid in range(64):
            acc = np.zeros(r, np.float32)
            for t in range(b, tiles, b_count):
                for v in range(4):
                    col = t * 256 + 4 * tid + v
                    if col < n:
                        acc = acc + terms[:, col]
            threads.append(acc)
        ctas.append(tree(threads))
    return tree(ctas + [np.zeros(r, np.float32)] * (128 - b_count))


@pytest.mark.parametrize("n", [4 * 256 + 100, 70_000])
def test_medoid_sweep_plain_sums_in_the_kernels_order(n):
    """A constructed case whose f32 sums depend on the order: columns on a
    circle through the medoid at distances spread over every bin and past
    0.3, weights of 1e9 among small ones. The plain version's histogram and
    density must be the bits of the order the CUDA source describes, which
    differ from left-to-right sums (70,000 columns: three tiles a CTA)."""
    rng = np.random.default_rng(n)
    d_target = rng.uniform(0.0, 0.4, n).astype(np.float64)
    a = (0.5 - d_target) / np.sqrt(0.5)  # medoid (sqrt(.5), 0): d = 0.5 - sqrt(.5) a
    mT = np.zeros((8, n), np.float32)
    mT[0] = a
    mT[1] = np.sqrt(np.maximum(0.5 - a * a, 0.0))
    mT[:, 0] = (np.sqrt(0.5), 0.0, 0, 0, 0, 0, 0, 0)
    wts = rng.integers(1, 1000, n).astype(np.float32)
    wts[rng.choice(n, 40, replace=False)] = 1e9
    wts[rng.random(n) < 0.1] = 0.0
    d, terms = _sweep_terms(mT, 0, wts)
    got_d, hist, dens, n_close = K.medoid_sweep_plain(torch.from_numpy(mT), 0, torch.from_numpy(wts))
    np.testing.assert_array_equal(got_d.numpy(), d)
    got = np.concatenate([hist.numpy(), [float(dens)]]).astype(np.float32)
    np.testing.assert_array_equal(got, _simulated_sweep_order(terms))
    assert int(n_close) == int(((d < np.float32(0.05)) & (wts > 0)).sum())
    assert (hist.numpy() > 0).sum() == 60
    left_to_right = np.cumsum(terms, axis=1, dtype=np.float32)[:, -1]
    assert not np.array_equal(got, left_to_right)


@pytest.mark.parametrize("n", [1_000, 5 * 256 + 3, 140_000])
@pytest.mark.parametrize("zero_half", [False, True])
def test_medoid_sweep_plain_sums_accurately(n, zero_half):
    """The ordered plain version against float64 sums of the same f32
    terms (rtol 1e-6), at widths that pad the tile layout, span several
    CTAs and (140,000: 547 tiles) give a CTA five tiles; its row
    equal to `row_sweep`'s; all and half the weights."""
    mT, lengths = _clumpy_data(n, seed=n)
    wts = lengths.astype(np.float32)
    if zero_half:
        wts[np.random.default_rng(n).permutation(n)[: n // 2]] = 0.0
    idx = n // 3
    d, terms = _sweep_terms(mT, idx, wts)
    got_d, hist, dens, n_close = K.medoid_sweep_plain(torch.from_numpy(mT), idx,
                                                      torch.from_numpy(wts))
    np.testing.assert_array_equal(got_d.numpy(), K.row_sweep(torch.from_numpy(mT), idx).numpy())
    expect = terms.astype(np.float64).sum(axis=1)
    assert expect[60] > 0 and (expect[:60] > 0).sum() >= 3
    np.testing.assert_allclose(hist.numpy(), expect[:60], rtol=1e-6)
    np.testing.assert_allclose(float(dens), expect[60], rtol=1e-6)
    assert int(n_close) == int(((d < np.float32(0.05)) & (wts > 0)).sum())


@pytest.mark.parametrize("nb,kb", [(4, 4), (3, 8), (1, 64), (40, 64)])
def test_gather_ball_plain_matches_vamb_tpu(nb, kb):
    """The ball and its side vectors against vamb_tpu's subset gather: the
    Pallas kernel (interpret mode) for the matrix, its takes of lengths,
    kept and d0 and the masks of slots past nb blocks (cluster.py:603-606,
    654-656), and the slot -> column ids; padding slots gather block 0."""
    rng = np.random.default_rng(nb * 100 + kb)
    f_pad, n_blocks = 32, 96
    n_pad = n_blocks * 128
    mT = rng.normal(size=(f_pad, n_pad)).astype(np.float32)
    lengths = rng.integers(2000, 50_000, n_pad).astype(np.float32)
    kept = rng.random(n_pad) < 0.8
    d0 = rng.random(n_pad).astype(np.float32)
    bids = np.zeros(kb, np.int32)
    bids[:nb] = np.sort(rng.choice(n_blocks, nb, replace=False))
    xs_j = np.asarray(P.gather_blocks(jnp.asarray(mT), jnp.asarray(bids), block=128,
                                      interpret=True))
    take = lambda v: np.asarray(jnp.take(jnp.asarray(v).reshape(n_blocks, 128),  # noqa: E731
                                         jnp.asarray(bids), axis=0)).reshape(-1)
    valid = np.repeat(np.arange(kb) < nb, 128)
    idx_j = (bids[:, None] * 128 + np.arange(128)[None, :]).reshape(-1)
    xs, cols, kept_s, w_s, d0_s = K.gather_ball(
        torch.from_numpy(mT), torch.from_numpy(bids), nb, torch.from_numpy(lengths),
        torch.from_numpy(kept), torch.from_numpy(d0))
    np.testing.assert_array_equal(xs.numpy(), xs_j)
    np.testing.assert_array_equal(cols.numpy(), idx_j)
    np.testing.assert_array_equal(kept_s.numpy(), valid & take(kept))
    np.testing.assert_array_equal(w_s.numpy(), np.where(valid, take(lengths), 0.0))
    np.testing.assert_array_equal(d0_s.numpy(), np.where(valid, take(d0), np.inf))


@pytest.mark.parametrize("seed", range(4))
def test_smooth_histogram_is_xlas_bit_for_bit(seed):
    """The smoothing of the 60-bin histogram sums in XLA's CPU order for
    the (60,) x (60, 60) product with the constant band matrix (its GEMV
    emitter's 8 lanes, FMAs and lane folds, read from the object code), so
    it equals vamb_tpu's `smooth_histogram` under `jax.jit` bit for bit (as
    tests/oracle_cluster.py runs it; vamb_tpu's engine compiles the same
    instructions inside `emit_batch`), one histogram at a time and batched,
    on the kind of histograms the engine makes: length-weighted counts,
    many bins empty. (Dispatched eagerly, jax passes the matrix as an
    argument rather than a constant and XLA picks another emitter.)"""
    rng = np.random.default_rng(seed)
    n = 300
    hist = (rng.integers(0, 60, (n, 60)) * rng.integers(2000, 60_000, (n, 60))).astype(np.float32)
    hist *= rng.random((n, 1)).astype(np.float32)
    hist[rng.random((n, 60)) < 0.4] = 0.0
    hist[0] = 0.0
    smooth = jax.jit(j_cluster.smooth_histogram)
    want = np.stack([np.asarray(smooth(jnp.asarray(h))) for h in hist])
    got = t_cluster.smooth_histogram(torch.as_tensor(hist)).numpy()
    assert got.tobytes() == want.tobytes()
    one = t_cluster.smooth_histogram(torch.as_tensor(hist[7])).numpy()
    assert one.tobytes() == want[7].tobytes()
    # the banded product's value, whatever the order
    np.testing.assert_allclose(got, hist.astype(np.float64) @ t_cluster._SMOOTH_MATRIX,
                               rtol=1e-5, atol=1e-3)


def test_wrappers_reject_bad_inputs():
    mT = torch.zeros(8, 256)
    with pytest.raises(IndexError):
        K.row_sweep(mT, 256)
    with pytest.raises(ValueError):
        K.candidate_density_sweep(mT, torch.arange(0), torch.ones(256))  # no candidate
    with pytest.raises(ValueError):
        K.gumbel_topc((0, 1), torch.zeros(256), *[torch.ones(256, dtype=torch.bool)] * 2, 0, 257)
    with pytest.raises(ValueError):
        K.row_sweep(mT.T, 0)  # not contiguous
    with pytest.raises(ValueError):
        K.gather_blocks(torch.zeros(8, 200), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        K.medoid_sweep(mT, 0, torch.ones(255))
    with pytest.raises(ValueError):
        K.spec_sweep(mT, list(range(9)), torch.ones(256))  # more than 8 rows
    with pytest.raises(IndexError):
        K.spec_sweep(mT, [256], torch.ones(256))
    with pytest.raises(ValueError):
        K.row_stats(torch.zeros(256, 4).T, torch.ones(256))  # not contiguous


# -------------------------------------------------------------- engine


def _assert_same_emission(matrix, lengths, rng_seed=0, jax_kwargs=None, **kwargs):
    """The port with `kwargs` against vamb_tpu with `kwargs` and
    `jax_kwargs` (default: full scope, no lanes, no compaction). Returns
    the port's generator, spent."""
    if jax_kwargs is None:
        jax_kwargs = {"wander_scope": "full", "attempt_batch": "off", "compact": False}
    jax_side = list(j_cluster.ClusterGenerator(
        matrix.copy(), lengths, rng_seed=rng_seed, **jax_kwargs, **kwargs))
    gen = TorchGenerator(matrix.copy(), lengths, rng_seed=rng_seed, device="cpu", **kwargs)
    port = list(gen)
    assert len(port) == len(jax_side)
    for i, (e, o) in enumerate(zip(jax_side, port)):
        ctx = f"cluster {i}/{len(port)}"
        assert o.kind_str == e.kind_str, ctx
        assert o.medoid == int(e.medoid), ctx
        assert o.seed == int(e.seed), ctx
        np.testing.assert_array_equal(o.members, e.members, err_msg=ctx)
        if e.radius is None:
            assert o.radius is None, ctx
        else:
            np.testing.assert_allclose(o.radius, e.radius, atol=1e-7, err_msg=ctx)
        if e.observed_pvr is None:
            assert o.observed_pvr is None, ctx
        else:
            np.testing.assert_allclose(o.observed_pvr, e.observed_pvr, rtol=1e-5, err_msg=ctx)
        np.testing.assert_allclose(o.maximal_pvr, e.maximal_pvr, atol=1e-6, err_msg=ctx)
        assert (o.successes, o.attempts) == (e.successes, e.attempts), ctx
    members = np.concatenate([c.members for c in port])
    np.testing.assert_array_equal(np.sort(members), np.arange(len(matrix)))
    return gen


_LIKE_JAX = {"compact_async": False}  # vamb_tpu's side beyond the shared switches


@pytest.fixture
def patch_both(monkeypatch):
    "Set a module constant of both engines for the test's duration."
    def patch(name, value):
        monkeypatch.setattr(j_cluster, name, value)
        monkeypatch.setattr(t_cluster, name, value)
    return patch


def _wide_clumps(n_clumps, per, dim, scale, noise_frac, seed):
    "Clumps wide enough (scale 0.06) that subset climbs drift past the ball's guard."
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clumps, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    rows = [c + rng.normal(scale=scale, size=(per, dim)) for c in centers]
    rows.append(rng.normal(size=(int(noise_frac * n_clumps * per), dim)))
    matrix = np.concatenate(rows).astype(np.float32)
    return matrix, rng.integers(2000, 50_000, len(matrix)).astype(np.float32)


def test_engine_clumpy_normal_regime():
    "Well-separated clumps: mostly normal clusters at pvr 0.1."
    matrix, lengths = clumpy_latents(40, 30, 32, seed=1)
    _assert_same_emission(matrix, lengths, rng_seed=3)


def test_engine_mixed_regime_with_noise():
    "Clumps + 20% uniform noise: normal, loner, reject and pvr bumps."
    matrix, lengths = clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2)
    _assert_same_emission(matrix, lengths, rng_seed=7, windowsize=60)


def test_engine_uniform_fallback_regime():
    "Uniform latents: pvr climbs past 0.55, then radius-0.06 fallbacks."
    rng = np.random.default_rng(3)
    matrix = rng.normal(size=(600, 32)).astype(np.float32)
    lengths = rng.integers(2000, 10_000, 600).astype(np.float32)
    _assert_same_emission(matrix, lengths, rng_seed=11, windowsize=40, minsuccesses=5)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_engine_tiny_inputs(n):
    rng = np.random.default_rng(n)
    matrix = rng.normal(size=(n, 8)).astype(np.float32)
    lengths = np.full(n, 2500.0, np.float32)
    _assert_same_emission(matrix, lengths, rng_seed=n, windowsize=10, minsuccesses=2)


def test_engine_order_matches():
    matrix, lengths = clumpy_latents(10, 20, 32, seed=4)
    norm = normalize(matrix)
    np.testing.assert_array_equal(norm, j_cluster.normalize(matrix.copy()))
    order, ranks = engine_order(norm, lengths, 9)
    j_order, j_ranks = j_cluster.engine_order(norm, lengths, 9)
    np.testing.assert_array_equal(order, np.asarray(j_order))
    np.testing.assert_array_equal(ranks, np.asarray(j_ranks))


def test_subset_clumpy_with_noise():
    matrix, lengths = clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2)
    gen = _assert_same_emission(matrix, lengths, rng_seed=7, jax_kwargs=_LIKE_JAX,
                                windowsize=60, wander_scope="subset")
    assert gen.subset_counts["attempts"] > 0


def test_subset_overflow_and_drift_fallbacks(patch_both):
    """The fallbacks of the 10k regime at a CPU size: a 1,024-column ball
    overflows on some attempts, and wide clumps drift past the guard."""
    patch_both("_SUBSET_Q", 1 << 10)
    matrix, lengths = _wide_clumps(40, 60, 32, scale=0.06, noise_frac=0.2, seed=4)
    gen = _assert_same_emission(matrix, lengths, rng_seed=13, jax_kwargs=_LIKE_JAX,
                                windowsize=120, wander_scope="subset")
    assert gen.subset_counts["overflow"] > 0 and gen.subset_counts["drift"] > 0


def test_subset_rejection_heavy_uniform():
    rng = np.random.default_rng(31)
    matrix = rng.normal(size=(900, 32)).astype(np.float32)
    lengths = rng.integers(2000, 10_000, 900).astype(np.float32)
    _assert_same_emission(matrix, lengths, rng_seed=11, jax_kwargs=_LIKE_JAX, windowsize=40,
                          minsuccesses=5, wander_scope="subset")


def test_subset_dense_overflow(patch_both):
    "One dense clump larger than a 512-column ball: every climb overflows."
    patch_both("_SUBSET_Q", 1 << 9)
    rng = np.random.default_rng(8)
    matrix = (rng.normal(size=(1, 16)) + 0.02 * rng.normal(size=(3000, 16))).astype(np.float32)
    lengths = rng.integers(2000, 50_000, len(matrix)).astype(np.float32)
    gen = _assert_same_emission(matrix, lengths, rng_seed=3, jax_kwargs=_LIKE_JAX,
                                wander_scope="subset")
    assert gen.subset_counts["overflow"] > 0


@pytest.mark.parametrize("scope", ["full", "subset"])
def test_vamb_tpu_batches_emit_exactly_k(scope):
    """The ladder's clock: every `vamb_tpu` batch but the last emits exactly
    `batch_clusters` clusters (its loop condition, cluster.py:1651-1653;
    loner bursts and attempt lanes stop at the batch's capacity), on a
    regime with loner runs. The port counts K clusters per batch."""
    matrix, lengths = clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2)
    gen = j_cluster.ClusterGenerator(matrix, lengths, rng_seed=7, windowsize=60,
                                     batch_clusters=8, compact=False, compact_async=False,
                                     wander_scope=scope)
    sizes = []
    while gen._assigned_total < gen.n_points:
        before = gen.emitted_total
        gen._dispatch()
        sizes.append(gen.emitted_total - before)
    gen.drain()
    assert len(sizes) > 10 and set(sizes[:-1]) == {8} and 1 <= sizes[-1] <= 8, sizes


def test_compaction_ladder():
    "Batches of 8 clusters; the ladder halves 2,176 columns twice."
    matrix, lengths = clumpy_latents(70, 30, 32, seed=5)
    gen = _assert_same_emission(matrix, lengths, rng_seed=5, jax_kwargs=_LIKE_JAX,
                                compact=True, compact_min_pad=128, batch_clusters=8)
    assert [c[1:] for c in gen.compactions] == [(2176, 1024), (1024, 512)]


def test_auto_scope_through_the_ladder(patch_both):
    """Auto scope with the floor at 1,024 columns: subset at 2,176 and
    1,024 columns (a 512-column ball), full sweeps after the ladder drops
    to 512."""
    patch_both("_SUBSET_AUTO_MIN", 1 << 10)
    patch_both("_SUBSET_Q", 1 << 9)
    matrix, lengths = clumpy_latents(70, 30, 32, seed=5)
    gen = _assert_same_emission(matrix, lengths, rng_seed=5, jax_kwargs=_LIKE_JAX,
                                compact=True, compact_min_pad=128, batch_clusters=8)
    assert [c[2] for c in gen.compactions] == [1024, 512]
    assert gen.subset_counts["attempts"] > 0 and gen.Q == 0


@pytest.mark.parametrize(
    "kwargs",
    [{"wander_scope": "subset"}, {"compact": True, "compact_min_pad": 128, "batch_clusters": 1}],
)
def test_subset_and_compaction_switches_run(kwargs):
    "The subset wander and the compaction ladder run to a full partition."
    matrix, lengths = clumpy_latents(12, 30, 32, seed=8)
    gen = TorchGenerator(matrix, lengths, device="cpu", **kwargs)
    members = np.concatenate([c.members for c in gen])
    np.testing.assert_array_equal(np.sort(members), np.arange(len(matrix)))


@pytest.mark.parametrize(
    "kwargs,error,match",
    [({"attempt_batch": "on"}, ValueError, "requires the subset wander"),
     ({"distance_dtype": "bfloat16", "wander_scope": "subset"}, ValueError,
      "requires float32 distances")],
)
def test_unported_switches_fail_loudly(kwargs, error, match):
    """Switch combinations `vamb_tpu` refuses, refused alike: attempt lanes
    "on" outside the subset scope (here auto scope at 128 columns: full
    sweeps; cluster.py:1915-1920), and the subset wander with bfloat16
    distances (cluster.py:1880-1881)."""
    m = np.ones((4, 8), np.float32)
    with pytest.raises(error, match=match):
        TorchGenerator(m, np.full(4, 2000.0, np.float32), device="cpu", **kwargs)
    with pytest.raises(error, match=match):
        j_cluster.ClusterGenerator(m, np.full(4, 2000.0, np.float32), compact_async=False,
                                   **kwargs)

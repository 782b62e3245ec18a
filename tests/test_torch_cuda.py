"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor vamb_tpu, so it also runs on a machine
that has only PyTorch; there, skip the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Without a card each test skips: a CUDA kernel has no CPU mode. Tolerances
are chip_smoke.py's: `row_sweep` and `candidate_density_sweep` equal their
plain versions bit for bit (the same products added in the same order, and
the plain density sum reproduces the kernel's summation order), d[idx] ==
0.0 exactly; medoid_sweep's row, histogram, density and close count equal
to its plain version's (`torch.equal`: the plain version sums in the
kernel's order) and its row to row_sweep's; the gather and its side
vectors array-equal. The widths are every width the main paths give the
kernels (a subset ball's 8,192; 100,096-wide paths; 300,032 and, after
compaction, 150,016) and an unaligned one. The one-pass kernels are one
device kernel a call: the library's own count of the named kernel
(`device_launches`, kept by its C entry points) rises by one a call, as the
profiler's launch calls do. `gumbel_scores` equals its plain version bit for bit
(as int32 bit patterns) at the wander's widths, in one launch;
`gumbel_topc`'s candidates and their validity equal its plain version's
(array-equal; the optional scores bit for bit), tied scores included, in
one launch;
`hmm_forward` is within 1e-3 + 1e-5 |score| bits of its plain version
(the card's SFU exponentials and logarithms in base 2, its scan orders).
Taxometer and VAEVAE train on the card as on the CPU (four steps, rtol
1e-4) without launching a hand-written kernel, and so does the AAE. At
F_pad 288, the width `bin avamb` clusters its z latent at, every matrix
kernel takes its generic code and is still bit for bit its plain version,
each launch tallied under that width. On a bf16 matrix, the variants of
`medoid_sweep`, `spec_sweep` and `candidate_density_sweep` equal the f32
kernels on the widened matrix and their plain versions bit for bit, in
one launch each, tallied as "bfloat16"; the engine with bfloat16
distances emits on the card what it emits on the CPU. At C above 32 (33,
40, 64, 100) `gumbel_topc` and its shard entry point equal their plain
versions in ceil(C / 32) launches a call, and the density kernel, its
shard entry point and its bf16 variant equal theirs in one; the engine
emits alike under `wander_kernel` "auto", "pallas" and "xla", and "xla"
launches no hand-written kernel.
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


_WIDTHS = [8_192, 100_000, 100_003, 150_016, 300_032]


@pytest.mark.cuda
@pytest.mark.parametrize("n", _WIDTHS)
def test_row_sweep_matches_plain(cuda, n):
    mT = torch.as_tensor(_clumpy(n, 32, seed=n)[0], device=cuda)
    for idx in (0, 37, n - 1):
        d = K.row_sweep(mT, idx)
        assert torch.equal(d, K.row_sweep_plain(mT, idx))
        assert float(d[idx]) == 0.0


@pytest.mark.cuda
def test_row_sweep_other_feature_width(cuda):
    "F_pad 40 takes the generic kernel: still bit-identical."
    mT_np, _ = _clumpy(4_096, 40, seed=2)
    mT = torch.as_tensor(mT_np, device=cuda)
    assert torch.equal(K.row_sweep(mT, 11), K.row_sweep_plain(mT, 11))


@pytest.mark.cuda
@pytest.mark.parametrize("n", _WIDTHS)
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
        dens = K.candidate_density_sweep(mT, cand, w)
        assert torch.equal(dens, K.candidate_density_plain(mT, cand, w)), (c, dens)
        # int32 ids go in as they are, with the same result
        assert torch.equal(K.candidate_density_sweep(mT, cand.to(torch.int32), w), dens)


@pytest.mark.cuda
def test_candidate_density_other_feature_width(cuda):
    "F_pad 40 takes the generic kernel: still bit-identical."
    mT_np, lengths = _clumpy(10_000, 40, seed=3)
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    cand = torch.as_tensor(np.random.default_rng(3).choice(10_000, 25, replace=False), device=cuda)
    assert torch.equal(K.candidate_density_sweep(mT, cand, w), K.candidate_density_plain(mT, cand, w))


@pytest.mark.cuda
def test_candidate_density_is_one_launch(cuda):
    "One device kernel a call, with int64 ids: no second pass and no cast."
    mT_np, lengths = _clumpy(100_096, 32, seed=4)
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    cand = torch.arange(0, 2_500, 100, device=cuda)  # int64, as gumbel_topc gives them
    kernels = _one_launch(cuda, lambda: K.candidate_density_sweep(mT, cand, w),
                          "candidate_density_kernel")
    assert len(kernels) == 3, kernels


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
@pytest.mark.parametrize("n_pad", [128 * 64, 300_032])
def test_gather_ball_matches_plain(cuda, n_pad):
    """The ball and its side vectors from one launch, against index_select
    plus the masks: all slots valid, padding slots past nb (gathering block
    0 again), and repeated ids."""
    rng = np.random.default_rng(n_pad + 1)
    mT = torch.as_tensor(rng.normal(size=(32, n_pad)).astype(np.float32), device=cuda)
    w = torch.as_tensor(rng.integers(2000, 50_000, n_pad).astype(np.float32), device=cuda)
    kept = torch.as_tensor(rng.random(n_pad) < 0.8, device=cuda)
    d0 = torch.as_tensor(rng.random(n_pad).astype(np.float32), device=cuda)
    blocks = n_pad // 128
    picked = np.sort(rng.choice(blocks, 40, replace=False))
    for ids, nb in ((np.sort(rng.choice(blocks, 64, replace=False)), 64),
                    (np.concatenate([picked, np.zeros(24, np.int64)]), 40),
                    (np.array([5, 0, 0, blocks - 1]), 3)):
        bids = torch.as_tensor(ids.astype(np.int32), device=cuda)
        got = K.gather_ball(mT, bids, nb, w, kept, d0)
        expect = K.gather_ball_plain(mT, bids, nb, w, kept, d0)
        for name, a, b in zip(("xsT", "cols", "kept", "w", "d0"), got, expect):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, nb)


def _one_launch(cuda, fn, kernel: str, per_call: int = 1) -> list:
    """The kernel launches of 3 calls of `fn` after a first one (build,
    workspace): the library's own count of `kernel`'s launches
    (`K.device_launches`, which its C entry points keep on the host) must
    rise by 3 x `per_call` and no other kernel's count may rise, and the
    profiler's launch API calls (`cudaLaunchKernel` and its kin), which
    are returned, must number as many; every device kernel the profiler
    recorded must be `kernel`. The library's count names the kernel: late in
    a long run of these tests on the card the profiler was seen to drop some
    of a window's device records, or all of them, never its launch calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = K.device_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    after = K.device_launches()
    grew = {name: after[name] - before[name] for name in after if after[name] != before[name]}
    assert grew == {kernel: 3 * per_call}, grew
    events = prof.events()
    recorded = {e.name for e in events if e.device_type == DeviceType.CUDA}
    assert all(kernel in name for name in recorded), recorded
    launches = [e.name for e in events if e.device_type == DeviceType.CPU and "Launch" in e.name]
    assert len(launches) == 3 * per_call, launches
    return launches


@pytest.mark.cuda
@pytest.mark.parametrize("n", [100_000, 100_003, 100_096, 150_016, 300_032])
@pytest.mark.parametrize("zero_half", [False, True])
def test_medoid_sweep_matches_plain(cuda, n, zero_half):
    mT_np, lengths = _clumpy(n, 32, seed=n)
    if zero_half:
        lengths[np.random.default_rng(n).permutation(n)[: n // 2]] = 0.0
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    for idx in (0, 37, n - 1):
        got = K.medoid_sweep(mT, idx, w)
        expect = K.medoid_sweep_plain(mT, idx, w)
        assert torch.equal(got[0], K.row_sweep(mT, idx)) and float(got[0][idx]) == 0.0
        for name, a, b in zip(("d", "hist", "density", "n_close"), got, expect):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, idx, a, b)


@pytest.mark.cuda
def test_medoid_sweep_other_feature_width(cuda):
    "F_pad 40 takes the generic loads: the same order, still bit-identical."
    mT_np, lengths = _clumpy(10_000, 40, seed=5)
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    for a, b in zip(K.medoid_sweep(mT, 17, w), K.medoid_sweep_plain(mT, 17, w)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_medoid_sweep_is_one_launch(cuda):
    "One device kernel a call: the ticket's last CTA sums the partial rows."
    mT_np, lengths = _clumpy(300_032, 32, seed=6)
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    kernels = _one_launch(cuda, lambda: K.medoid_sweep(mT, 11, w), "medoid_sweep_kernel")
    assert len(kernels) == 3, kernels


@pytest.mark.cuda
def test_gather_ball_is_one_launch(cuda):
    "The ball and its four side vectors come from one device kernel."
    n_pad = 300_032
    rng = np.random.default_rng(7)
    mT = torch.as_tensor(rng.normal(size=(32, n_pad)).astype(np.float32), device=cuda)
    w = torch.ones(n_pad, device=cuda)
    kept = torch.ones(n_pad, dtype=torch.bool, device=cuda)
    bids = torch.arange(0, 640, 10, dtype=torch.int32, device=cuda)
    kernels = _one_launch(cuda, lambda: K.gather_ball(mT, bids, 50, w, kept, w),
                           "gather_blocks_kernel")
    assert len(kernels) == 3, kernels


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(256, 32), (512, 32), (1_024, 32), (8_192, 32), (33_024, 32),
                                 (100_003, 32), (100_096, 32), (150_016, 32), (300_032, 32),
                                 (4_099, 288), (100_096, 288)])
@pytest.mark.parametrize("weights", ["all", "half", "none"])
def test_spec_sweep_and_row_stats_match_plain_and_medoid_sweep(cuda, n, f, weights):
    """The seed cache's kernels at every S from 1 to 8: rows and sums bit
    for bit their plain versions' and, column by column, `medoid_sweep`'s;
    the near count over the kept columns within 0.05. The widths give 1, 2,
    4, 32, 65 (odd), 98 and 118 column CTAs (`sweep_col_blocks`) at F_pad
    32, 17 and 98 at 288; all, half and none of the weights nonzero."""
    mT_np, lengths = _clumpy(n, f, seed=n + f)
    rng = np.random.default_rng(n)
    if weights == "half":
        lengths[rng.permutation(n)[: n // 2]] = 0.0
    elif weights == "none":
        lengths[:] = 0.0
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    for s in range(1, 9):
        cols = [int(c) for c in rng.choice(n, s, replace=False)]
        cols[0] = n - 1
        got = K.spec_sweep(mT, cols, w)
        for name, a, b in zip(("rows", "hist", "density", "n_close", "n_near"), got,
                              K.spec_sweep_plain(mT, cols, w)):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, s)
        stats = K.row_stats(got[0], w)
        for name, a, b in zip(("hist", "density", "n_close", "n_near"), stats, got[1:]):
            assert torch.equal(a, b), (name, s)
        for j, col in enumerate(cols):
            for a, b in zip((g[j] for g in got[:4]), K.medoid_sweep(mT, col, w)):
                assert torch.equal(a, b), (s, j)
            assert int(got[4][j]) == int(((got[0][j] <= 0.05) & (w > 0)).sum())


@pytest.mark.cuda
def test_spec_sweep_and_row_stats_are_one_launch(cuda):
    "One device kernel a call each: the ticket's last CTA sums every row's partials."
    mT_np, lengths = _clumpy(300_032, 32, seed=8)
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    kernels = _one_launch(cuda, lambda: K.spec_sweep(mT, range(8), w), "spec_sweep_kernel")
    assert len(kernels) == 3, kernels
    rows = K.spec_sweep(mT, range(8), w)[0]
    kernels = _one_launch(cuda, lambda: K.row_stats(rows, w), "row_stats_kernel")
    assert len(kernels) == 3, kernels


# ------------------------------------------------ the shard entry points

# a shard of a mesh's matrix: the 100k path's 100,096 columns split over W
# ranks (W = 1, 2, 4), and an unaligned width
_SHARD_WIDTHS = [100_096, 50_048, 25_024, 25_003]


def _shard_case(cuda, n, seed, f=32):
    "An (f, n + 512) clumpy matrix and weights on the card; the shard is [256, 256 + n)."
    mT_np, lengths = _clumpy(n + 512, f, seed=seed)
    lengths[np.random.default_rng(seed).random(n + 512) < 0.2] = 0.0
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    return mT, w, mT[:, 256:256 + n].contiguous(), w[256:256 + n].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("n", _SHARD_WIDTHS)
def test_shard_sweeps_match_plain_and_the_index_entry_points(cuda, n):
    """`medoid_sweep_shard`, `spec_sweep_shard` and `candidate_density_shard`
    equal their plain versions bit for bit, with queries on the shard and
    held elsewhere (-1); given a shard column's own features and index
    they equal the index entry points on the shard bit for bit, and a
    query held elsewhere gets the full matrix's row, sliced."""
    _check_shard_sweeps(cuda, n, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", _SHARD_WIDTHS)
def test_shard_sweeps_at_the_aae_width(cuda, n):
    """The same at F_pad 288 (`bin avamb --dist`'s 283-wide z latent, the
    kernels' generic width)."""
    _check_shard_sweeps(cuda, n, 288)


def _check_shard_sweeps(cuda, n, f):
    mT, w, part, wp = _shard_case(cuda, n, seed=n, f=f)
    full_row = lambda c: K.row_sweep(mT, c)[256:256 + n]  # noqa: E731
    own, other = 37, 100  # shard column 37; full column 100, before the shard: held elsewhere
    q_own = part[:, own].contiguous()
    q_other = mT[:, other].contiguous()
    for q, idx in ((q_own, own), (q_other, -1)):
        got = K.medoid_sweep_shard(part, q, idx, wp)
        for a, b in zip(got, K.medoid_sweep_shard_plain(part, q, idx, wp)):
            assert a.dtype == b.dtype and torch.equal(a, b), idx
    for a, b in zip(K.medoid_sweep_shard(part, q_own, own, wp), K.medoid_sweep(part, own, wp)):
        assert torch.equal(a, b)
    assert torch.equal(K.medoid_sweep_shard(part, q_other, -1, wp)[0], full_row(other))
    cols = [own, -1, 5, n - 1, -1, 200, own, 9]
    feats = torch.stack([part[:, c] if c >= 0 else mT[:, other + s] for s, c in enumerate(cols)], 1)
    got = K.spec_sweep_shard(part, feats.contiguous(), cols, wp)
    for a, b in zip(got, K.spec_sweep_shard_plain(part, feats, cols, wp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(got[0][1], full_row(other + 1))
    mine = [own, 5, n - 1, 200]
    for a, b in zip(K.spec_sweep_shard(part, part[:, mine].contiguous(), mine, wp),
                    K.spec_sweep(part, mine, wp)):
        assert torch.equal(a, b)
    cand = torch.tensor([own, -1, 5, n - 1, -1] * 5, dtype=torch.int64, device=cuda)
    q = torch.stack([part[:, c] if c >= 0 else mT[:, other + j] for j, c in
                     enumerate(cand.tolist())], 1).contiguous()
    assert torch.equal(K.candidate_density_shard(part, q, cand, wp),
                       K.candidate_density_shard_plain(part, q, cand, wp))
    ids = torch.tensor([own, 5, n - 1, 200], device=cuda)
    assert torch.equal(K.candidate_density_shard(part, part[:, ids].contiguous(), ids, wp),
                       K.candidate_density_sweep(part, ids, wp))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [w for w in _SHARD_WIDTHS if w % 128 == 0])
def test_ball_gather_and_bf16_shards_match_plain_and_the_index_entry_points(cuda, n):
    """`gather_ball_shard` on the 128-aligned shard equals its plain version
    and `gather_ball` of the whole matrix for the shard's blocks (columns
    global); the bf16 shard variants of the three sweeps equal their plain
    versions and, given a bf16 shard column's widened features and its
    index, the bf16 index entry points on the shard, bit for bit."""
    _check_ball_and_bf16_shards(cuda, n, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [w for w in _SHARD_WIDTHS if w % 128 == 0])
def test_ball_gather_and_bf16_shards_at_the_aae_width(cuda, n):
    "The same at F_pad 288."
    _check_ball_and_bf16_shards(cuda, n, 288)


def _check_ball_and_bf16_shards(cuda, n, f):
    mT, w, part, wp = _shard_case(cuda, n, seed=n + 1, f=f)
    kept = w > 0
    d0 = K.row_sweep(mT, 300)
    nblk = n // 128
    local = torch.tensor([1, 5, nblk - 1, 0, 0, 0], dtype=torch.int32, device=cuda)
    got = K.gather_ball_shard(part, local, 3, wp, kept[256:256 + n].contiguous(),
                              d0[256:256 + n].contiguous(), 256)
    args = (local, 3, wp, kept[256:256 + n].contiguous(), d0[256:256 + n].contiguous(), 256)
    for a, b, c in zip(got, K.gather_ball_shard_plain(part, *args),
                       K.gather_ball(mT, local + 2, 3, w, kept, d0)):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)
    bf = part.to(torch.bfloat16).contiguous()
    q = bf.float()
    own, other = 37, mT[:, 100].to(torch.bfloat16).float().contiguous()
    for qq, idx in ((q[:, own].contiguous(), own), (other, -1)):
        for a, b in zip(K.medoid_sweep_shard(bf, qq, idx, wp),
                        K.medoid_sweep_shard_plain(bf, qq, idx, wp)):
            assert a.dtype == b.dtype and torch.equal(a, b), idx
    for a, b in zip(K.medoid_sweep_shard(bf, q[:, own].contiguous(), own, wp),
                    K.medoid_sweep(bf, own, wp)):
        assert torch.equal(a, b)
    cols = [own, -1, 5, n - 1]
    feats = torch.stack([q[:, c] if c >= 0 else other for c in cols], 1).contiguous()
    for a, b in zip(K.spec_sweep_shard(bf, feats, cols, wp),
                    K.spec_sweep_shard_plain(bf, feats, cols, wp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mine = [own, 5, n - 1, 200]
    for a, b in zip(K.spec_sweep_shard(bf, q[:, mine].contiguous(), mine, wp),
                    K.spec_sweep(bf, mine, wp)):
        assert torch.equal(a, b)
    cand = torch.tensor([own, -1, 5, n - 1, -1] * 5, dtype=torch.int64, device=cuda)
    qc = torch.stack([q[:, c] if c >= 0 else other for c in cand.tolist()], 1).contiguous()
    assert torch.equal(K.candidate_density_shard(bf, qc, cand, wp),
                       K.candidate_density_shard_plain(bf, qc, cand, wp))
    ids = torch.tensor([own, 5, n - 1, 200], device=cuda)
    assert torch.equal(K.candidate_density_shard(bf, q[:, ids].contiguous(), ids, wp),
                       K.candidate_density_sweep(bf, ids, wp))


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2, 4])
def test_gumbel_shards_merge_to_gumbel_topc(cuda, world):
    """Each shard's `gumbel_topc_shard` keys equal its plain version's, and
    their `topc_merge` gives `gumbel_topc`'s candidates and flags over the
    global width (100,096 columns), at several eligible counts."""
    from vamb_torch.utils import threefry

    n = 100_096
    rng = np.random.default_rng(world)
    d = torch.as_tensor(rng.uniform(0.0, 0.08, n).astype(np.float32), device=cuda)
    tried = torch.as_tensor(rng.random(n) < 0.05, device=cuda)
    key = threefry.split_host(threefry.PRNGKey(world))[1]
    for p_kept in (0.9, 2e-4):
        kept = torch.as_tensor(rng.random(n) < p_kept, device=cuda)
        want = K.gumbel_topc(key, d, kept, tried, 4_321, 25)
        keys = []
        for r in range(world):
            lo, hi = r * n // world, (r + 1) * n // world
            k = K.gumbel_topc_shard(key, d[lo:hi], kept[lo:hi], tried[lo:hi], 4_321, 25, n, lo)
            assert torch.equal(k.cpu(), K.gumbel_topc_shard_plain(
                key, d[lo:hi].cpu(), kept[lo:hi].cpu(), tried[lo:hi].cpu(), 4_321, 25, lo))
            keys.append(k)
        cand, valid = K.topc_merge(torch.stack(keys), 25)
        assert torch.equal(cand, want[0]) and torch.equal(valid, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["medoid", "spec", "density", "gumbel", "ball", "medoid_bf16",
                                    "spec_bf16", "density_bf16"])
def test_shard_entry_points_are_one_launch(cuda, kernel):
    "Each shard entry point is one device kernel a call, its index entry point's kernel."
    from vamb_torch.utils import threefry

    n = 50_048
    mT, w, part, wp = _shard_case(cuda, n, seed=3)
    q8 = part[:, :8].contiguous()
    cand = torch.arange(25, device=cuda)
    q25 = part[:, :25].contiguous()
    q1 = q8[:, 0].contiguous()
    kept = torch.ones(n, dtype=torch.bool, device=cuda)
    tried = ~kept
    d = K.medoid_sweep(part, 3, wp)[0]
    key = threefry.PRNGKey(1)
    bf = part.to(torch.bfloat16).contiguous()
    bids = torch.arange(64, dtype=torch.int32, device=cuda)
    fn, name = {
        "medoid": (lambda: K.medoid_sweep_shard(part, q1, -1, wp), "medoid_sweep_kernel"),
        "spec": (lambda: K.spec_sweep_shard(part, q8, [-1] * 8, wp), "spec_sweep_kernel"),
        "density": (lambda: K.candidate_density_shard(part, q25, cand, wp),
                    "candidate_density_kernel"),
        "gumbel": (lambda: K.gumbel_topc_shard(key, d, kept, tried, 7, 25, 2 * n, n),
                   "gumbel_topc_kernel"),
        "ball": (lambda: K.gather_ball_shard(part, bids, 50, wp, kept, d, n),
                 "gather_blocks_kernel"),
        "medoid_bf16": (lambda: K.medoid_sweep_shard(bf, q1, -1, wp), "medoid_sweep_kernel"),
        "spec_bf16": (lambda: K.spec_sweep_shard(bf, q8, [-1] * 8, wp), "spec_sweep_kernel"),
        "density_bf16": (lambda: K.candidate_density_shard(bf, q25, cand, wp),
                         "candidate_density_kernel"),
    }[kernel]
    assert len(_one_launch(cuda, fn, name)) == 3


@pytest.mark.cuda
def test_sharded_engine_card_equals_cpu(cuda):
    """The row-sharded engine over a mesh of one rank on the card emits what
    it emits on the CPU, which is the unsharded engine's emission, and its
    wander steps went through the shard entry points."""
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.parallel import make_mesh

    mT_np, lengths = _clumpy(6_000, 32, seed=12)
    m = np.ascontiguousarray(mT_np.T)
    runs = []
    for device, mesh in ((cuda, make_mesh(1, device=cuda)), ("cpu", make_mesh(1, device="cpu")),
                         ("cpu", None)):
        K.reset_launch_counts()
        gen = ClusterGenerator(m.copy(), lengths, rng_seed=3, device=device, mesh=mesh)
        runs.append([(c.medoid, c.kind_str, c.members.tolist()) for c in gen])
        if device == cuda:
            assert K.gumbel_topc_shard.launches > 0 and K.candidate_density_shard.launches > 0
            assert K.gumbel_topc.launches == 0 and K.candidate_density_sweep.launches == 0
    assert runs[0] == runs[1] == runs[2]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(wander_scope="subset", attempt_batch="on"),
                                dict(wander_scope="subset", attempt_batch="off"),
                                dict(distance_dtype="bfloat16")])
def test_sharded_subset_and_bf16_engine_card_equals_cpu(cuda, kw):
    """The row-sharded engine of one rank on the card at the subset scope
    (lanes on and off) and at bfloat16 distances emits what it emits on the
    CPU and what the unsharded engine emits; the ball came from
    `gather_ball_shard` (never `gather_ball`), the bf16 run's sweeps from
    the bf16 shard variants."""
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.parallel import make_mesh

    mT_np, lengths = _clumpy(6_000, 32, seed=12)
    m = np.ascontiguousarray(mT_np.T)
    runs = []
    for device, mesh in ((cuda, make_mesh(1, device=cuda)), ("cpu", make_mesh(1, device="cpu")),
                         ("cpu", None)):
        K.reset_launch_counts()
        gen = ClusterGenerator(m.copy(), lengths, rng_seed=3, device=device, mesh=mesh, **kw)
        runs.append([(c.medoid, c.kind_str, c.members.tolist()) for c in gen])
        if device == cuda:
            assert K.medoid_sweep.launches == 0 and K.spec_sweep.launches == 0
            assert K.gather_blocks.launches == 0
            if "distance_dtype" in kw:
                assert K.spec_sweep_shard.launches_by_dtype.get("bfloat16", 0) > 0
                assert K.candidate_density_shard.launches_by_dtype.get("bfloat16", 0) > 0
                assert K.gather_ball_shard.launches == 0
            else:
                assert K.gather_ball_shard.launches > 0
    assert runs[0] == runs[1] == runs[2]


@pytest.mark.cuda
def test_engine_lanes_on_and_off_card_equals_cpu(cuda):
    """The engine at subset scope with attempt lanes on and off, on the card
    and on the CPU: four runs, one emission, and the card's runs launched
    `spec_sweep` and `row_stats` (the lanes' run also counts its lanes)."""
    from vamb_torch import cluster

    rng = np.random.default_rng(3)
    centers = rng.normal(size=(30, 32))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    m = np.concatenate([c + rng.normal(scale=0.04, size=(30, 32)) for c in centers]
                       + [rng.normal(size=(300, 32))]).astype(np.float32)
    lengths = rng.integers(2000, 50_000, len(m)).astype(np.float32)
    runs = {}
    for ab in ("on", "off"):
        for dev in (cuda, "cpu"):
            K.reset_launch_counts()
            gen = cluster.ClusterGenerator(m.copy(), lengths, rng_seed=7, device=dev,
                                           wander_scope="subset", attempt_batch=ab)
            runs[ab, str(dev)] = [(c.medoid, c.seed, c.kind_str, c.radius, c.maximal_pvr,
                                   c.successes, c.attempts, c.members.tolist()) for c in gen]
            if dev == cuda:
                assert K.spec_sweep.launches > 0 and K.row_stats.launches > 0
                assert (gen.lane_counts["admitted"] > 0) == (ab == "on"), gen.lane_counts
    first = runs["on", "cuda"]
    assert len(first) > 30 and all(r == first for r in runs.values())


# the bf16 variants of the three kernels a bfloat16 engine runs, at the
# widths the 100k and 300k paths give them, an unaligned one and F_pad 288
_BF16_WIDTHS = [(8_192, 32), (100_003, 32), (100_096, 32), (150_016, 32), (300_032, 32),
                (4_099, 288), (100_096, 288)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", _BF16_WIDTHS)
def test_bf16_variants_match_the_f32_kernels_and_plain(cuda, n, f):
    """On a bf16 matrix, `medoid_sweep`, `spec_sweep` (S 1 to 8) and
    `candidate_density_sweep` (C 1, 25, 32; int64 and int32 ids) are bit for
    bit the f32 kernels on the widened matrix and the plain versions, and
    each launch is tallied as "bfloat16"."""
    mT_np, lengths = _clumpy(n, f, seed=n + f + 1)
    lengths[np.random.default_rng(n).permutation(n)[: n // 3]] = 0.0
    mT = torch.as_tensor(mT_np, device=cuda).to(torch.bfloat16)
    wide = mT.float()
    w = torch.as_tensor(lengths, device=cuda)
    rng = np.random.default_rng(n + 1)
    K.reset_launch_counts()
    for idx in (0, 37, n - 1):
        got = K.medoid_sweep(mT, idx, w)
        for a, b, c in zip(got, K.medoid_sweep(wide, idx, w), K.medoid_sweep_plain(mT, idx, w)):
            assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c), idx
    for s in range(1, 9):
        cols = [int(c) for c in rng.choice(n, s, replace=False)]
        got = K.spec_sweep(mT, cols, w)
        for name, a, b, c in zip(("rows", "hist", "density", "n_close", "n_near"), got,
                                 K.spec_sweep(wide, cols, w), K.spec_sweep_plain(mT, cols, w)):
            assert torch.equal(a, b) and torch.equal(a, c), (name, s)
    for c in (1, 25, 32):
        cand = torch.as_tensor(rng.choice(n, c, replace=False), device=cuda)
        got = K.candidate_density_sweep(mT, cand, w)
        assert torch.equal(got, K.candidate_density_sweep(wide, cand, w))
        assert torch.equal(got, K.candidate_density_sweep(mT, cand.to(torch.int32), w))
        assert torch.equal(got, K.candidate_density_plain(mT, cand, w))
    assert K.medoid_sweep.launches_by_dtype == {"bfloat16": 3, "float32": 3}
    assert K.spec_sweep.launches_by_dtype == {"bfloat16": 8, "float32": 8}
    assert K.candidate_density_sweep.launches_by_dtype == {"bfloat16": 6, "float32": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["medoid_sweep", "spec_sweep", "candidate_density"])
def test_bf16_variants_are_one_launch(cuda, kernel):
    "One device kernel a call, as the f32 kernels."
    mT_np, lengths = _clumpy(300_032, 32, seed=9)
    mT = torch.as_tensor(mT_np, device=cuda).to(torch.bfloat16)
    w = torch.as_tensor(lengths, device=cuda)
    cand = torch.arange(25, device=cuda) * 1000
    fn = {"medoid_sweep": lambda: K.medoid_sweep(mT, 11, w),
          "spec_sweep": lambda: K.spec_sweep(mT, range(8), w),
          "candidate_density": lambda: K.candidate_density_sweep(mT, cand, w)}[kernel]
    kernels = _one_launch(cuda, fn, kernel + "_kernel")
    assert len(kernels) == 3, kernels


@pytest.mark.cuda
def test_bf16_engine_card_equals_cpu(cuda):
    """The engine with bfloat16 distances on the card and on the CPU, with
    the compaction ladder forced: one emission; the card launched the bf16
    variants alone and never `row_sweep` or the gather."""
    from vamb_torch import cluster

    rng = np.random.default_rng(4)
    centers = rng.normal(size=(40, 32))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    m = np.concatenate([c + rng.normal(scale=0.04, size=(30, 32)) for c in centers]
                       + [rng.normal(size=(200, 32))]).astype(np.float32)
    lengths = rng.integers(2000, 50_000, len(m)).astype(np.float32)
    runs = {}
    for dev in (cuda, "cpu"):
        K.reset_launch_counts()
        gen = cluster.ClusterGenerator(m.copy(), lengths, rng_seed=5, device=dev,
                                       distance_dtype="bfloat16", compact_min_pad=128,
                                       batch_clusters=8)
        runs[str(dev)] = [(c.medoid, c.seed, c.kind_str, c.radius, c.maximal_pvr, c.successes,
                           c.attempts, c.members.tolist()) for c in gen]
        if dev == cuda:
            assert gen.compactions
            for k in (K.medoid_sweep, K.spec_sweep, K.candidate_density_sweep):
                assert set(k.launches_by_dtype) == {"bfloat16"}, (k.__name__, k.launches_by_dtype)
            assert K.row_sweep.launches == 0 and K.gather_blocks.launches == 0
    assert len(runs["cuda"]) > 40 and runs["cuda"] == runs["cpu"]


# the AAE's z latent: 283 features padded to 288; an aligned and an unaligned N
_AAE_F_PAD = 288


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4_096, 4_099])
def test_kernels_at_the_aae_width(cuda, n):
    """F_pad 288, the width `bin avamb` clusters at, takes the generic code
    of every matrix kernel: each bit for bit its plain version, and each
    launch tallied under F_pad 288."""
    mT_np, lengths = _clumpy(n, _AAE_F_PAD, seed=n)
    mT = torch.as_tensor(mT_np, device=cuda)
    rng = np.random.default_rng(n)
    K.reset_launch_counts()
    for idx in (0, 37, n - 1):
        d = K.row_sweep(mT, idx)
        assert torch.equal(d, K.row_sweep_plain(mT, idx)) and float(d[idx]) == 0.0
    for zero_half in (False, True):
        w_np = lengths.copy()
        if zero_half:
            w_np[rng.permutation(n)[: n // 2]] = 0.0
        w = torch.as_tensor(w_np, device=cuda)
        for c in (1, 25, 32):
            cand = torch.as_tensor(rng.choice(n, size=c, replace=False), device=cuda)
            dens = K.candidate_density_sweep(mT, cand, w)
            assert torch.equal(dens, K.candidate_density_plain(mT, cand, w)), (c, zero_half)
            assert torch.equal(K.candidate_density_sweep(mT, cand.to(torch.int32), w), dens)
        for idx in (0, 37, n - 1):
            for name, a, b in zip(("d", "hist", "density", "n_close"), K.medoid_sweep(mT, idx, w),
                                  K.medoid_sweep_plain(mT, idx, w)):
                assert a.dtype == b.dtype and torch.equal(a, b), (name, idx, zero_half)
    assert K.row_sweep.launches_by_fpad == {_AAE_F_PAD: 3}
    assert K.candidate_density_sweep.launches_by_fpad == {_AAE_F_PAD: 12}
    assert K.medoid_sweep.launches_by_fpad == {_AAE_F_PAD: 6}
    if n % 128 == 0:
        w = torch.as_tensor(lengths, device=cuda)
        kept = torch.as_tensor(rng.random(n) < 0.8, device=cuda)
        d0 = torch.as_tensor(rng.random(n).astype(np.float32), device=cuda)
        blocks = n // 128
        for ids, nb in ((np.sort(rng.choice(blocks, 16, replace=False)), 16),
                        (np.array([5, 0, 0, blocks - 1]), 3)):
            bids = torch.as_tensor(ids.astype(np.int32), device=cuda)
            assert torch.equal(K.gather_blocks(mT, bids), K.gather_blocks_plain(mT, bids))
            for a, b in zip(K.gather_ball(mT, bids, nb, w, kept, d0),
                            K.gather_ball_plain(mT, bids, nb, w, kept, d0)):
                assert a.dtype == b.dtype and torch.equal(a, b)
        assert K.gather_blocks.launches_by_fpad == {_AAE_F_PAD: 4}


@pytest.mark.cuda
def test_aae_trains_on_the_card_as_on_the_cpu(cuda):
    """Four steps of the AAE on the card and on the CPU from one seed: the
    parameters within rtol 1e-4, atol 1e-6 (f32 matmuls sum in another order
    on each), but for the dense biases that feed a BatchNorm and its
    running means, which move on rounding noise (tests/test_torch_aae.py):
    within 4 steps x lr. The step draws' normals are equal bit for bit, the
    y prior (a softmax at temperature 0.16) within rtol 1e-5."""
    from vamb_torch.models.aae import AAE
    from vamb_torch.models.dataset import make_dataset

    rng = np.random.default_rng(1)
    ds = make_dataset(rng.uniform(0.5, 5, (512, 4)).astype(np.float32),
                      rng.normal(size=(512, 103)).astype(np.float32), rng.integers(2000, 50_000, 512))
    models = {}
    for where in ("cpu", cuda):
        m = AAE(4, nhiddens=64, nlatent_z=24, nlatent_y=30, seed=3, device=where)
        m.trainmodel(ds, nepochs=1, batchsize=128, batchsteps=None)
        models[str(where)] = m
    cpu, card = models["cpu"], models["cuda"]
    keys = [(1, 2), (3, 4), (5, 6), (7, 8)]
    for i, (a, b) in enumerate(zip(cpu._step_draws([keys], 16, 0.1596)[0],
                                   card._step_draws([keys], 16, 0.1596)[0])):
        if i == 2:  # the y prior: a softmax of bit-equal Gumbel values, the card's exp
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-5, atol=1e-12)
        else:  # the normals: XLA's erfinv spelled out, bit for bit
            assert torch.equal(b.cpu(), a)
    for (name, a), (_, b) in zip(cpu.state_dict().items(), card.state_dict().items()):
        pre_bn = name.endswith("dense.b") or name.endswith("bn.mean")
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-4,
                                   atol=4e-3 if pre_bn else 1e-6, err_msg=name)


@pytest.mark.cuda
def test_smooth_histogram_card_equals_cpu(cuda):
    """The engine's histogram smoothing is elementwise ops in a fixed order
    with each FMA rounded once, so the card gives the CPU's bits."""
    from vamb_torch import cluster

    rng = np.random.default_rng(3)
    hist = (rng.integers(0, 60, (500, 60)) * rng.integers(2000, 60_000, (500, 60))).astype(np.float32)
    hist[rng.random((500, 60)) < 0.4] = 0.0
    cpu = cluster.smooth_histogram(torch.as_tensor(hist))
    card = cluster.smooth_histogram(torch.as_tensor(hist, device=cuda)).cpu()
    assert torch.equal(card, cpu)
    assert torch.equal(cluster.smooth_histogram(torch.as_tensor(hist[5], device=cuda)).cpu(), cpu[5])


# Forward scores: the kernel's expf/log1pf and its block-wide orders differ
# from torch's, so kernel and plain version are held within
# HMM_TOL_ABS + HMM_TOL_REL * |score| bits (chip_smoke.py's tolerance).
HMM_TOL_ABS, HMM_TOL_REL = 1e-3, 1e-5


def _random_local(rng, m):
    "A random local profile as the kernel takes it: lom (M, 21), t, tbm."
    from vamb_torch.ops import hmm

    def dirichlet(n, k):
        x = rng.gamma(1.0, size=(n, k))
        return x / x.sum(axis=1, keepdims=True)

    trans = np.zeros((m + 1, 7))
    trans[:, 0:3], trans[:, 3:5], trans[:, 5:7] = dirichlet(m + 1, 3), dirichlet(m + 1, 2), dirichlet(m + 1, 2)
    trans[m] = [1.0, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0]
    trans[0, 2] = 0.0
    trans[0, 0:2] /= trans[0, 0:2].sum()
    prof = hmm.ProfileHMM("p", dirichlet(m, 20), np.tile(hmm.BACKGROUND, (m, 1)), trans, 10.0)
    local = hmm.configure_local(prof)
    lom = np.zeros((m, 21), np.float32)
    lom[:, :20] = local.lom
    return (lom, np.maximum(local.t, -1e30).astype(np.float32),
            np.maximum(local.tbm, -1e30).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 32, 33, 50, 256, 257, 600, 1000, 2048])
def test_hmm_forward_matches_plain(cuda, m):
    """Genes of 30-1,000 residues with null residues mid-sequence, in a
    batch padded to 1,024; widths on each side of every node count a lane
    (1, 2, 4, 8) and of every warp count a gene (M 256 / 257)."""
    rng = np.random.default_rng(m)
    lom, t, tbm = (torch.as_tensor(a) for a in _random_local(rng, m))
    lengths = np.concatenate([[30, 1000, 1], rng.integers(30, 1001, 13)])
    codes = np.full((len(lengths), 1024), 20, np.int8)
    for i, n in enumerate(lengths):
        codes[i, :n] = rng.integers(0, 20, n)
        codes[i, :n][rng.random(n) < 0.03] = 20
    codes_t, len_t = torch.as_tensor(codes), torch.as_tensor(lengths.astype(np.float32))
    plain = K.hmm_forward_plain(lom, t, tbm, codes_t, len_t)
    before = K.hmm_forward.launches
    got = K.hmm_forward(*(v.to(cuda) for v in (lom, t, tbm, codes_t, len_t))).cpu()
    assert K.hmm_forward.launches == before + 1
    assert torch.isfinite(got).all()
    assert ((got - plain).abs() <= HMM_TOL_ABS + HMM_TOL_REL * plain.abs()).all(), \
        float((got - plain).abs().max())


@pytest.mark.cuda
def test_hmm_forward_phase7_batch(cuda):
    """Phase 7's shape: 8,192 length-sorted genes of 30-1,000 residues with
    null residues mid-sequence, M 350 (two warps a gene), in one launch:
    the persistent CTAs walk every gene."""
    rng = np.random.default_rng(11)
    lom, t, tbm = (torch.as_tensor(a, device=cuda) for a in _random_local(rng, 350))
    lengths = np.sort(np.concatenate([[30, 1000], rng.integers(30, 1001, 8190)]))
    codes = np.full((len(lengths), 1024), 20, np.int8)
    for i, n in enumerate(lengths):
        codes[i, :n] = rng.integers(0, 20, n)
        codes[i, :n][rng.random(n) < 0.03] = 20
    codes_t = torch.as_tensor(codes, device=cuda)
    len_t = torch.as_tensor(lengths.astype(np.float32), device=cuda)
    before = K.hmm_forward.launches
    got = K.hmm_forward(lom, t, tbm, codes_t, len_t)
    assert K.hmm_forward.launches == before + 1
    plain = K.hmm_forward_plain(lom, t, tbm, codes_t, len_t)
    assert torch.isfinite(got).all()
    assert ((got - plain).abs() <= HMM_TOL_ABS + HMM_TOL_REL * plain.abs()).all(), \
        float((got - plain).abs().max())


def _gumbel_inputs(n, seed, mask):
    from vamb_torch.utils import threefry

    rng = np.random.default_rng(seed)
    key = threefry.split_host(threefry.key(seed))[1]
    d = rng.random(n).astype(np.float32) * 0.1
    kept, tried = rng.random(n) < 0.8, rng.random(n) < 0.1
    if mask == "none":
        kept[:] = False
    elif mask == "all":
        d[:], kept[:], tried[:] = 0.0, True, False
    return key, d, kept, tried, int(rng.integers(n))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8_192, 100_096, 300_032])
@pytest.mark.parametrize("mask", ["none", "some", "all"])
def test_gumbel_scores_matches_plain(cuda, n, mask):
    """The card's scores equal the plain version's bit for bit (jax's
    threefry bits and XLA's CPU log, every rounding spelled out), from one
    device kernel a call."""
    key, *arrays, medoid = _gumbel_inputs(n, n + len(mask), mask)
    d, kept, tried = (torch.as_tensor(a, device=cuda) for a in arrays)
    got = K.gumbel_scores(key, d, kept, tried, medoid)
    expect = K.gumbel_scores_plain(key, d.cpu(), kept.cpu(), tried.cpu(), medoid)
    assert torch.equal(got.cpu().view(torch.int32), expect.view(torch.int32))
    assert len(_one_launch(cuda, lambda: K.gumbel_scores(key, d, kept, tried, medoid),
                           "gumbel_topc_kernel")) == 3


def _tie_key(step: int):
    "k1 of step `step` of the engine's chain `key, k1 = split(key)` from PRNGKey(0)."
    from vamb_torch.utils import threefry

    key = threefry.PRNGKey(0)
    for _ in range(step + 1):
        key, k1 = threefry.split_host(key)
    return k1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8_192, 300_032])
@pytest.mark.parametrize("case", ["none", "some", "all", "tie 745", "tie 1603"])
@pytest.mark.parametrize("c", [1, 25, 32])
def test_gumbel_topc_matches_plain(cuda, n, case, c):
    """The card's candidates and their validity equal the plain version's
    (`jax.lax.top_k`'s order: score descending, index ascending), the
    optional scores bit for bit, from one device kernel a call. The tie
    keys are steps of the PRNGKey(0) chain whose top 25 of 8,192 columns,
    every column eligible but the medoid's, hold two equal scores."""
    if case.startswith("tie"):
        key, medoid = _tie_key(int(case[4:])), 0
        d, kept, tried = np.zeros(n, np.float32), np.ones(n, bool), np.zeros(n, bool)
    else:
        key, d, kept, tried, medoid = _gumbel_inputs(n, n + c + len(case), case)
    d, kept, tried = (torch.as_tensor(a, device=cuda) for a in (d, kept, tried))
    before = K.gumbel_topc.launches
    cand, valid, score = K.gumbel_topc(key, d, kept, tried, medoid, c, with_scores=True)
    assert K.gumbel_topc.launches == before + 1
    cand_p, valid_p, score_p = K.gumbel_topc_plain(key, d.cpu(), kept.cpu(), tried.cpu(), medoid, c,
                                                   with_scores=True)
    assert cand.dtype == torch.int64 and valid.dtype == torch.bool
    assert torch.equal(cand.cpu(), cand_p) and torch.equal(valid.cpu(), valid_p)
    assert torch.equal(score.cpu().view(torch.int32), score_p.view(torch.int32))
    assert torch.equal(K.gumbel_topc(key, d, kept, tried, medoid, c)[0], cand)
    if case.startswith("tie") and n == 8_192 and c == 25:
        top = score_p[cand_p]
        assert len(torch.unique(top)) < c, "no tie in the top C"
    if case == "some" and c == 25:  # the profiler, once a width: it drops records late in a run
        assert len(_one_launch(cuda, lambda: K.gumbel_topc(key, d, kept, tried, medoid, c),
                               "gumbel_topc_kernel")) == 3


# C above 32: `gumbel_topc` in rounds of 32 (a launch each), the density
# kernel in one launch whose last CTA sums 32 candidates a round
_MANY_C = [33, 40, 64, 100]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8_192, 100_096, 300_032])
@pytest.mark.parametrize("c", _MANY_C)
def test_gumbel_topc_above_32_matches_plain(cuda, n, c):
    """With no, some and all columns eligible and at a tie key: the
    candidates and their validity equal the plain version's, the optional
    scores bit for bit, in ceil(C / 32) launches a call; the shard entry
    point's keys equal its plain version's on two shards, and merged they
    give the same candidates."""
    cases = [_gumbel_inputs(n, n + c + len(mask), mask) for mask in ("none", "some", "all")]
    cases.append((_tie_key(745), np.zeros(n, np.float32), np.ones(n, bool), np.zeros(n, bool), 0))
    for key, *arrays, medoid in cases:
        d, kept, tried = (torch.as_tensor(a, device=cuda) for a in arrays)
        before = K.gumbel_topc.launches
        cand, valid, score = K.gumbel_topc(key, d, kept, tried, medoid, c, with_scores=True)
        assert K.gumbel_topc.launches == before + K.topc_launches(c)
        cand_p, valid_p, score_p = K.gumbel_topc_plain(key, d.cpu(), kept.cpu(), tried.cpu(),
                                                       medoid, c, with_scores=True)
        assert torch.equal(cand.cpu(), cand_p) and torch.equal(valid.cpu(), valid_p)
        assert torch.equal(score.cpu().view(torch.int32), score_p.view(torch.int32))
        assert torch.equal(K.gumbel_topc(key, d, kept, tried, medoid, c)[0], cand)
        keys = []
        for lo, hi in ((0, n // 2), (n // 2, n)):
            k = K.gumbel_topc_shard(key, d[lo:hi], kept[lo:hi], tried[lo:hi], medoid, c, n, lo)
            assert torch.equal(k.cpu(), K.gumbel_topc_shard_plain(
                key, d[lo:hi].cpu(), kept[lo:hi].cpu(), tried[lo:hi].cpu(), medoid, c, lo))
            keys.append(k)
        merged = K.topc_merge(torch.stack(keys), c)
        assert torch.equal(merged[0], cand) and torch.equal(merged[1], valid)
    if n == 100_096:
        key, d, kept, tried, medoid = _gumbel_inputs(n, 5, "some")
        d, kept, tried = (torch.as_tensor(a, device=cuda) for a in (d, kept, tried))
        assert len(_one_launch(cuda, lambda: K.gumbel_topc(key, d, kept, tried, medoid, c),
                               "gumbel_topc_kernel", K.topc_launches(c))) == 3 * K.topc_launches(c)


@pytest.mark.cuda
@pytest.mark.parametrize("n,f", [(8_192, 32), (100_096, 32), (300_032, 32), (100_096, 288)])
@pytest.mark.parametrize("c", _MANY_C)
def test_density_above_32_matches_plain(cuda, n, f, c):
    """The density kernel, its shard entry point and its bf16 variant at C
    above 32: bit for bit their plain versions (and the shard entry point
    on its own columns the index entry point), each in one launch a call."""
    mT_np, lengths = _clumpy(n, f, seed=n + c)
    lengths[np.random.default_rng(c).random(n) < 0.3] = 0.0
    mT = torch.as_tensor(mT_np, device=cuda)
    w = torch.as_tensor(lengths, device=cuda)
    cand = torch.as_tensor(np.random.default_rng(n + c).choice(n, c, replace=False), device=cuda)
    dens = K.candidate_density_sweep(mT, cand, w)
    assert torch.equal(dens, K.candidate_density_plain(mT, cand, w))
    q = mT[:, cand].contiguous()
    shard = K.candidate_density_shard(mT, q, cand, w)
    assert torch.equal(shard, K.candidate_density_shard_plain(mT, q, cand, w))
    assert torch.equal(shard, dens)
    bf = mT.to(torch.bfloat16)
    dens_bf = K.candidate_density_sweep(bf, cand, w)
    assert torch.equal(dens_bf, K.candidate_density_plain(bf, cand, w))
    assert torch.equal(dens_bf, K.candidate_density_sweep(bf.float(), cand, w))
    if n == 100_096 and f == 32:
        for fn in (lambda: K.candidate_density_sweep(mT, cand, w),
                   lambda: K.candidate_density_shard(mT, q, cand, w),
                   lambda: K.candidate_density_sweep(bf, cand, w)):
            assert len(_one_launch(cuda, fn, "candidate_density_kernel")) == 3


@pytest.mark.cuda
def test_wander_kernel_settings_on_the_card(cuda):
    """"auto", "pallas" and "xla" on the card emit what the engine emits on
    the CPU, at maxsteps 25 and 40 ("pallas" at 25: at 40 it is refused, as
    `vamb_tpu` refuses it); "xla" launches no hand-written kernel (the
    library's own count), "auto" and "pallas" launch `gumbel_topc` and the
    density kernel, at maxsteps 40 in two Gumbel launches a wander step."""
    from vamb_torch.cluster import ClusterGenerator
    from vamb_torch.parallel import make_mesh

    mT_np, lengths = _clumpy(6_000, 32, seed=14)
    m = np.ascontiguousarray(mT_np.T)
    fields = lambda c: (c.medoid, c.seed, c.kind_str, c.radius, c.members.tolist())  # noqa: E731
    for maxsteps in (25, 40):
        want = [fields(c) for c in ClusterGenerator(m.copy(), lengths, rng_seed=3, device="cpu",
                                                    maxsteps=maxsteps)]
        for setting in ("auto", "pallas", "xla"):
            if setting == "pallas" and maxsteps > 32:
                with pytest.raises(ValueError, match="requires maxsteps <= 32"):
                    ClusterGenerator(m.copy(), lengths, device=cuda, maxsteps=maxsteps,
                                     wander_kernel=setting)
                continue
            K.reset_launch_counts()
            before = K.device_launches()
            gen = ClusterGenerator(m.copy(), lengths, rng_seed=3, device=cuda, maxsteps=maxsteps,
                                   wander_kernel=setting)
            assert [fields(c) for c in gen] == want, (maxsteps, setting)
            grew = {k: v - before[k] for k, v in K.device_launches().items() if v != before[k]}
            if setting == "xla":
                assert grew == {} and K.gumbel_topc.launches == 0
            else:
                steps = K.candidate_density_sweep.launches
                assert steps > 0 and grew["candidate_density_kernel"] == steps
                assert K.gumbel_topc.launches == K.topc_launches(maxsteps) * steps
                assert grew["gumbel_topc_kernel"] == K.gumbel_topc.launches
    for kw in ({"distance_dtype": "bfloat16"}, {"mesh": make_mesh(1, device=cuda)}):
        with pytest.raises(ValueError, match="wander_kernel='pallas'"):
            ClusterGenerator(m.copy(), lengths, device=cuda, wander_kernel="pallas", **kw)


def _tiny_taxonomy_data(n=512, seed=0):
    "A small dataset and a 5-rank taxonomy cut at random depths, made with numpy."
    from vamb_torch.models import make_dataset
    from vamb_torch.models.hier import make_graph
    from vamb_torch.taxonomy import ContigTaxonomy

    rng = np.random.default_rng(seed)
    lineages = []
    for _ in range(n):
        g = int(rng.integers(0, 16))
        full = ["D", f"P{g // 8}", f"C{g // 4}", f"G{g // 2}", f"s{g}"]
        cut = int(rng.integers(0, 6))
        lineages.append(ContigTaxonomy(full[:cut]) if cut else None)
    nodes, ind, parents = make_graph(lineages)
    targets = np.array([0 if t is None else ind[t.ranks[-1]] for t in lineages])
    ds = make_dataset(rng.gamma(1.0, 5.0, (n, 4)).astype(np.float32),
                      rng.normal(size=(n, 103)).astype(np.float32), rng.integers(2000, 50_000, n))
    return ds, nodes, parents, targets


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["taxometer", "vaevae"])
def test_taxonomy_models_train_on_the_card_as_on_the_cpu(cuda, model):
    """Four optimizer steps of Taxometer and of VAEVAE on the card and on
    the CPU from one seed: the parameters within rtol 1e-4, atol 1e-6 (f32
    matmuls sum in another order on each); no hand-written kernel launches
    (training is cuBLAS and PyTorch's own kernels), and the profiler sees
    device kernels in every step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vamb_torch.models.taxometer import Taxometer
    from vamb_torch.models.vaevae import VAEVAE

    ds, nodes, parents, targets = _tiny_taxonomy_data()
    models = {}
    K.reset_launch_counts()
    for where in ("cpu", cuda):
        if model == "taxometer":
            m = Taxometer(4, len(nodes), nodes, parents, nhiddens=[64, 32], seed=3, device=where)
        else:
            m = VAEVAE(4, len(nodes), nodes, parents, nhiddens=[64, 64], nlatent=8,
                       hier_loss="flat_softmax", seed=3, device=where)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            m.trainmodel(ds, targets, nepochs=1, batchsize=128, batchsteps=None)
            torch.cuda.synchronize()
        models[str(where)] = (m, sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA))
    assert all(k.launches == 0 for k in K.KERNELS)
    (cpu, _), (card, card_kernels) = models["cpu"], models["cuda"]
    assert card_kernels >= 4
    for (name, a), (_, b) in zip(cpu.state_dict().items(), card.state_dict().items()):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)



@pytest.mark.cuda
def test_work_counters_card_equal_cpu_on_a_compacting_subset_run(cuda):
    """The engine's work counters on a compacting subset-scope run with
    lanes, on the card and on the CPU: one emission, the same effective
    count and emitted total (float32, exactly), and raw counts that differ
    by the kernels' terms alone (one row more a full-scope step, seven rows
    fewer a subset final row: `dist_terms`, exact below 2^31)."""
    from vamb_torch import cluster
    from vamb_torch.cluster import ClusterGenerator

    mT_np, lengths = _clumpy(6_000, 32, seed=21)
    m = np.ascontiguousarray(mT_np.T)
    kw = dict(rng_seed=5, wander_scope="subset", compact_min_pad=128, batch_clusters=16)
    fields = lambda c: (c.medoid, c.seed, c.kind_str, c.radius, c.members.tolist())  # noqa: E731
    q = cluster._SUBSET_Q
    cluster._SUBSET_Q = 1024
    try:
        runs = {}
        for dev in ("cpu", cuda):
            gen = ClusterGenerator(m.copy(), lengths, device=dev, **kw)
            runs[str(dev)] = ([fields(c) for c in gen], gen)
    finally:
        cluster._SUBSET_Q = q
    (want, cpu), (got, card) = runs["cpu"], runs[str(cuda)]
    assert got == want
    assert card.compactions and card.lane_counts["admitted"] > 0
    assert card.n_dists_effective == cpu.n_dists_effective > 0
    assert card.emitted_total == cpu.emitted_total == len(want)
    assert card.dist_terms == cpu.dist_terms and card._kernel_terms and not cpu._kernel_terms
    terms = card.dist_terms
    assert max(card.n_dists, cpu.n_dists) < 2 ** 31
    assert card.n_dists - cpu.n_dists == terms["full_steps"] - 7 * terms["final_rows"]
    card.drain()


@pytest.mark.cuda
def test_use_device_composition_on_the_card(cuda):
    """`Composition.from_file(use_device=True)` on the card: the host path's
    metadata, and its matrix within one mask step (2^12 ulps) of each row's
    largest value, in under 1% of the values (the card's product sums in
    another order than BLAS)."""
    import io

    from vamb_torch.composition import Composition

    rng = np.random.default_rng(4)
    data = b"".join(b">c%d\n%s\n" % (i, bytes(rng.choice(list(b"ACGT"), int(n)).tolist()))
                    for i, n in enumerate(rng.integers(1500, 6000, 2500)))
    host = Composition.from_file(io.BytesIO(data), None)
    card = Composition.from_file(io.BytesIO(data), None, use_device=True, device=cuda)
    assert np.array_equal(card.metadata.identifiers, host.metadata.identifiers)
    assert np.array_equal(card.metadata.mask, host.metadata.mask)
    a, b = card.matrix, host.matrix
    assert a.shape == b.shape and (a.view(np.uint32) & np.uint32(0xFFF) == 0).all()
    row = np.maximum(np.abs(a), np.abs(b)).max(axis=1, keepdims=True).astype(np.float32)
    assert (np.abs(a.astype(np.float64) - b) <= np.spacing(row) * 4096).all()
    assert (a == b).mean() > 0.99

"""The engine's wander switches that the port took last from vamb_tpu:
`maxsteps` above 32 and `wander_kernel` "pallas" / "xla", held against
vamb_tpu on the CPU.

* The plain versions at C > 32 (what the engine runs there on the CPU, and
  what the CUDA kernels equal on the card, tests/test_torch_cuda.py):
  `gumbel_topc_plain`'s candidates are `jax.lax.top_k`'s over vamb_tpu's
  scores at C 33, 40, 64 and 100, array-equal (tied scores and the -inf
  slots included), and the shards' keys merged by `topc_merge` give the
  same candidates at W = 2 and 4; the density's plain version equals
  vamb_tpu's XLA density expression (vamb_tpu/cluster.py:793-812) within
  rtol 1e-5 (f32 sums in another order, as tests/test_torch_cluster.py
  holds it against the Pallas kernel) and, bit for bit, its own sums of
  the candidates taken 32 at a time: the order is a function of N alone.
* The engine at `maxsteps` 33, 40 and 64 emits what vamb_tpu's
  `ClusterGenerator(compact_async=False)` emits, field by field as
  tests/test_torch_cluster.py compares: at full scope with attempt lanes
  off and at the subset scope (a 512-column ball) with lanes on and off,
  each compacting in batches of 8 clusters.
* The same at W = 2 under the mesh harness of tests/test_torch_parallel.py
  (gloo ranks, vamb_tpu's mesh engine on virtual CPU devices): each run's
  medoid, kind and members vamb_tpu's mesh engine's, every rank's emission
  and counters rank 0's; one run with `wander_kernel="xla"`.
* `wander_kernel`: "xla" calls the plain versions themselves; "xla" and
  "auto" emit alike, and both equal vamb_tpu's "xla", at full and subset
  scope. "pallas" raises ValueError in both packages for the same calls,
  with the same problems (vamb_tpu's "requires a TPU backend" is the
  port's "requires a CUDA device"): here on the CPU every "pallas" call is
  refused by both.
* Through the CLI on make_golden's dataset: `bin default --wander_kernel
  xla` writes the same cluster TSVs from both packages, and
  `--wander_kernel pallas` fails alike in both.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vamb_torch import cluster as t_cluster
from vamb_torch import kernels as K
from vamb_torch.__main__ import main as torch_main
from vamb_torch.cluster import ClusterGenerator as TorchGenerator
from vamb_torch.parallel import make_mesh as t_make_mesh
from vamb_torch.utils import threefry

from vamb_tpu import cluster as j_cluster
from vamb_tpu.__main__ import main as jax_main
from vamb_tpu.parallel import make_mesh as j_make_mesh

from . import make_golden
from ._torch_dist_worker import MAXSTEPS_RUNS
from .test_parity_cluster import clumpy_latents
from .test_torch_cluster import _assert_same_emission, _clumpy_data
from .test_torch_gumbel import _JIT_STEP, _masks
from .test_torch_parallel import assert_same_emission, jax_generator, join, launch, results

MAXSTEPS = (33, 40, 64)
BALL_Q = 512  # the subset wander's ball in these runs: a few balls across the latent


# ----------------------------------------------------- the plain versions


@pytest.mark.parametrize("c", [33, 40, 64, 100])
@pytest.mark.parametrize("mask", ["none", "some", "all", "tie 745"])
def test_gumbel_topc_plain_above_32_is_top_k(c, mask):
    n = 8_192
    if mask.startswith("tie"):  # a step of the PRNGKey(0) chain whose top 25 hold a tie
        kj, kt = jax.random.PRNGKey(0), threefry.PRNGKey(0)
        for _ in range(int(mask[4:]) + 1):
            (kj, k1j), (kt, k1t) = jax.random.split(kj), threefry.split_host(kt)
        d, kept, tried = _masks("all", n, None)
        medoid = 0
    else:
        rng = np.random.default_rng(c)
        d, kept, tried = _masks(mask, n, rng)
        medoid = int(rng.integers(n))
        (_, k1j), (_, k1t) = jax.random.split(jax.random.PRNGKey(c)), threefry.split_host(
            threefry.PRNGKey(c))
    score, cand_j, valid_j = _JIT_STEP(k1j, jnp.asarray(d), jnp.asarray(kept),
                                       jnp.asarray(tried), medoid, c)
    cand, valid = K.gumbel_topc(k1t, torch.as_tensor(d), torch.as_tensor(kept),
                                torch.as_tensor(tried), medoid, c)
    assert cand.shape == (c,)
    assert np.array_equal(cand.numpy(), np.asarray(cand_j))
    assert np.array_equal(valid.numpy(), np.asarray(valid_j))
    if mask.startswith("tie"):
        top = np.asarray(score)[np.asarray(cand_j)]
        assert len(np.unique(top)) < c, "no tie in the top C"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("c", [40, 64])
def test_gumbel_shards_merge_above_32(world, c):
    "Each shard's C keys (C above 32), merged, give `gumbel_topc`'s candidates over the width."
    n = 4_096
    rng = np.random.default_rng(world + c)
    d, kept, tried = _masks("some", n, rng)
    d, kept, tried = (torch.as_tensor(a) for a in (d, kept, tried))
    key = threefry.split_host(threefry.PRNGKey(c))[1]
    want = K.gumbel_topc(key, d, kept, tried, 77, c)
    keys = []
    for r in range(world):
        lo, hi = r * n // world, (r + 1) * n // world
        keys.append(K.gumbel_topc_shard(key, d[lo:hi], kept[lo:hi], tried[lo:hi], 77, c, n, lo))
    cand, valid = K.topc_merge(torch.stack(keys), c)
    assert torch.equal(cand, want[0]) and torch.equal(valid, want[1])


def _xla_density(mT, cand, lengths, kept):
    "vamb_tpu's XLA density of the candidates (vamb_tpu/cluster.py:793-812)."
    n = mT.shape[1]
    iota = jnp.arange(n)
    D = 0.5 - jnp.einsum("fc,fn->cn", mT[:, cand], mT, precision=jax.lax.Precision.HIGHEST,
                         preferred_element_type=jnp.float32)
    self_m = iota[None, :] == cand[:, None]
    kept_b = kept[None, :]
    return jnp.sum(jnp.where(self_m & kept_b, lengths[None, :] * 0.05,
                             jnp.where((D <= 0.05) & kept_b & ~self_m,
                                       lengths[None, :] * (0.05 - D), 0.0)), axis=1)


@pytest.mark.parametrize("c", [33, 40, 64, 100])
def test_density_plain_above_32(c):
    n = 4_096
    mT, lengths = _clumpy_data(n, seed=c)
    kept = np.arange(n) % 3 != 0
    wts = np.where(kept, lengths, 0.0).astype(np.float32)
    cand = np.random.default_rng(c).choice(n, size=c, replace=False)
    expect = np.asarray(jax.jit(_xla_density)(jnp.asarray(mT), jnp.asarray(cand),
                                              jnp.asarray(lengths), jnp.asarray(kept)))
    mT_t, wts_t, cand_t = torch.from_numpy(mT), torch.from_numpy(wts), torch.from_numpy(cand)
    got = K.candidate_density_sweep(mT_t, cand_t, wts_t)
    np.testing.assert_allclose(got.numpy(), expect, rtol=1e-5)
    parts = torch.cat([K.candidate_density_sweep(mT_t, cand_t[i:i + 32], wts_t)
                       for i in range(0, c, 32)])
    assert torch.equal(got, parts)


# ------------------------------------------------------ the engine, W = 1


_REGIMES = {
    "full scope, lanes off": dict(wander_scope="full", attempt_batch="off"),
    "subset scope, lanes on": dict(wander_scope="subset", attempt_batch="on"),
    "subset scope, lanes off": dict(wander_scope="subset", attempt_batch="off"),
}


@pytest.fixture
def ball(monkeypatch):
    "A 512-column ball on both packages, as tests/test_torch_cluster.py patches it."
    monkeypatch.setattr(j_cluster, "_SUBSET_Q", BALL_Q)
    monkeypatch.setattr(t_cluster, "_SUBSET_Q", BALL_Q)


@pytest.mark.parametrize("regime", list(_REGIMES))
@pytest.mark.parametrize("maxsteps", MAXSTEPS)
def test_engine_above_32_candidates_matches_vamb_tpu(maxsteps, regime, ball):
    matrix, lengths = clumpy_latents(24, 30, 32, noise_frac=0.1, seed=maxsteps)
    kw = dict(_REGIMES[regime], maxsteps=maxsteps, compact=True, compact_min_pad=128,
              batch_clusters=8, windowsize=60)
    gen = _assert_same_emission(matrix, lengths, rng_seed=5, jax_kwargs={"compact_async": False},
                                **kw)
    assert gen.C == maxsteps and gen.compactions
    if regime.startswith("subset"):
        assert gen.subset_counts["attempts"] > 0
        assert (gen.lane_counts["admitted"] > 0) == regime.endswith("on")


@pytest.mark.parametrize("scope", ["full", "subset"])
def test_wander_kernel_xla_and_auto_emit_alike(scope, ball):
    """"xla" runs the plain versions (here the wrappers run them too): the
    port's "xla" and "auto" emit alike, and equal vamb_tpu's "xla"."""
    matrix, lengths = clumpy_latents(25, 40, 32, noise_frac=0.2, seed=11)
    kw = dict(wander_scope=scope, windowsize=60, maxsteps=40)
    xla = _assert_same_emission(matrix, lengths, rng_seed=3, jax_kwargs={"compact_async": False},
                                compact=False, wander_kernel="xla", **kw)
    assert xla._kernels.gumbel_topc is K.gumbel_topc_plain
    assert xla._kernels.candidate_density_sweep is K.candidate_density_plain
    auto = TorchGenerator(matrix.copy(), lengths, rng_seed=3, device="cpu", compact=False, **kw)
    assert auto._kernels.gumbel_topc is K.gumbel_topc
    fields = lambda c: (c.medoid, c.seed, c.kind_str, c.radius, c.members.tolist())  # noqa: E731
    xla_again = TorchGenerator(matrix.copy(), lengths, rng_seed=3, device="cpu", compact=False,
                               wander_kernel="xla", **kw)
    assert [fields(c) for c in auto] == [fields(c) for c in xla_again]


# the calls "pallas" is refused for, and the problems each names in vamb_tpu
_PALLAS_CALLS = {
    "alone": ({}, ["requires a TPU backend"]),
    "maxsteps 40": ({"maxsteps": 40}, ["requires a TPU backend", "requires maxsteps <= 32"]),
    "bfloat16": ({"distance_dtype": "bfloat16"},
                 ["requires a TPU backend", "requires float32 distances"]),
    "mesh": ({"mesh": True}, ["requires a TPU backend", "does not support a sharded mesh"]),
    "all four": ({"mesh": True, "distance_dtype": "bfloat16", "maxsteps": 64},
                 ["requires a TPU backend", "does not support a sharded mesh",
                  "requires float32 distances", "requires maxsteps <= 32"]),
}


@pytest.mark.parametrize("call", list(_PALLAS_CALLS))
def test_wander_kernel_pallas_is_refused_alike(call):
    kw, problems = _PALLAS_CALLS[call]
    matrix, lengths = clumpy_latents(4, 10, 16, seed=1)
    errors = []
    for side in ("port", "jax"):
        args = dict(kw, wander_kernel="pallas")
        if args.pop("mesh", False):
            args["mesh"] = t_make_mesh(1, device="cpu") if side == "port" else j_make_mesh(1)
        with pytest.raises(ValueError) as err:
            if side == "port":
                TorchGenerator(matrix.copy(), lengths, device="cpu", **args)
            else:
                j_cluster.ClusterGenerator(matrix.copy(), lengths, compact_async=False, **args)
        errors.append(str(err.value))
    port, jax_side = (e.removeprefix("wander_kernel='pallas' ").split("; ") for e in errors)
    assert jax_side == problems
    assert port == ["requires a CUDA device", *problems[1:]]


def test_wander_kernel_bad_value_and_maxsteps_floor():
    matrix, lengths = clumpy_latents(4, 10, 16, seed=1)
    for kw in ({"wander_kernel": "cuda"}, {"maxsteps": 0}):
        with pytest.raises(ValueError):
            TorchGenerator(matrix.copy(), lengths, device="cpu", **kw)
        with pytest.raises(ValueError):
            j_cluster.ClusterGenerator(matrix.copy(), lengths, compact_async=False, **kw)


# ------------------------------------------------------ the engine, W = 2


def _maxsteps_inputs() -> dict:
    "The maxsteps scenario's runs (tests/_torch_dist_worker.py's MAXSTEPS_RUNS)."
    m, lens = clumpy_latents(30, 40, 16, noise_frac=0.1, seed=17)
    base = dict(rng_seed=4, windowsize=60, batch_clusters=8, compact_min_pad=256)
    kws = {
        "ms33_full": dict(base, maxsteps=33, wander_scope="full"),
        "ms40_subset_on": dict(base, maxsteps=40, wander_scope="subset", attempt_batch="on"),
        "ms64_subset_off": dict(base, maxsteps=64, wander_scope="subset", attempt_batch="off"),
        "ms40_xla": dict(base, maxsteps=40, wander_scope="subset", wander_kernel="xla"),
    }
    out = {}
    for name in MAXSTEPS_RUNS:
        out.update({f"{name}_m": m, f"{name}_len": lens, f"{name}_kw": kws[name]})
        if "subset" in kws[name].get("wander_scope", ""):
            out[f"{name}_q"] = BALL_Q
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    "Two gloo ranks run the maxsteps scenario while vamb_tpu's W = 2 mesh engine runs each run."
    d = tmp_path_factory.mktemp("maxsteps_w2")
    procs = launch(2, d, ("maxsteps",), _maxsteps_inputs())
    try:
        inp = np.load(d / "inputs.npz", allow_pickle=True)
        mesh = j_make_mesh(2)
        refs = {name: [(int(c.medoid), c.kind_str, np.sort(np.asarray(c.members)))
                       for c in jax_generator(inp, name, mesh)] for name in MAXSTEPS_RUNS}
    finally:
        join(procs)
    return d, refs


@pytest.mark.parametrize("name", MAXSTEPS_RUNS)
def test_sharded_engine_above_32_candidates_matches_vamb_tpu_mesh(two_ranks, name):
    d, refs = two_ranks
    res = results(d, "maxsteps", 2)
    for key in (name, f"{name}_compactions", f"{name}_subset_counts", f"{name}_lane_counts"):
        np.testing.assert_array_equal(res[1][key], res[0][key], err_msg=key)
    assert_same_emission(res[0][name], refs[name])
    assert len(res[0][f"{name}_compactions"]) > 0
    if "subset" in name or "xla" in name:
        assert res[0][f"{name}_subset_counts"][0] > 0


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def golden_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("wander_cli_data")
    make_golden.write_synthetic_dataset(d)
    return d


def _argv(data, out, *extra):
    return ["bin", "default", "--outdir", str(out), "--fasta", str(data / "contigs.fna"),
            "--abundance_tsv", str(data / "abundance.tsv"), "-e", str(make_golden.EPOCHS),
            "-q", "2", "--seed", str(make_golden.SEED), "-u", str(make_golden.MIN_SUCCESSES),
            *extra]


def test_cli_wander_kernel_xla_writes_the_same_tsvs(golden_data, tmp_path):
    torch_main(_argv(golden_data, tmp_path / "port", "--wander_kernel", "xla"), device="cpu")
    jax_main(_argv(golden_data, tmp_path / "jax", "--wander_kernel", "xla"))
    for name in ("vae_clusters_unsplit.tsv", "vae_clusters_split.tsv",
                 "vae_clusters_metadata.tsv"):
        port = (tmp_path / "port" / name).read_bytes()
        assert port == (tmp_path / "jax" / name).read_bytes(), name
        assert port == (make_golden.GOLDEN_DIR / name).read_bytes(), name


def test_cli_wander_kernel_pallas_fails_alike(golden_data, tmp_path):
    with pytest.raises(ValueError, match="wander_kernel='pallas' requires a CUDA device"):
        torch_main(_argv(golden_data, tmp_path / "port", "--wander_kernel", "pallas"),
                   device="cpu")
    with pytest.raises(ValueError, match="wander_kernel='pallas' requires a TPU backend"):
        jax_main(_argv(golden_data, tmp_path / "jax", "--wander_kernel", "pallas"))

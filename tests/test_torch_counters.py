"""The clustering engine's work counters, held against vamb_tpu on the CPU.

`ClusterGenerator.n_dists` (raw distance evaluations), `n_dists_effective`
(the reference-equivalent ones, the numerator of the system's headline
unit, clustering dists/s) and `emitted_total` are `vamb_tpu`'s
(vamb_tpu/cluster.py:2064-2093): both distance counters are float32 sums
of the same terms, added in the same order, so they must be equal, not
close. Every term is a multiple of 128, so the sums are exact below 2^31
and no tolerance is needed anywhere here.

The one departure: where a lane needs the full climb, `vamb_tpu` still
climbs the lanes after it, which decide nothing, and its raw count holds
their steps; the port does not climb them (`dist_terms["unclimbed_lanes"]`
counts them), so its raw count is `vamb_tpu`'s less those steps, each C x Q
evaluations (Q a multiple of 128). `_assert_work` holds it to exactly that:
the same raw count where no lane went unclimbed, and else one smaller by a
multiple of C x 128. The effective count and the emitted total are equal
everywhere.

* Each regime runs both packages (`vamb_tpu` with `compact_async=False`)
  in batches of a few clusters and compares the three counters at every
  batch's end, where `vamb_tpu` decodes them, and at the run's end: full
  scope, the subset scope with attempt lanes on and off, a compacting run,
  loner bursts, lanes that need the full climb after a ball that
  overflows and after a medoid that drifts (with later lanes left
  unclimbed), bfloat16 distances, maxsteps 40, and a run
  whose raw count passes 2^24.
* Under the plain versions (`wander_kernel="xla"`, and "auto" on the CPU)
  the raw count is `vamb_tpu`'s "xla" family's; the kernels' "pallas"
  family differs from it by one row a full-scope step and one row instead
  of eight a subset final row, which `dist_terms` sums exactly.
* At W = 2 (tests/_torch_dist_worker.py's "counters" scenario) every rank
  holds `vamb_tpu`'s mesh engine's counts.
* `drain()`, twice, changes no later emission; `Cluster.as_tuple` is
  `vamb_tpu`'s.
"""

import itertools

import numpy as np
import pytest

from vamb_torch import cluster as t_cluster
from vamb_torch.cluster import ClusterGenerator as TorchGenerator

from vamb_tpu import cluster as j_cluster
from vamb_tpu.parallel import make_mesh as j_make_mesh

from ._torch_dist_worker import COUNTER_RUNS
from .test_parity_cluster import clumpy_latents
from .test_torch_cluster import _wide_clumps
from .test_torch_lanes import _dense_clumps, _loner_tail
from .test_torch_parallel import assert_same_emission, jax_generator, join, launch, results


def _work(gen) -> tuple:
    return (gen.n_dists, gen.n_dists_effective, gen.emitted_total)


def _assert_work(work, unclimbed: int, c: int, want: tuple, where=None) -> None:
    """The port's (raw, effective, emitted) `work` against `vamb_tpu`'s
    `want`: effective and emitted equal; raw equal where no lane went
    unclimbed, else smaller by the unclimbed lanes' steps (C x Q each)."""
    assert work[1:] == want[1:], (where, work, want)
    gap = want[0] - work[0]  # both exact multiples of 128 below 2^31
    if unclimbed == 0:
        assert gap == 0, (where, work, want)
    else:
        assert gap >= 0 and gap % (c * 128) == 0, (where, work, want, unclimbed)


# label: (data, generator arguments, the subset wander's ball Q or None)
_REGIMES = {
    "full scope": (lambda: clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2),
                   dict(rng_seed=7, windowsize=60, wander_scope="full", batch_clusters=16), None),
    "subset, lanes on": (lambda: clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2),
                         dict(rng_seed=7, windowsize=60, wander_scope="subset",
                              attempt_batch="on", batch_clusters=4), None),
    "subset, lanes off": (lambda: clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2),
                          dict(rng_seed=7, windowsize=60, wander_scope="subset",
                               attempt_batch="off", batch_clusters=4), None),
    "compaction": (lambda: clumpy_latents(70, 30, 32, seed=5),
                   dict(rng_seed=5, compact=True, compact_min_pad=128, batch_clusters=8,
                        wander_scope="subset"), 512),
    "loner bursts": (lambda: _loner_tail(20, 25, 700, seed=5),
                     dict(rng_seed=5, batch_clusters=8, compact=False, wander_scope="subset"),
                     None),
    "lanes need the full climb": (lambda: _dense_clumps(6, 600, seed=8),
                                  dict(rng_seed=3, wander_scope="subset", batch_clusters=2), 512),
    "overflow and drift": (lambda: _wide_clumps(40, 60, 32, scale=0.06, noise_frac=0.2, seed=4),
                           dict(rng_seed=13, windowsize=120, wander_scope="subset",
                                batch_clusters=16), 1024),
    "bfloat16": (lambda: clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2),
                 dict(rng_seed=7, windowsize=60, distance_dtype="bfloat16", batch_clusters=4),
                 None),
    "maxsteps 40": (lambda: clumpy_latents(24, 30, 32, noise_frac=0.1, seed=40),
                    dict(maxsteps=40, wander_scope="subset", attempt_batch="on", compact=True,
                         compact_min_pad=128, batch_clusters=8, windowsize=60, rng_seed=5), 512),
    "raw past 2^24": (lambda: clumpy_latents(70, 30, 32, noise_frac=0.2, seed=5),
                      dict(rng_seed=5, wander_scope="subset", windowsize=60, batch_clusters=16),
                      None),
}

# what each regime must reach, so that its terms are exercised
_REACHED = {
    "compaction": lambda g: len(g.compactions) == 2 and g.lane_counts["admitted"] > 0,
    "loner bursts": lambda g: g.lane_counts["burst_loners"] > 0,
    "lanes need the full climb": lambda g: (g.lane_counts["cut_full"] > 0
                                            and g.subset_counts["overflow"] > 0
                                            and g.dist_terms["unclimbed_lanes"] > 0),
    "overflow and drift": lambda g: (g.lane_counts["cut_full"] > 0
                                     and g.subset_counts["drift"] > 0
                                     and g.dist_terms["unclimbed_lanes"] > 0),
    "subset, lanes on": lambda g: g.lane_counts["admitted"] > 0 and g.lane_counts["bursts"] > 0,
    "raw past 2^24": lambda g: g.n_dists > 2 ** 24,
}


@pytest.fixture
def ball(monkeypatch):
    def patch(q):
        if q is not None:
            monkeypatch.setattr(j_cluster, "_SUBSET_Q", q)
            monkeypatch.setattr(t_cluster, "_SUBSET_Q", q)
    return patch


@pytest.mark.parametrize("regime", list(_REGIMES))
def test_counters_equal_vamb_tpu_at_every_batch(regime, ball):
    data, kw, q = _REGIMES[regime]
    ball(q)
    matrix, lengths = data()
    jgen = j_cluster.ClusterGenerator(matrix.copy(), lengths, compact_async=False, **kw)
    gen = TorchGenerator(matrix.copy(), lengths, device="cpu", **kw)
    k = kw["batch_clusters"]
    seen = 0
    for i, (a, b) in enumerate(itertools.zip_longest(jgen, gen)):
        assert a is not None and b is not None, i
        assert (b.medoid, b.kind_str) == (int(a.medoid), a.kind_str), i
        assert gen.emitted_total >= i + 1
        if (i + 1) % k == 0:  # a batch's end: vamb_tpu has decoded exactly it
            _assert_work(_work(gen), gen.dist_terms["unclimbed_lanes"], gen.C, _work(jgen), i)
            seen += 1
    _assert_work(_work(gen), gen.dist_terms["unclimbed_lanes"], gen.C, _work(jgen))
    assert gen.emitted_total == i + 1 == jgen.emitted_total
    assert seen > 0 and gen.n_dists > gen.n_dists_effective > 0
    assert _REACHED.get(regime, lambda g: True)(gen), (gen.lane_counts, gen.subset_counts)


@pytest.mark.parametrize("scope", ["full", "subset"])
def test_plain_versions_and_auto_count_alike_and_kernel_terms(scope, ball):
    """"xla" and "auto" on the CPU both add vamb_tpu's "xla" terms. The
    kernels' family ("pallas", as on the card) adds, over the same attempts,
    one row more each full-scope step and seven rows fewer each subset
    final row: `dist_terms` holds those sums of N exactly."""
    ball(512)
    matrix, lengths = clumpy_latents(40, 30, 32, noise_frac=0.2, seed=9)
    kw = dict(rng_seed=3, windowsize=60, wander_scope=scope, batch_clusters=16,
              compact_min_pad=128)
    runs = {}
    for name in ("xla", "auto", "kernel terms"):
        gen = TorchGenerator(matrix.copy(), lengths, device="cpu",
                             wander_kernel="xla" if name == "xla" else "auto", **kw)
        assert not gen._kernel_terms
        gen._kernel_terms = name == "kernel terms"
        runs[name] = ([(c.medoid, c.members.tolist()) for c in gen], gen)
    jgen = j_cluster.ClusterGenerator(matrix.copy(), lengths, compact_async=False,
                                      wander_kernel="xla", **kw)
    list(jgen)
    (xla, g_xla), (auto, g_auto), (kern, g_kern) = runs.values()
    assert xla == auto == kern
    assert _work(g_xla) == _work(g_auto)
    _assert_work(_work(g_xla), g_xla.dist_terms["unclimbed_lanes"], g_xla.C, _work(jgen))
    assert g_kern.n_dists_effective == g_xla.n_dists_effective
    assert g_kern.dist_terms == g_xla.dist_terms
    terms = g_xla.dist_terms
    assert terms["full_steps"] > 0 and (terms["final_rows"] > 0) == (scope == "subset")
    assert max(g_kern.n_dists, g_xla.n_dists) < 2 ** 31  # both sums exact
    assert g_kern.n_dists - g_xla.n_dists == terms["full_steps"] - 7 * terms["final_rows"]


def test_drain_twice_changes_no_emission():
    matrix, lengths = clumpy_latents(25, 25, 32, noise_frac=0.2, seed=2)
    kw = dict(rng_seed=7, windowsize=60, wander_scope="subset", batch_clusters=8)
    fields = lambda c: (c.medoid, c.seed, c.kind_str, c.radius, c.members.tolist())  # noqa: E731
    want = [fields(c) for c in TorchGenerator(matrix.copy(), lengths, device="cpu", **kw)]
    gen = TorchGenerator(matrix.copy(), lengths, device="cpu", **kw)
    got = [fields(c) for c in itertools.islice(gen, 11)]
    work = _work(gen)
    gen.drain()
    gen.drain()
    assert _work(gen) == work
    got += [fields(c) for c in gen]
    assert got == want


def test_cluster_as_tuple_is_vamb_tpus():
    matrix, lengths = clumpy_latents(6, 20, 16, seed=1)
    port = next(TorchGenerator(matrix.copy(), lengths, device="cpu"))
    jax_side = next(j_cluster.ClusterGenerator(matrix.copy(), lengths, compact_async=False))
    (pm, pmem), (jm, jmem) = port.as_tuple(), jax_side.as_tuple()
    assert pm == int(jm) and pmem is port.members
    np.testing.assert_array_equal(pmem, jmem)


# ------------------------------------------------------------ W = 2


def _counter_inputs() -> dict:
    "The counters scenario's runs (tests/_torch_dist_worker.py's COUNTER_RUNS)."
    m, lens = clumpy_latents(30, 40, 16, noise_frac=0.1, seed=23)
    base = dict(rng_seed=4, windowsize=60, batch_clusters=8, compact_min_pad=256)
    kws = {"cnt_full": dict(base, wander_scope="full"),
           "cnt_subset": dict(base, wander_scope="subset", attempt_batch="on", compact=False),
           "cnt_compact": dict(base, wander_scope="subset")}
    out = {}
    for name in COUNTER_RUNS:
        out.update({f"{name}_m": m, f"{name}_len": lens, f"{name}_kw": kws[name]})
        if kws[name].get("wander_scope") == "subset":
            out[f"{name}_q"] = 512
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    "Two gloo ranks run the counters scenario while vamb_tpu's W = 2 mesh engine runs each run."
    d = tmp_path_factory.mktemp("counters_w2")
    procs = launch(2, d, ("counters",), _counter_inputs())
    try:
        inp = np.load(d / "inputs.npz", allow_pickle=True)
        mesh = j_make_mesh(2)
        refs = {}
        for name in COUNTER_RUNS:
            gen = jax_generator(inp, name, mesh)
            clusters = [(int(c.medoid), c.kind_str, np.sort(np.asarray(c.members))) for c in gen]
            refs[name] = (clusters, _work(gen))
    finally:
        join(procs)
    return d, refs


@pytest.mark.parametrize("name", COUNTER_RUNS)
def test_sharded_counters_equal_vamb_tpu_mesh(two_ranks, name):
    d, refs = two_ranks
    res = results(d, "counters", 2)
    clusters, work = refs[name]
    assert_same_emission(res[0][name], clusters)
    c = _counter_inputs()[f"{name}_kw"].get("maxsteps", 25)
    for r in res:
        _assert_work(tuple(r[f"{name}_work"].tolist()), int(r[f"{name}_unclimbed"]), c, work)
    if name == "cnt_compact":
        assert len(res[0][f"{name}_compactions"]) > 0
    if name != "cnt_full":
        assert res[0][f"{name}_lane_counts"][6] > 0  # lanes admitted

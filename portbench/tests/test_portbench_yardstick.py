"""The yardstick's arithmetic gives known values for known shapes: peaks
and bounds, the kernels' least times, the whole steps' MFU, a schedule
unit's work, and the trace's reductions."""

import math
from types import SimpleNamespace

import pytest

import tiny  # noqa: F401  (the repo on sys.path)
from portbench.lib import kernel_bounds, peaks, trace
from portbench.lib.harness import load_module
from tiny import ROOT, entry


def test_bound_is_the_longer_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)
    assert peaks.bound_s(0, 0, 64 * 132 * 1.98e9) == pytest.approx(1.0)
    assert peaks.mfu_percent(67e12, 2.0) == pytest.approx(50.0)


def test_medoid_sweep_bound_at_the_300k_width():
    n, f = 300_032, 32
    want = max(4 * (f * n + 2 * n + 62) / 3.35e12, (2 * f * n + n) / 67e12)
    got = kernel_bounds.mean_bound_s("medoid_sweep", {n: 3}, f, f)
    assert got == pytest.approx(want)
    assert got == pytest.approx(0.0122 * 1e-3, rel=0.01)  # bytes-bound: 0.0122 ms


def test_mean_bound_weighs_widths_by_launches():
    a = kernel_bounds.mean_bound_s("row_sweep", {1000: 1}, 32, 32)
    b = kernel_bounds.mean_bound_s("row_sweep", {3000: 1}, 32, 32)
    assert kernel_bounds.mean_bound_s("row_sweep", {1000: 1, 3000: 3}, 32, 32) == pytest.approx(
        (a + 3 * b) / 4)
    assert kernel_bounds.mean_bound_s("row_sweep", {}, 32, 32) is None


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::medoid_sweep_kernel<float, true>(float const*)", "medoid_sweep"),
    ("(anonymous namespace)::gumbel_topc_kernel(unsigned int)", "gumbel_topc"),
    ("void (anonymous namespace)::row_sweep_any_kernel(float const*)", "row_sweep"),
    ("void at::native::vectorized_elementwise_kernel<4>", None),
])
def test_trace_names_map_to_their_wrappers(name, family):
    assert kernel_bounds.family_of(name) == family


def test_roofline_reader_from_a_trace():
    rl = entry.reader("cluster_kernel_roofline")
    n, f = 100_096, 32
    b = kernel_bounds.mean_bound_s("medoid_sweep", {n: 10}, f, f)
    r = SimpleNamespace(work={"launches": {"medoid_sweep": {n: 10}}, "f": f, "f_pad": f},
                        trace={"ops": {"medoid_sweep_kernel<float, true>": (4, 4 * b * 5),
                                       "elementwise_kernel": (9, 1.0)}})
    assert rl.read(r) == pytest.approx(20.0)


def test_mfu_readers():
    """The whole step's share of the peak over the untraced window's wall
    time: the trace's own times do not enter it."""
    trace_ = {"reduce_s": 1.0, "window_s": 9.0}
    work = {"n_dists_effective": 67e12 / 64, "f": 32, "window_s": 2.0}
    assert entry.reader("cluster_mfu").read(SimpleNamespace(work=work, trace=trace_)) == \
        pytest.approx(50.0)
    work = {"contigs": 10, "flops_per_contig": 6.7e12, "window_s": 1.0}
    assert entry.reader("train_mfu").read(SimpleNamespace(work=work, trace=trace_)) == \
        pytest.approx(100.0)
    assert entry.reader("cluster_mfu").read(SimpleNamespace(work=work, trace=None)) is None


def test_a_schedule_unit_of_the_published_schedule():
    w = load_module(ROOT / "portbench/windows/schedule_units.py", "w_sched")
    cfg = entry.cell(entry.with_held(entry.manifest()), "train.vamb_s10.sched").config
    assert w.schedule(cfg, 100_000) == [256, 512, 512, 1024, 1024, 1024, 2048, 2048, 2048,
                                        4096, 4096, 4096]
    assert w.unit_work(cfg, 100_000) == (1287, 1_187_328)
    assert w.linear_flops_per_contig(cfg) == 6 * 673_792


def test_idle_share_and_kernel_counts():
    t = {"window_s": 2.0, "busy_s": 0.5, "steps": 4, "kernels": 100, "reduce_s": 0.0}
    r = SimpleNamespace(trace=t)
    assert entry.reader("device_idle_share.cluster").read(r) == pytest.approx(75.0)
    assert entry.reader("cluster_kernels_per_cluster").read(r) == pytest.approx(25.0)
    assert entry.reader("device_idle_share.train").read(SimpleNamespace(trace=None)) is None


def test_union_and_top_level_host_operations():
    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    host = [(0, 10, "outer", 1), (2, 4, "inner", 1), (11, 12, "next", 1), (3, 20, "other", 2)]
    assert trace._top_level(host) == [(0, 10, "outer"), (3, 20, "other"), (11, 12, "next")]


def test_breakdown_keeps_the_largest_ten():
    t = {"ops": {f"k{i}": (1, float(i)) for i in range(15)},
         "gaps": {f"h{i}": float(i) for i in range(12)}}
    b = trace.breakdown(t)
    assert [x[0] for x in b["device_ops"]][:2] == ["k14", "k13"] and len(b["device_ops"]) == 10
    assert len(b["idle_gaps"]) == 10 and math.isclose(b["idle_gaps"][0][1], 11.0)


def test_a_traced_run_reads_rates_from_its_untraced_window():
    """A traced run runs the window untraced first and then one unit under
    the trace: its whole step's share of the peak is the untraced
    window's work over that window's time."""
    import tiny

    result, _ = tiny.run("train.vamb_s10.sched", trace=True)
    assert result["correct"]
    w = load_module(ROOT / "portbench/windows/schedule_units.py", "w_sched_traced")
    cfg = tiny.cell("train.vamb_s10.sched").config
    _, contigs = w.unit_work(cfg, tiny.TINY_TRAFFIC["contigs"])
    want = peaks.mfu_percent(result["run"]["units"] * contigs * w.linear_flops_per_contig(cfg),
                             result["run"]["window_s"])
    assert result["metrics"]["train_mfu"]["value"] == pytest.approx(want)
    assert result["device"]["window_s"] > 0

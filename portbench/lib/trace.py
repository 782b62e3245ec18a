"""The traced run's device trace, sampled and reduced as it is taken.

A window runs millions of kernels, more than a profiler can hold and a run
can reduce in its time limit. So `SampledTrace` records `active` steps out
of every `every` (a step is a unit the window marks: an emitted cluster, an
optimizer step), spread over the whole window, and reduces each recorded
cycle at once to sums: the traced time, the device's busy time (the union
of its operations' intervals), operation counts and time by name, and the
idle gaps attributed to the host operation that was running.
"""

import bisect
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, schedule

_HOST_GAP = "host_code_between_ops"


def _is_device(ev) -> bool:
    return ev.device_type() != torch.autograd.DeviceType.CPU


def _is_annotation(ev) -> bool:
    "A span the profiler or a caller marked (a step's), not an operation."
    marked = getattr(ev, "is_user_annotation", None)
    return (marked is not None and marked()) or ev.name().startswith("ProfilerStep#")


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "Memory"))


def _union(intervals):
    "Sorted, merged (start, end) pairs of `intervals`."
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _top_level(host):
    """Per thread, the host operations not nested in another: (start, end,
    name), sorted by start."""
    by_thread = defaultdict(list)
    for a, b, name, tid in host:
        by_thread[tid].append((a, -b, name))
    out = []
    for evs in by_thread.values():
        end = None
        for a, nb, name in sorted(evs):
            if end is None or a >= end:
                out.append((a, -nb, name))
                end = -nb
    return sorted(out)


class SampledTrace:
    "A profiler over a window that records `active` of every `every` steps."

    def __init__(self, every: int, active: int):
        if not 0 < active < every - 1:
            raise ValueError(f"need 0 < active < every - 1, not {active}, {every}")
        self.window_ns = 0
        self.busy_ns = 0
        self.steps = 0
        self.kernels = 0
        self.ops = defaultdict(lambda: [0, 0])  # device op name -> [count, ns]
        self.gaps = defaultdict(int)  # host operation -> idle ns
        self.reduce_s = 0.0  # host seconds spent here, inside the window
        self._prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=every - active - 1, warmup=1, active=active, repeat=0),
            on_trace_ready=self._reduce,
        )

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self._prof.__exit__(*exc)

    def step(self) -> None:
        self._prof.step()

    def _reduce(self, prof) -> None:
        t0 = time.perf_counter()
        try:
            self._reduce_cycle(prof)
        finally:
            self.reduce_s += time.perf_counter() - t0

    def _reduce_cycle(self, prof) -> None:
        steps, device, host = [], [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            a = ev.start_ns()
            b = a + ev.duration_ns()
            if _is_device(ev) and _is_annotation(ev):
                continue  # a step's span mirrored on the device's timeline, no operation
            if _is_device(ev):
                device.append((a, b, name))
            elif name.startswith("ProfilerStep#"):
                steps.append((a, b))
            else:
                host.append((a, b, name, ev.start_thread_id()))
        if not steps:
            return
        lo, hi = min(a for a, _ in steps), max(b for _, b in steps)
        self.steps += len(steps)
        self.window_ns += hi - lo
        inside = [(max(a, lo), min(b, hi), name) for a, b, name in device if b > lo and a < hi]
        for a, b, name in inside:
            rec = self.ops[name]
            rec[0] += 1
            rec[1] += b - a
            self.kernels += _is_kernel(name)
        busy = _union([(a, b) for a, b, _ in inside])
        self.busy_ns += sum(b - a for a, b in busy)
        edges = [lo] + [t for iv in busy for t in iv] + [hi]
        top = _top_level([h for h in host if h[1] > lo and h[0] < hi])
        starts = [t[0] for t in top]
        for ga, gb in zip(edges[::2], edges[1::2]):
            if gb <= ga:
                continue
            covered = []
            i = max(0, bisect.bisect_right(starts, ga) - 1)
            while i < len(top) and top[i][0] < gb:
                a, b, name = top[i]
                a, b = max(a, ga), min(b, gb)
                if b > a:
                    self.gaps[name] += b - a
                    covered.append((a, b))
                i += 1
            self.gaps[_HOST_GAP] += (gb - ga) - sum(b - a for a, b in _union(covered))

    def result(self) -> dict:
        """The reduced trace: traced and busy seconds, steps and kernels
        recorded, each device operation's count and seconds, the idle
        seconds by the host operation that ran during them, and the host
        seconds the reduction itself took inside the window."""
        return {
            "window_s": self.window_ns * 1e-9,
            "reduce_s": self.reduce_s,
            "busy_s": self.busy_ns * 1e-9,
            "steps": self.steps,
            "kernels": self.kernels,
            "ops": {k: (c, ns * 1e-9) for k, (c, ns) in self.ops.items()},
            "gaps": {k: ns * 1e-9 for k, ns in self.gaps.items()},
        }


def breakdown(trace: dict, n: int = 10) -> dict:
    "The `n` device operations and host operations behind idle gaps that took most time."
    ops = sorted(((k, s) for k, (_, s) in trace["ops"].items()), key=lambda x: -x[1])[:n]
    gaps = sorted(trace["gaps"].items(), key=lambda x: -x[1])[:n]
    return {"device_ops": [[k[:96], s] for k, s in ops], "idle_gaps": [[k[:96], s] for k, s in gaps]}

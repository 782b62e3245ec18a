"""One run of a cell: set-up, the window, the metrics and the output check.

A window module (`windows/<kind>.py`) provides:

* `setup(run)`: make the inputs from `run.seed`, build the program's
  objects and warm up every shape the window uses;
* `window(run, seconds, tracer)`: run whole units of work back to back
  until `seconds` have passed, the last unit to its end, and return the
  window's counts (its wall time under "window_s", its units under
  "units", each unit's seconds under "unit_s" where it times them),
  calling `tracer.step()` after each traced step where a tracer is given;

A traced run (`--trace 1`) runs the window as an untraced run does, whose
counts and wall time the metrics read, and then one unit more under the
sampled device trace, which gives the metrics read from the trace: the
profiler's own cost stays out of every rate and share of a peak.
* `release(run)`: drop the program's state, keeping the outputs to check;
* `check(run, work)`: compare the outputs with the plain reference and
  return ({number: value}, units attempted). A run whose numbers are
  not all within their limits counts every unit as failed.

`run.device` is the card for a benchmark run; the tests drive the same
functions on the CPU. `run.fault` and `run.control`, None in a benchmark
run, plant a fault or switch the control precision for the tests of the
check.
"""

import importlib.util
import time
from types import SimpleNamespace

import torch

from .trace import SampledTrace, breakdown


def load_module(path, name: str):
    "The module in file `path`, by a name of its own."
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(c, seed: int, seconds: float, trace: bool, device, t0: float, reader,
        fault=None, control=None):
    """Run the cell `c` (run.py's `cell`) once. Returns (the result line's
    object, {number: (value, limit)})."""
    window = load_module(c.window_path, "portbench_window_" + c.traffic["window"])
    state = SimpleNamespace(config=c.config, traffic=c.traffic, seed=seed, device=device,
                            fault=fault, control=control)
    cuda = device.type == "cuda"
    window.setup(state)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    work = window.window(state, seconds, None)
    traced = None
    if trace:  # then one unit more under the tracer, whose own cost stays out of `work`
        with SampledTrace(c.traffic["trace_every"], c.traffic["trace_active"]) as tracer:
            window.window(state, 0.0, tracer)
        traced = tracer.result()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window.release(state)
    if cuda:
        torch.cuda.empty_cache()
    numbers, attempted = window.check(state, work)
    if set(numbers) != set(c.limits):
        raise ValueError(f"the check compares {sorted(numbers)}; the limits name {sorted(c.limits)}")
    checks = {name: (value, c.limits[name]) for name, value in numbers.items()}
    correct = all(value <= limit for value, limit in checks.values())
    r = SimpleNamespace(setup_s=setup_s, work=work, trace=traced, config=c.config)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = reader(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": 0 if correct else int(attempted), "metrics": metrics,
              "device": dev}
    if traced is not None:
        result["breakdown"] = breakdown(traced)
    result["run"] = {"setup_s": setup_s, "window_s": work["window_s"], "units": work["units"],
                     **({"unit_s": work["unit_s"]} if "unit_s" in work else {}),
                     **({"paths": work["paths"]} if "paths" in work else {})}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result, checks

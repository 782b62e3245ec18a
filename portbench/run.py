"""Run one cell of the benchmark of vamb_torch once, on this machine's cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are named in BENCHMARK.json at
the root of the checkout. Everything that belongs to one of them is a file
found by its name: `configs/<config>.json`, `traffic/<traffic>.json` (whose
"window" names `windows/<window>.py`), `limits/<workload>.json` (the limit
of each number the output check compares) and `metrics/<metric>.py` (a
reader that takes one metric from the window's counts and its trace). So a
cell, a mix, a configuration or a metric is added by adding files and
manifest entries.

A run makes its inputs from the seed, warms up (set-up, timed as
`setup_s` from process start), runs the window of whole units of work for
at least `--seconds`, reads the card's peak memory, frees the program's
state and then checks the window's outputs against the plain reference
under `reference/`. With `--trace 1` the window runs under a sampled device
trace and the run reports its per-layer metrics; else its end-to-end
metrics. The last line of standard output is the result as JSON; the last
lines of standard error are each compared number beside its limit.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# build and kernel caches at fixed paths inside the checkout, so a cell's
# first run in a checkout builds and the later ones find it built
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "vamb_tpu")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def with_held(bench: dict) -> dict:
    """`bench` with the cells held out of the benchmark added: each file
    `held/<workload>.json` holds the workload, configuration, end-to-end
    and per-layer entries that BENCHMARK.json would take for a cell not
    yet steady enough to bound (a configuration or metric it already has
    is kept; a metric gains the cell in its `workloads`). Readings and the
    tests drive such a cell; a benchmark run does not."""
    out = dict(bench)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] = [dict(x) for x in bench[key]]
    for f in sorted((HERE / "held").glob("*.json")):
        held = json.loads(f.read_text())
        out["workloads"] += held.get("workloads", [])
        names = {c["name"] for c in out["configs"]}
        out["configs"] += [dict(c) for c in held.get("configs", []) if c["name"] not in names]
        for key in ("end_to_end", "per_layer"):
            have = {m["name"]: m for m in out[key]}
            for m in held.get(key, []):
                if m["name"] not in have:
                    out[key].append(dict(m))
                elif "workloads" in have[m["name"]]:
                    have[m["name"]]["workloads"] = have[m["name"]]["workloads"] + m["workloads"]
    return out


def cell(bench: dict, workload: str) -> SimpleNamespace:
    """The workload's entry, configuration, traffic, limits and the
    metrics it reports, each resolved by name."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(entries)}")
    w = entries[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

    def reported(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return SimpleNamespace(
        workload=w, config=json.loads((ROOT / cfg_entry["file"]).read_text()), traffic=traffic,
        window_path=HERE / "windows" / f"{traffic['window']}.py",
        limits=json.loads((HERE / "limits" / f"{workload}.json").read_text()),
        end_to_end=reported(bench["end_to_end"]), per_layer=reported(bench["per_layer"]))


def reader(metric: str):
    from portbench.lib.harness import load_module

    return load_module(HERE / "metrics" / f"{metric}.py", "portbench_metric_" + metric.replace(".", "_"))


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def pin_one_cpu() -> None:
    """Bind this process, and the threads it starts, to one CPU: the fourth
    of those it may use (the last where it has fewer), away from CPU 0.
    The program's host side paces every cell, and on a host whose other
    cores carry other load, one fixed core spread the cells' rates less
    between runs than all CPUs but CPU 0 did (PERF.md)."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[min(3, len(cpus) - 1)]})


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    c = cell(manifest(), args.workload)
    pin_one_cpu()
    import torch

    chips = c.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    from portbench.lib import harness

    result, checks = harness.run(c, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                                 device=torch.device("cuda", 0), t0=_T0, reader=reader)
    gc.collect()
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures vamb_torch alone", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

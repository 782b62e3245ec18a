"""The readings that the output check's limits are set from, on the card,
at a cell's own size, in one process:

    python3 portbench/tests/readings.py --workload <name> --mode <mode> --seeds 11 12 13

`--mode` is `program` (the sound run), `control_bf16` (the program's own
bfloat16 path: distances for a clustering cell, training for a training
cell), `control_tf32` (training with TF32 matrix products) or
`fault_<name>` (a planted fault of the window module: `state_unchanged`,
`half_batch`, `answer_altered`). Each seed's set-up, one unit of the
window (a whole job, or a whole schedule unit) and the check run as in a
benchmark run; each line printed is a JSON object of the compared numbers
and the check's detail (a training cell's numbers by recorded stretch).
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import portbench.run as entry  # noqa: E402  (sets the caches' environment)
from portbench.lib.harness import load_module  # noqa: E402


def readings(workload: str, mode: str, seeds: list, device) -> list:
    import torch

    c = entry.cell(entry.with_held(entry.manifest()), workload)
    window = load_module(c.window_path, "portbench_window_" + c.traffic["window"])
    control = mode[len("control_"):] if mode.startswith("control_") else None
    fault = mode[len("fault_"):] if mode.startswith("fault_") else None
    out = []
    for seed in seeds:
        t = time.perf_counter()
        run = SimpleNamespace(config=c.config, traffic=c.traffic, seed=seed, device=device,
                              fault=fault, control=control)
        try:
            window.setup(run)
            work = window.window(run, 0.0, None)
            window.release(run)
            numbers, _ = window.check(run, work)
        except Exception as e:  # a control or fault that crashes gives no number
            numbers = {"error": f"{type(e).__name__}: {e}"}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        rec = {"workload": workload, "mode": mode, "seed": seed, "numbers": numbers,
               "detail": getattr(run, "check_detail", None), "seconds": time.perf_counter() - t}
        print(json.dumps(rec), flush=True)
        out.append(rec)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, args.mode, args.seeds, torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the manifest's cell with its traffic's counts and the training
schedule shortened, everything else as committed."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import portbench.run as entry  # noqa: E402

TINY_TRAFFIC = {"contigs": 3000, "genomes": 30, "warm_clusters": 5, "trace_every": 10,
                "trace_active": 2}


def cell(workload: str):
    c = entry.cell(entry.with_held(entry.manifest()), workload)
    c.traffic = dict(c.traffic, **{k: v for k, v in TINY_TRAFFIC.items() if k in c.traffic})
    if c.traffic["window"] == "schedule_units":
        c.config = dict(c.config, nepochs=3, batchsteps=[1, 2])
    return c


def run(workload: str, seed: int = 2**33 + 7, trace: bool = False, fault=None, control=None):
    """One run of the tiny cell on the CPU through the harness, the look
    for a card skipped. Returns (result, checks)."""
    import time

    import torch

    from portbench.lib import harness

    return harness.run(cell(workload), seed=seed, seconds=0.0, trace=trace,
                       device=torch.device("cpu"), t0=time.perf_counter(), reader=entry.reader,
                       fault=fault, control=control)

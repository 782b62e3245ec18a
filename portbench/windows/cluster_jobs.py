"""A window of whole clustering jobs.

A job is what `bin` does after training: a fresh
`vamb_torch.cluster.ClusterGenerator` on a fresh copy of the latent, built
as `pipeline.cluster_and_write_files` builds it (the published window,
successes and candidates, destroy=True, the run's seed), iterated to
exhaustion, then drained. Jobs run back to back until the window's seconds
have passed; the window closes at the end of that job. Every job of a run
clusters the same latent with the same seed, so each does the same work.

Set-up makes the latent from the seed, builds the kernels and runs the
first clusters of one job (`warm_clusters`), so the window's first job
finds every kernel loaded and the allocator warm.
"""

import itertools
import time

import numpy as np
import torch

from portbench.lib.inputs import planted_latent
from portbench.reference import cluster_check



def _generator(run, latent, distance_dtype=None):
    from vamb_torch.cluster import ClusterGenerator

    cfg = run.config
    return ClusterGenerator(
        latent.copy(), run.lengths,
        maxsteps=cfg["maxsteps"], windowsize=cfg["windowsize"], minsuccesses=cfg["minsuccesses"],
        destroy=True, normalized=False, rng_seed=run.seed, device=run.device,
        distance_dtype=distance_dtype or cfg["distance_dtype"], wander_kernel="auto",
        wander_scope=cfg["wander_scope"], mesh=None)


def _sync(run):
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)


def setup(run) -> None:
    tr = run.traffic
    run.latent, run.lengths = planted_latent(tr["contigs"], run.config["cluster_width"], tr,
                                             run.seed, run.device)
    if run.device.type == "cuda":
        from vamb_torch import kernels

        kernels.device_launches()  # builds the library where the checkout has none yet
    gen = _generator(run, run.latent)
    for _ in itertools.islice(gen, tr["warm_clusters"]):
        pass
    gen.drain()
    del gen
    run.jobs = []


def _job(run, tracer):
    """One whole job; returns its clusters [(medoid, members, radius or
    None)], its work counters and the engine paths it took (the ladder's
    widths, subset attempts, lanes admitted, loners emitted in bursts)."""
    # the control runs the program's own reduced-precision path
    gen = _generator(run, run.latent, "bfloat16" if run.control == "bf16" else None)
    clusters = []
    for c in gen:
        clusters.append((c.medoid, c.members, c.radius, c.kind_str))
        if tracer is not None:
            tracer.step()
    gen.drain()
    paths = {"widths": [gen.compactions[0][1]] + [c[2] for c in gen.compactions]
             if gen.compactions else [gen.n_pad],
             "subset_attempts": gen.subset_counts["attempts"],
             "lanes_admitted": gen.lane_counts["admitted"],
             "burst_loners": gen.lane_counts["burst_loners"]}
    return clusters, (gen.n_dists, gen.n_dists_effective, gen.emitted_total), paths


def window(run, seconds: float, tracer) -> dict:
    from vamb_torch import kernels

    kernels.reset_launch_counts()
    raw, eff, emitted, units = 0.0, 0.0, 0, 0
    unit_s = []
    with _faults(run):
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            clusters, (r, e, k), paths = _job(run, tracer)
            _sync(run)
            unit_s.append(time.perf_counter() - t)
            run.jobs.append(clusters)
            raw, eff, emitted, units = raw + r, eff + e, emitted + k, units + 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
    launches = {name: dict(getattr(kernels, name).launches_by_width)
                for name in ("row_sweep", "candidate_density_sweep", "gather_blocks",
                             "medoid_sweep", "spec_sweep", "row_stats", "gumbel_topc")}
    return {"window_s": window_s, "units": units, "unit_s": unit_s, "clusters": emitted,
            "n_dists": raw, "n_dists_effective": eff, "f": run.config["cluster_width"],
            "f_pad": -(-run.config["cluster_width"] // 8) * 8, "launches": launches,
            "paths": paths}


def release(run) -> None:
    "The program keeps no state between jobs; its outputs stay for the check."


def _same(a, b) -> bool:
    return len(a) == len(b) and all(
        x[0] == y[0] and x[2] == y[2] and np.array_equal(x[1], y[1]) for x, y in zip(a, b))


def check(run, work: dict):
    """The first job's clusters judged by the reference rule, and every
    later job the same as the first (one latent, one seed)."""
    first = run.jobs[0]
    got = cluster_check.check(run.latent, run.lengths, first, run.device)
    run.check_detail = got
    differing = sum(not _same(first, job) for job in run.jobs[1:])
    return {"misassigned_gap": got["misassigned_gap"], "radius_errors": got["radius_errors"],
            "partition_errors": got["partition_errors"], "jobs_differing": differing}, len(run.jobs)


class _faults:
    """The planted faults of the check's tests: `state_unchanged` (the pool
    keeps a cluster's members: only the counts that end the job move),
    `half_batch` (the members in the upper half of the columns are dropped)
    and `answer_altered` (one emitted cluster loses a member)."""

    def __init__(self, run):
        self.fault = run.fault

    def __enter__(self):
        if self.fault is None:
            return self
        from vamb_torch.cluster import ClusterGenerator

        self.saved = ClusterGenerator._commit
        commit = self.saved
        fault = self.fault

        def patched(gen, rec, rows):
            if fault == "state_unchanged":
                rec.members = gen._order[rows].astype(np.int64)
                gen.n_remaining = max(0, gen.n_remaining - len(rows))
                gen.n_emitted_clusters += 1
                gen._in_batch += 1
                gen._queue.append(rec)
                return
            if fault == "half_batch":
                low = rows[rows < gen.n_pad // 2]
                rows = low if len(low) else rows
            elif fault == "answer_altered" and gen.n_emitted_clusters == 0 and len(rows) > 1:
                commit(gen, rec, rows)
                rec.members = rec.members[1:]
                return
            commit(gen, rec, rows)

        ClusterGenerator._commit = patched
        return self

    def __exit__(self, *exc):
        if self.fault is not None:
            from vamb_torch.cluster import ClusterGenerator

            ClusterGenerator._commit = self.saved
        return False

"""train_mfu: the whole training step's share of the card's float32 peak,
in %: 6 x in x out operations a contig over the VAE's Linear layers
(forward and backward), times the contigs trained, over the wall time of
the untraced window that a traced run runs first (the end-to-end rate's
window), so the profiler's cost stays out."""

from portbench.lib.peaks import mfu_percent


def read(r):
    if r.trace is None:
        return None
    w = r.work
    return mfu_percent(w["contigs"] * w["flops_per_contig"], w["window_s"])

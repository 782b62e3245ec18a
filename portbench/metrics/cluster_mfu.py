"""cluster_mfu: the whole clustering step's share of the card's float32
peak, in %: the effective distance evaluations, 2 x F operations each (F
the latent's unpadded width), over the wall time of the untraced window
that a traced run runs first (the end-to-end rate's window), so the
profiler's cost stays out. It bounds any kernel's gain, also one that a
later change takes off the path."""

from portbench.lib.peaks import mfu_percent


def read(r):
    if r.trace is None:
        return None
    w = r.work
    return mfu_percent(w["n_dists_effective"] * 2 * w["f"], w["window_s"])

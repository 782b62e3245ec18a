"""cluster_eff_dists_per_s: the engine's effective distance evaluations
(`n_dists_effective`, those the reference's one-at-a-time sampler would
make) summed over the window's whole jobs, over the window's wall time."""


def read(r):
    if r.trace is not None:
        return None
    return r.work["n_dists_effective"] / r.work["window_s"]

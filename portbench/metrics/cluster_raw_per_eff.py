"""cluster_raw_per_eff: distance evaluations the engine made (`n_dists`)
per effective one (`n_dists_effective`): what its batching costs."""


def read(r):
    eff = r.work.get("n_dists_effective")
    return r.work["n_dists"] / eff if eff else None

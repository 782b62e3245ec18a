"""cluster_kernels_per_cluster: device kernels in the traced steps over
the clusters they emitted (a traced step is one emitted cluster)."""


def read(r):
    t = r.trace
    if t is None or not t["steps"] or not t["kernels"]:
        return None
    return t["kernels"] / t["steps"]

"""train_kernels_per_step: device kernels in the traced steps over the
optimizer steps they hold (a traced step is one optimizer step)."""


def read(r):
    t = r.trace
    if t is None or not t["steps"] or not t["kernels"]:
        return None
    return t["kernels"] / t["steps"]

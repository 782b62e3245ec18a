"""train_contigs_per_s: contigs trained over the window's whole schedule
units (each epoch's batches times its batch size), over its wall time."""


def read(r):
    if r.trace is not None:
        return None
    return r.work["contigs"] / r.work["window_s"]

"""cluster_kernel_roofline: the clustering engine's hand-written kernels'
share of their roofline, in %: over the traced steps, each kernel's
launches times the bound of its average launch in the window (from the
launch tallies by width and `lib/kernel_bounds.py`), summed, over those
kernels' device time in the trace."""

from portbench.lib import kernel_bounds


def read(r):
    t = r.trace
    if t is None:
        return None
    w = r.work
    bound = time = 0.0
    for name, (count, seconds) in t["ops"].items():
        family = kernel_bounds.family_of(name)
        if family is None:
            continue
        b = kernel_bounds.mean_bound_s(family, w["launches"].get(family, {}), w["f"], w["f_pad"])
        if b is None:
            continue
        bound += count * b
        time += seconds
    return 100.0 * bound / time if time else None

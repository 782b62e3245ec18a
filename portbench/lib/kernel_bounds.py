"""Operations and bytes of the clustering engine's hand-written kernels,
from shapes alone, and their least time on one H100 (`peaks.bound_s`).

Each entry gives the launch tally of the port's wrapper that counts the
kernel (`vamb_torch.kernels.<wrapper>.launches_by_width`, by the padded
width N of the matrix or of the step), the names of its `__global__`
functions as a device trace shows them, and its work a launch at width N,
for a latent F wide and stored F_pad wide (float32). Every input byte is
read once and every output byte written once. Where the work depends on
the data or on an argument the tallies do not record, the least that any
launch at that width needs is counted, so a share of the bound is never
overstated:

* `candidate_density_sweep` reads the features of kept columns only; the
  kept count is not tallied, so only the weights, the C candidates'
  features and their densities count.
* `spec_sweep` and `row_stats` take 1 to 8 rows; one is counted.
* `gather_ball` copies 1 to 64 blocks of 128 columns; one is counted.
* `gumbel_topc` hashes every column (75 int32 operations: threefry's 20
  rounds and its key injections, the unit float) and takes two logs and
  the score's adds (55 f32 operations), reading d, kept and tried (6 bytes).
"""

from .peaks import bound_s

_BLOCK = 128  # the subset wander's block of columns
_NBINS = 60
_C = 25  # candidates a wander step at the published maxsteps


def _row_sweep(f, f_pad, n):
    return bound_s(4 * (f_pad * n + n), 2 * f * n)


def _density(f, f_pad, n):
    return bound_s(4 * (n + _C * f_pad + _C), 0)


def _gather(f, f_pad, n):
    q = _BLOCK
    return bound_s(4 * (2 * f_pad * q + 1) + 22 * q, 0)


def _medoid_sweep(f, f_pad, n):
    return bound_s(4 * (f_pad * n + 2 * n + _NBINS + 2), 2 * f * n + n)


def _spec_sweep(f, f_pad, n):
    return bound_s(4 * (f_pad * n + 2 * n + _NBINS + 3), 2 * f * n + n)


def _row_stats(f, f_pad, n):
    return bound_s(4 * (2 * n + _NBINS + 3), n)


def _gumbel(f, f_pad, n):
    return bound_s(6 * n, 55 * n, 75 * n)


# wrapper whose tally counts the launches: (trace names, seconds a launch)
KERNELS = {
    "row_sweep": (("row_sweep_f32_kernel", "row_sweep_any_kernel"), _row_sweep),
    "candidate_density_sweep": (("candidate_density_kernel",), _density),
    "gather_blocks": (("gather_blocks_kernel",), _gather),
    "medoid_sweep": (("medoid_sweep_kernel",), _medoid_sweep),
    "spec_sweep": (("spec_sweep_kernel",), _spec_sweep),
    "row_stats": (("row_stats_kernel",), _row_stats),
    "gumbel_topc": (("gumbel_topc_kernel",), _gumbel),
}


def family_of(trace_name: str):
    "The wrapper whose kernel a device trace's kernel name is, or None."
    for wrapper, (names, _) in KERNELS.items():
        if any(name in trace_name for name in names):
            return wrapper
    return None


def mean_bound_s(wrapper: str, by_width: dict, f: int, f_pad: int):
    """The bound of the average launch of `wrapper` given its launches by
    width ({N: launches}), or None where it made none."""
    launches = sum(by_width.values())
    if not launches:
        return None
    fn = KERNELS[wrapper][1]
    return sum(k * fn(f, f_pad, n) for n, k in by_width.items()) / launches

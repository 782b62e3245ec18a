"""Hand-written CUDA kernels of the port (sources under `csrc/`)."""

from .cluster_kernels import (  # noqa: F401
    build,
    candidate_density_plain,
    candidate_density_sweep,
    reset_launch_counts,
    row_sweep,
    row_sweep_plain,
)

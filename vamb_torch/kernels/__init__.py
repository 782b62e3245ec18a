"""Hand-written CUDA kernels of the port (sources under `csrc/`)."""

from .cluster_kernels import (  # noqa: F401
    KERNELS,
    build,
    candidate_density_plain,
    candidate_density_sweep,
    gather_ball,
    gather_ball_plain,
    gather_blocks,
    gather_blocks_plain,
    medoid_sweep,
    medoid_sweep_plain,
    reset_launch_counts,
    row_sweep,
    row_sweep_plain,
)

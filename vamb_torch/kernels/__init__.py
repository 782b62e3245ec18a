"""Hand-written CUDA kernels of the port (sources under `csrc/`)."""

from .cluster_kernels import (  # noqa: F401
    KERNELS,
    build,
    candidate_density_plain,
    candidate_density_shard,
    candidate_density_shard_plain,
    candidate_density_sweep,
    device_launches,
    gather_ball,
    gather_ball_plain,
    gather_ball_shard,
    gather_ball_shard_plain,
    gather_blocks,
    gather_blocks_plain,
    gumbel_scores,
    gumbel_scores_plain,
    gumbel_topc,
    gumbel_topc_plain,
    gumbel_topc_shard,
    gumbel_topc_shard_plain,
    medoid_sweep,
    medoid_sweep_plain,
    medoid_sweep_shard,
    medoid_sweep_shard_plain,
    row_stats,
    row_stats_plain,
    row_sweep,
    row_sweep_plain,
    spec_sweep,
    spec_sweep_plain,
    spec_sweep_shard,
    spec_sweep_shard_plain,
    topc_launches,
    topc_merge,
)
from .cluster_kernels import reset_launch_counts as _reset_cluster_counts
from .hmm_kernels import build_hmm, hmm_forward, hmm_forward_plain  # noqa: F401


def reset_launch_counts() -> None:
    "Set every kernel's launch counter (and tally by width) to 0."
    _reset_cluster_counts()
    hmm_forward.launches = 0

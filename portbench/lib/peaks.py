"""The yardstick: one NVIDIA H100's published peaks and the least time a
piece of work could take on it.

Peaks are NVIDIA's data sheet for the H100 SXM part (dense rates, at the
700 W power limit): HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the
tensor cores, and int32 at 64 operations a clock on each of 132 SMs at the
1,980 MHz boost clock (the CUDA programming guide's throughput table,
compute capability 9.0). A share of these is stated beside the card's power
limit, which the harness records in every result.
"""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9


def bound_s(nbytes: float, flops: float, int_ops: float = 0.0) -> float:
    """Least seconds for the work: its bytes at the HBM rate or its float32
    operations (or int32 operations) at their peak, whichever is longer.
    Count each input byte read once and each output byte written once."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S, int_ops / INT32_OPS_PER_S)


def mfu_percent(flops: float, seconds: float) -> float:
    "A whole step's float32 operations over `seconds` as a share of the f32 peak, in %."
    return 100.0 * flops / seconds / F32_FLOPS_PER_S

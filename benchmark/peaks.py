"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): the roofline shares are read against them,
with the card's power limit beside each result."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12          # float32 outside the tensor cores


def bound_s(flops: float = 0.0, nbytes: float = 0.0) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory bandwidth."""
    return max(flops / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)


def share_pct(bound: float, device_s: float) -> float:
    return 100.0 * bound / device_s

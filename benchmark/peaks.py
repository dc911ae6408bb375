"""The table of peaks that roofline shares are taken against.

NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense rates without sparsity,
at the full 700 W): HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 and 34
TFLOP/s in float64 outside the tensor cores (the port's kernels use none).
"""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {4: 67e12, 8: 34e12}  # by item size in bytes


def bound_s(nbytes: float, flops: float, item: int) -> float:
    """The least time the card could take: bytes at the HBM rate or flops
    at the vector rate, the larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S[item])


def roofline_percent(trace, kernels, cost, item: int):
    """The share of their bound that the traced launches of `kernels`
    reach, in percent: each event's bound, from `cost` = (bytes, flops) of
    one product, over the events' summed device time.  None where the
    trace holds no such launch."""
    if trace is None:
        return None
    events, us = trace.device_time(kernels)
    if not events or us <= 0:
        return None
    return 100.0 * events * bound_s(*cost, item) / (us / 1e6)

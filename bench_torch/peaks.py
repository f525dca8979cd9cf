"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the
700 W power limit): the yardstick of every roofline and MFU share. The
port runs true float32 (TF32 off), so operations count at the float32
rate outside the tensor cores."""

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the float32 operations over their peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)

"""The card's data-sheet peaks (NVIDIA H100 SXM, dense, at its 700 W
limit): the denominators of every roofline and MFU share. The
configurations run float32 with TF32 off, outside the tensor cores."""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time of a call: the larger of its operations at the fp32
    peak and its bytes at the HBM rate."""
    return max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A card set below
that limit runs slower under load; the run prints its limit beside every
share of these peaks."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# the peak of the arithmetic a configuration's compute dtype runs on
FLOPS_BY_DTYPE = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the dtype's peak and the bytes over the memory's bandwidth."""
    return max(flops / FLOPS_BY_DTYPE[dtype], nbytes / HBM_BYTES_PER_S)

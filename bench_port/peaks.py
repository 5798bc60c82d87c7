"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, 700 W): the denominators of every roofline share."""

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
DTYPE_BYTES = {"float32": 4, "float64": 8, "bfloat16": 2}


def bound_seconds(n_bytes: float, n_flops: float, dtype: str) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM bandwidth and the operations over the dtype's peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / FLOPS_PER_S[dtype])

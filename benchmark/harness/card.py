"""The card's published peaks, which every family's counts and the
per-layer readers measure against: one NVIDIA H100 SXM (NVIDIA's data
sheet, dense rates, at its 700 W power limit)."""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ELEM_BYTES = {"bfloat16": 2, "float32": 4}       # of the dtypes above


def bound_seconds(ops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(ops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)

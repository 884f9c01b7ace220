"""The numbers that decide ``correct``: gaps between the answers of the
timed path and the plain reference's, in logits, and the timed path's
narrow operations.

- ``gap_q50``: the median of |gap - mean gap| over the answers compared,
  the part of the gap that differs from answer to answer. The reference
  computed in fp8 reads it several times higher than the program in
  bf16; the mean is left out because bf16's rounding of the weights
  shifts a random-weight model's scores alike on some seeds.
- ``gap_max``: the widest |gap|, which one wrong answer sets.
- ``low_precision_ops``: the operations on int8, sub-byte or float8
  tensors in a sampled dispatch of the timed path (``census.py``); the
  program's own int8 path, which no gap of the answers tells from bf16,
  reads hundreds, and a bf16 run 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def gap_numbers(got, want) -> Dict[str, float]:
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or got.size == 0:
        raise ValueError(f"answers {got.shape} against reference "
                         f"{want.shape}")
    g = got - want
    if not np.all(np.isfinite(g)):
        return {"gap_q50": float("inf"), "gap_max": float("inf")}
    return {"gap_q50": float(np.median(np.abs(g - g.mean()))),
            "gap_max": float(np.abs(g).max())}


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, Tuple[float, float]]:
    """{name: (value, limit)} for every limit the cell sets."""
    return {k: (numbers[k], float(limits[k])) for k in limits}

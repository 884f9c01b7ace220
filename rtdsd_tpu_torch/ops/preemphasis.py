"""Batched pre-emphasis: the port of ``rtdsd_tpu/ops/preemphasis.py``.

``y[t] = x[t] - alpha * x[t - 1]`` with a one-sample reflect pad, so
``y[0] = x[0] - alpha * x[1]``, as the reference's reflect pad plus a
``[-alpha, 1]`` conv1d under ``no_grad``. Applied by the train and eval
steps only; the scoring path never applies it.
"""

from __future__ import annotations

import torch


def pre_emphasis(x: torch.Tensor, alpha: float = 0.97) -> torch.Tensor:
    """x: (..., T) -> (..., T), detached (a fixed preprocessing step)."""
    with torch.no_grad():
        # x - alpha * prev rounded once, as a fused multiply-add gives it
        # (XLA's): the product of two float32 values is exact in float64
        prev = torch.cat([x[..., 1:2], x[..., :-1]], dim=-1).double()
        a = float(torch.tensor(alpha, dtype=torch.float32))
        return (x.double() - a * prev).to(x.dtype)

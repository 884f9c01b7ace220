"""Scoring step: the port of ``rtdsd_tpu/engine/steps.py::make_score_step``."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def make_score_step(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """Waves (B, T) on the model's device -> the raw bonafide logit (B,),
    with NO pre-emphasis, as the reference's score files are made."""

    def step(waves: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(waves)[:, 1]

    return step

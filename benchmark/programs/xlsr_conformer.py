"""The program's XLSR-Conformer family (``XLSR_Conformer``,
``My_XLSR_Conformer``): the encoder's keyword arguments and parts as in
``xlsr_aasist.py``, and the Conformer head's sizes from the file's
``backend``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from benchmark.programs import xlsr_aasist
from benchmark.programs.xlsr_aasist import (census_modules, encoder_depth,
                                            kernels, serving_engine)

__all__ = ["census_modules", "encoder_depth", "kernels", "program_kwargs",
           "serving_engine", "stages"]


def program_kwargs(cfg: dict, w8a8: bool = False) -> dict:
    """The encoder's keyword arguments, and the head's ``emb_size``,
    ``heads``, ``kernel_size`` and ``n_encoders``."""
    kwargs = xlsr_aasist.program_kwargs(cfg, w8a8)
    be = cfg["backend"]
    kwargs.update({k: be[k] for k in ("emb_size", "heads", "kernel_size",
                                      "n_encoders")})
    return kwargs


def stages(model: torch.nn.Module) -> Tuple[Callable, Callable, Callable]:
    """(front-end, encoder, head), each alone, as ``xlsr_aasist.stages``."""
    from rtdsd_tpu_torch.models.conformer import ConformerBackend

    frontend, encoder, _ = xlsr_aasist.stages(model)
    return (frontend, encoder,
            lambda feats: ConformerBackend.forward(model, feats))

"""Model registry: the port of ``rtdsd_tpu/models/registry.py``, with the
same names and the same free-form ``kwargs`` (``num_layers``, ``order``,
``custom_order``, ``fix_out_s1_bug``, ``fused_gat``, ``w2v``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
from torch import nn

from rtdsd_tpu_torch.models.wav2vec2 import make_w2v_cfg, resolve_layer_indices
from rtdsd_tpu_torch.models.zoo import XLSR_AASIST


@dataclasses.dataclass
class ModelSpec:
    name: str
    module: nn.Module
    layer_indices: List[int]         # which of the 24 XLSR layers it uses


_REGISTRY: Dict[str, Callable[..., ModelSpec]] = {}
_NOT_PORTED = ("Model", "ConformerModel", "XLSR_Conformer", "MyModel",
               "My_XLSR_Conformer")


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def list_models() -> List[str]:
    return sorted(_REGISTRY)


def get_model(name: str, dtype: torch.dtype = torch.float32,
              **kwargs) -> ModelSpec:
    if name in _NOT_PORTED:
        raise NotImplementedError(f"model {name!r} is not yet ported")
    if name not in _REGISTRY:
        raise ValueError(f"Model {name!r} not registered; have {list_models()}")
    return _REGISTRY[name](dtype=dtype, **kwargs)


def _xlsr_aasist(n_layers: int, dtype, kwargs) -> XLSR_AASIST:
    return XLSR_AASIST(w2v_cfg=make_w2v_cfg(n_layers, **kwargs.get("w2v", {})),
                       fix_out_s1_bug=bool(kwargs.get("fix_out_s1_bug", False)),
                       fused_gat=bool(kwargs.get("fused_gat", False)),
                       dtype=dtype)


@register_model("XLSR_AASIST")
def _full(dtype=torch.float32, **kwargs) -> ModelSpec:
    return ModelSpec("XLSR_AASIST", _xlsr_aasist(24, dtype, kwargs),
                     list(range(24)))


@register_model("My_XLSR_AASIST")
def _pruned(dtype=torch.float32, **kwargs) -> ModelSpec:
    indices = resolve_layer_indices(24, int(kwargs.get("num_layers", 24)),
                                    kwargs.get("order", "first"),
                                    kwargs.get("custom_order", None))
    return ModelSpec("My_XLSR_AASIST",
                     _xlsr_aasist(len(indices), dtype, kwargs), indices)

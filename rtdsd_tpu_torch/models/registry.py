"""Model registry: the port of ``rtdsd_tpu/models/registry.py``, with the
same names and the same free-form ``kwargs`` (``num_layers``, ``order``,
``custom_order``, ``fix_out_s1_bug``, ``fused_gat``, ``w2v``, and for the
Conformer family ``emb_size``, ``heads``, ``kernel_size``,
``n_encoders``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import torch
from torch import nn

from rtdsd_tpu_torch.models.wav2vec2 import make_w2v_cfg, resolve_layer_indices
from rtdsd_tpu_torch.models.zoo import XLSR_AASIST, XLSR_Conformer


@dataclasses.dataclass
class ModelSpec:
    name: str
    module: nn.Module
    layer_indices: List[int]         # which of the 24 XLSR layers it uses


_REGISTRY: Dict[str, Callable[..., ModelSpec]] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def list_models() -> List[str]:
    return sorted(_REGISTRY)


def get_model(name: str, dtype: torch.dtype = torch.float32,
              **kwargs) -> ModelSpec:
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


def _layer_indices(kwargs) -> List[int]:
    return resolve_layer_indices(24, int(kwargs.get("num_layers", 24)),
                                 kwargs.get("order", "first"),
                                 kwargs.get("custom_order", None))


@register_model("My_XLSR_AASIST")
def _pruned(dtype=torch.float32, **kwargs) -> ModelSpec:
    indices = _layer_indices(kwargs)
    return ModelSpec("My_XLSR_AASIST",
                     _xlsr_aasist(len(indices), dtype, kwargs), indices)


def _conformer(name: str, indices: List[int], dtype, kwargs) -> ModelSpec:
    module = XLSR_Conformer(
        w2v_cfg=make_w2v_cfg(len(indices), **kwargs.get("w2v", {})),
        emb_size=int(kwargs.get("emb_size", 144)),
        heads=int(kwargs.get("heads", 4)),
        kernel_size=int(kwargs.get("kernel_size", 31)),
        n_encoders=int(kwargs.get("n_encoders", 4)), dtype=dtype)
    return ModelSpec(name, module, indices)


# The reference names the Conformer teacher "Model"; configs also call it
# ConformerModel. All three names build the 24-layer model.
@register_model("Model")
@register_model("ConformerModel")
@register_model("XLSR_Conformer")
def _conformer_full(dtype=torch.float32, **kwargs) -> ModelSpec:
    return _conformer("XLSR_Conformer", list(range(24)), dtype, kwargs)


@register_model("MyModel")
@register_model("My_XLSR_Conformer")
def _conformer_pruned(dtype=torch.float32, **kwargs) -> ModelSpec:
    return _conformer("My_XLSR_Conformer", _layer_indices(kwargs), dtype,
                      kwargs)

"""Model registry: the port of ``rtdsd_tpu/models/registry.py``, with the
same names and the same free-form ``kwargs`` (``num_layers``, ``order``,
``custom_order``, ``fix_out_s1_bug``, ``fused_gat``, ``w2v``,
``partial_freeze_layers``, ``partial_freeze_init_layers``, and for the
Conformer family ``emb_size``, ``heads``, ``kernel_size``,
``n_encoders``). ``remat=True`` builds the encoder to recompute its layers
in the backward pass, as the JAX package does for training."""

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
    # Parameter-name substrings frozen in training (left out of the
    # optimizer), their exceptions, and those Xavier-re-initialised after
    # the SSL checkpoint load; the reference's torch names, as in JAX
    freeze_patterns: List[str] = dataclasses.field(default_factory=list)
    reinit_patterns: List[str] = dataclasses.field(default_factory=list)
    unfreeze_patterns: List[str] = dataclasses.field(default_factory=list)


_REGISTRY: Dict[str, Callable[..., ModelSpec]] = {}


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def list_models() -> List[str]:
    return sorted(_REGISTRY)


def get_model(name: str, dtype: torch.dtype = torch.float32,
              remat: bool = False, **kwargs) -> ModelSpec:
    if name not in _REGISTRY:
        raise ValueError(f"Model {name!r} not registered; have {list_models()}")
    return _REGISTRY[name](dtype=dtype, remat=remat, **kwargs)


def _xlsr_aasist(n_layers: int, dtype, remat, kwargs) -> XLSR_AASIST:
    return XLSR_AASIST(w2v_cfg=make_w2v_cfg(n_layers, **kwargs.get("w2v", {})),
                       fix_out_s1_bug=bool(kwargs.get("fix_out_s1_bug", False)),
                       fused_gat=bool(kwargs.get("fused_gat", False)),
                       dtype=dtype, remat=remat)


def _freeze_spec(kwargs):
    """(freeze, reinit, unfreeze) from the reference schema:
    ``partial_freeze_layers: {target_layers, non_target_layers}``; the
    non-target layers stay trainable and are re-initialised, and
    ``partial_freeze_init_layers`` adds re-inits."""
    pf = kwargs.get("partial_freeze_layers") or {}
    freeze = list(pf.get("target_layers", []))
    non_target = list(pf.get("non_target_layers", []))
    reinit = list(kwargs.get("partial_freeze_init_layers", [])) + non_target
    return freeze, reinit, non_target


@register_model("XLSR_AASIST")
def _full(dtype=torch.float32, remat=False, **kwargs) -> ModelSpec:
    return ModelSpec("XLSR_AASIST", _xlsr_aasist(24, dtype, remat, kwargs),
                     list(range(24)), *_freeze_spec(kwargs))


def _layer_indices(kwargs) -> List[int]:
    return resolve_layer_indices(24, int(kwargs.get("num_layers", 24)),
                                 kwargs.get("order", "first"),
                                 kwargs.get("custom_order", None))


@register_model("My_XLSR_AASIST")
def _pruned(dtype=torch.float32, remat=False, **kwargs) -> ModelSpec:
    indices = _layer_indices(kwargs)
    return ModelSpec("My_XLSR_AASIST",
                     _xlsr_aasist(len(indices), dtype, remat, kwargs), indices)


def _conformer(name: str, indices: List[int], dtype, remat, kwargs
               ) -> ModelSpec:
    module = XLSR_Conformer(
        w2v_cfg=make_w2v_cfg(len(indices), **kwargs.get("w2v", {})),
        emb_size=int(kwargs.get("emb_size", 144)),
        heads=int(kwargs.get("heads", 4)),
        kernel_size=int(kwargs.get("kernel_size", 31)),
        n_encoders=int(kwargs.get("n_encoders", 4)), dtype=dtype, remat=remat)
    return ModelSpec(name, module, indices)


# The reference names the Conformer teacher "Model"; configs also call it
# ConformerModel. All three names build the 24-layer model.
@register_model("Model")
@register_model("ConformerModel")
@register_model("XLSR_Conformer")
def _conformer_full(dtype=torch.float32, remat=False, **kwargs) -> ModelSpec:
    return _conformer("XLSR_Conformer", list(range(24)), dtype, remat, kwargs)


@register_model("MyModel")
@register_model("My_XLSR_Conformer")
def _conformer_pruned(dtype=torch.float32, remat=False, **kwargs) -> ModelSpec:
    return _conformer("My_XLSR_Conformer", _layer_indices(kwargs), dtype,
                      remat, kwargs)

"""Hugging Face ``transformers`` wav2vec2 snapshots -> the port's encoder:
the port's copy of ``rtdsd_tpu/models/convert_hf.py``.

HF's ``Wav2Vec2Model`` is a module-for-module port of fairseq's; only the
parameter names differ. :func:`hf_to_fairseq_names` renames HF to fairseq
spelling and :func:`convert_hf_checkpoint` hands the result to the port's
fairseq conversion (``convert_fairseq.encoder_state_dict``), so one set of
weight-norm and head-dropping rules is kept. The post-LN wav2vec2 *base*
family is rejected (:func:`w2v_config_from_hf`): the encoder is the pre-LN
XLS-R / large one.

:func:`load_hf_dir` reads a local snapshot directory: ``config.json`` and
``model.safetensors`` (read here: an 8-byte little-endian header length, a
JSON header, raw little-endian tensors) or ``pytorch_model.bin``
(``torch.load(weights_only=True)``).
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from rtdsd_tpu_torch.models.convert import StateDict
from rtdsd_tpu_torch.models.convert_fairseq import encoder_state_dict
from rtdsd_tpu_torch.models.wav2vec2 import Wav2Vec2Config

# HF module path -> fairseq module path (applied in order, the first match
# wins); ":group" marks a rule for the group-norm extractor only
_RENAMES = [
    (r"^feature_extractor\.conv_layers\.(\d+)\.conv\.(weight|bias)$",
     r"feature_extractor.conv_layers.\1.0.\2"),
    (r"^feature_extractor\.conv_layers\.0\.layer_norm\.(weight|bias)$:group",
     r"feature_extractor.conv_layers.0.2.\1"),
    (r"^feature_extractor\.conv_layers\.(\d+)\.layer_norm\.(weight|bias)$",
     r"feature_extractor.conv_layers.\1.2.1.\2"),
    (r"^feature_projection\.layer_norm\.(weight|bias)$", r"layer_norm.\1"),
    (r"^feature_projection\.projection\.(weight|bias)$",
     r"post_extract_proj.\1"),
    (r"^encoder\.pos_conv_embed\.conv\.(bias|weight|weight_g|weight_v)$",
     r"encoder.pos_conv.0.\1"),
    (r"^encoder\.pos_conv_embed\.conv\.parametrizations\.weight"
     r"\.(original0|original1)$",
     r"encoder.pos_conv.0.parametrizations.weight.\1"),
    (r"^encoder\.layers\.(\d+)\.attention\.(q|k|v|out)_proj\.(weight|bias)$",
     r"encoder.layers.\1.self_attn.\2_proj.\3"),
    (r"^encoder\.layers\.(\d+)\.layer_norm\.(weight|bias)$",
     r"encoder.layers.\1.self_attn_layer_norm.\2"),
    (r"^encoder\.layers\.(\d+)\.feed_forward\.intermediate_dense"
     r"\.(weight|bias)$", r"encoder.layers.\1.fc1.\2"),
    (r"^encoder\.layers\.(\d+)\.feed_forward\.output_dense\.(weight|bias)$",
     r"encoder.layers.\1.fc2.\2"),
    (r"^encoder\.layers\.(\d+)\.final_layer_norm\.(weight|bias)$",
     r"encoder.layers.\1.final_layer_norm.\2"),
    (r"^encoder\.layer_norm\.(weight|bias)$", r"encoder.layer_norm.\1"),
]

# pre-training and task heads, adapters: no role in the encoder
_DROP = re.compile(
    r"^(masked_spec_embed|quantizer\.|project_q\.|project_hid\.|adapter\."
    r"|lm_head\.|classifier\.|projector\.)")

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def hf_to_fairseq_names(sd: Mapping[str, torch.Tensor],
                        feat_extract_norm: str = "layer") -> StateDict:
    """An HF wav2vec2 state dict in fairseq spelling. ``feat_extract_norm``
    ("layer" for XLS-R, "group" for the base models) tells HF's two
    ``layer_norm`` spellings apart. A known head key is skipped; an
    unknown key raises."""
    out: StateDict = {}
    for key, val in sd.items():
        k = key[len("wav2vec2."):] if key.startswith("wav2vec2.") else key
        if _DROP.match(k):
            continue
        for pat, repl in _RENAMES:
            pat, _, tag = pat.partition(":")
            if tag == "group" and feat_extract_norm != "group":
                continue
            new, n = re.subn(pat, repl, k)
            if n:
                out[new] = val
                break
        else:
            raise ValueError(f"unrecognized HF wav2vec2 key: {key!r}")
    return out


def w2v_config_from_hf(hf_cfg: Mapping[str, Any], **overrides
                       ) -> Wav2Vec2Config:
    """The encoder config of an HF ``config.json`` (``do_stable_layer_norm``
    is ``layer_norm_first``; ``feat_extract_norm`` "layer" / "group" is the
    extractor mode). A post-LN checkpoint raises."""
    if not hf_cfg.get("do_stable_layer_norm", False):
        raise ValueError(
            "post-LN wav2vec2 (do_stable_layer_norm=false, the 'base' "
            "family) is not supported — the framework implements the "
            "pre-LN XLS-R/large encoder")
    conv_layers = tuple(zip(hf_cfg["conv_dim"], hf_cfg["conv_kernel"],
                            hf_cfg["conv_stride"]))
    norm = {"layer": "layer_norm", "group": "group_norm"}[
        hf_cfg.get("feat_extract_norm", "layer")]
    kw: Dict[str, Any] = dict(
        conv_layers=conv_layers,
        extractor_mode=norm,
        conv_bias=bool(hf_cfg.get("conv_bias", False)),
        encoder_embed_dim=hf_cfg["hidden_size"],
        encoder_ffn_dim=hf_cfg["intermediate_size"],
        encoder_heads=hf_cfg["num_attention_heads"],
        encoder_layers=hf_cfg["num_hidden_layers"],
        conv_pos=hf_cfg.get("num_conv_pos_embeddings", 128),
        conv_pos_groups=hf_cfg.get("num_conv_pos_embedding_groups", 16),
        layer_norm_first=bool(hf_cfg.get("do_stable_layer_norm", False)),
    )
    kw.update(overrides)
    return Wav2Vec2Config(**kw)


def read_safetensors(path: str) -> StateDict:
    """Every tensor of a ``.safetensors`` file, as CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: StateDict = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which the reader lacks")
        a, b = info["data_offsets"]
        raw = np.frombuffer(data, np.uint8, b - a, a).copy()
        out[name] = torch.from_numpy(raw).view(dtype).reshape(info["shape"])
    return out


def load_hf_dir(path: str) -> Tuple[StateDict, Dict[str, Any]]:
    """A local HF snapshot directory -> (state dict, config dict)."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    st_path = os.path.join(path, "model.safetensors")
    pt_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st_path):
        sd = read_safetensors(st_path)
    elif os.path.exists(pt_path):
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(
            f"no model.safetensors / pytorch_model.bin under {path}")
    return sd, cfg


def convert_hf_checkpoint(sd: Mapping[str, torch.Tensor],
                          hf_cfg: Optional[Mapping[str, Any]] = None
                          ) -> Tuple[StateDict, Optional[Wav2Vec2Config]]:
    """An HF wav2vec2 state dict (and its config) -> (the encoder's state
    dict, its config; ``None`` without ``hf_cfg``)."""
    norm = (hf_cfg or {}).get("feat_extract_norm", "layer")
    fs_sd = hf_to_fairseq_names(sd, feat_extract_norm=norm)
    cfg = w2v_config_from_hf(hf_cfg) if hf_cfg is not None else None
    return encoder_state_dict(fs_sd), cfg

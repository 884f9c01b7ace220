"""The system under test, built from a configuration file.

The program is the PyTorch and CUDA port, ``rtdsd_tpu_torch``; this module
is the only place where the harness builds its models. A configuration
file's ``program`` block names the registered model, its ``kwargs`` and
the compute dtype; the widths come from the file's own keys, so the
reference and the program read the same sizes. ``w8a8`` switches on the
program's own int8 path, the control of the comparison.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def w2v_overrides(cfg: dict) -> dict:
    """The program's ``w2v`` keys for the widths a configuration file
    states (HF names -> the port's fairseq-style names)."""
    return {
        "encoder_embed_dim": cfg["hidden_size"],
        "encoder_ffn_dim": cfg["intermediate_size"],
        "encoder_heads": cfg["num_attention_heads"],
        "conv_layers": [[c, k, s] for c, k, s in zip(
            cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"])],
        "conv_pos": cfg["num_conv_pos_embeddings"],
        "conv_pos_groups": cfg["num_conv_pos_embedding_groups"],
    }


def program_kwargs(cfg: dict) -> dict:
    kwargs = json.loads(json.dumps(cfg["program"].get("kwargs", {})))
    kwargs["w2v"] = {**w2v_overrides(cfg), **kwargs.get("w2v", {})}
    return kwargs


def build_model(cfg: dict, weights: Dict[str, torch.Tensor],
                device: torch.device, w8a8: bool = False) -> torch.nn.Module:
    """The configured model on ``device`` in eval mode, its parameters and
    buffers loaded from ``weights`` with ``strict=True``; with ``w8a8``,
    then rebuilt with int8 transformer matmuls and int8 activations and
    filled with those weights quantized, as the program's scoring CLI does
    under ``--w8a8``."""
    from rtdsd_tpu_torch.models.registry import get_model

    prog = cfg["program"]
    dt = DTYPES[prog["compute_dtype"]]
    kwargs = program_kwargs(cfg)
    with torch.device(device):
        model = get_model(prog["model"], dtype=dt, **kwargs).module.eval()
    depth = len(model.ssl_model.model.encoder.layers)
    if depth != cfg["num_hidden_layers"]:
        raise ValueError(f"{prog['model']} with these kwargs has {depth} "
                         f"layers; the configuration states "
                         f"{cfg['num_hidden_layers']}")
    model.load_state_dict(weights, strict=True)
    if w8a8:
        from rtdsd_tpu_torch.models.quantize import quantize_state_dict

        kwargs["w2v"].update(w8=True, a8=True)
        with torch.device(device):
            q = get_model(prog["model"], dtype=dt, **kwargs).module.eval()
        q.load_state_dict(quantize_state_dict(model.state_dict()),
                          strict=True)
        model = q
    return model


"""The program's XLSR-AASIST family (``XLSR_AASIST``, ``My_XLSR_AASIST``):
its registry keyword arguments from a configuration file, and the parts
of a built model the harness calls on their own.

The program is imported inside the functions, so that finding the family
loads nothing of it.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Tuple

import torch


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


def program_kwargs(cfg: dict, w8a8: bool = False) -> dict:
    """The registry's keyword arguments: the file's ``program.kwargs`` with
    the widths it states; with ``w8a8``, int8 transformer matmuls and int8
    activations, as the scoring CLI's ``--w8a8``."""
    kwargs = json.loads(json.dumps(cfg["program"].get("kwargs", {})))
    kwargs["w2v"] = {**w2v_overrides(cfg), **kwargs.get("w2v", {})}
    if w8a8:
        kwargs["w2v"].update(w8=True, a8=True)
    return kwargs


def encoder_depth(model: torch.nn.Module) -> int:
    return len(model.ssl_model.model.encoder.layers)


def stages(model: torch.nn.Module) -> Tuple[Callable, Callable, Callable]:
    """(front-end, encoder, back-end), each alone: waves (B, samples) ->
    conv features, conv features -> encoder output, encoder output ->
    logits (B, 2)."""
    from rtdsd_tpu_torch.models.aasist import AASISTBackend

    enc = model.ssl_model.model
    return (enc.feature_extractor,
            lambda conv: enc(None, conv_feats=conv),
            lambda feats: AASISTBackend.forward(model, feats))


def census_modules(model: torch.nn.Module) -> List[torch.nn.Module]:
    """The model, and the part the timed path also calls on its own (the
    serving engine's extend runs the front-end)."""
    return [model, model.ssl_model.model.feature_extractor]


def serving_engine(model: torch.nn.Module, **kwargs):
    """The program's multi-stream engine over ``model``."""
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer

    return MultiStreamScorer(model, model.w2v_cfg, **kwargs)


def kernels() -> Dict[str, Tuple[str, int]]:
    """The family's one list of hand-written kernels whose rooflines the
    harness reads: {kernel: (the name its device operations carry in a
    trace, its launches so far)}. ``counts.kernels`` gives each one's
    operations and bytes a launch under the same names."""
    from rtdsd_tpu_torch.ops.attention import mha_small_t

    return {"mha_small_t": ("mha_small_t", mha_small_t.launches)}

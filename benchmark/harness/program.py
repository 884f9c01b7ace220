"""The system under test, built from a configuration file.

The program is the PyTorch and CUDA port, ``rtdsd_tpu_torch``; this module
is the only place where the harness builds its models. A configuration
file's ``program`` block names the registered model, its ``kwargs`` and
the compute dtype; the widths come from the file's own keys, which the
family's adapter (``benchmark/programs/<family>.py``) turns into the
registry's keyword arguments, so the reference and the program read the
same sizes. ``w8a8`` switches on the program's own int8 path, the control
of the comparison.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness.runner import family

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(cfg: dict, weights: Dict[str, torch.Tensor],
                device: torch.device, w8a8: bool = False) -> torch.nn.Module:
    """The configured model on ``device`` in eval mode, its parameters and
    buffers loaded from ``weights`` with ``strict=True``; with ``w8a8``,
    then rebuilt with int8 transformer matmuls and int8 activations and
    filled with those weights quantized, as the program's scoring CLI does
    under ``--w8a8``."""
    from rtdsd_tpu_torch.models.registry import get_model

    adapter = family(cfg).program
    prog = cfg["program"]
    dt = DTYPES[prog["compute_dtype"]]
    with torch.device(device):
        model = get_model(prog["model"], dtype=dt,
                          **adapter.program_kwargs(cfg)).module.eval()
    depth = adapter.encoder_depth(model)
    if depth != cfg["num_hidden_layers"]:
        raise ValueError(f"{prog['model']} with these kwargs has {depth} "
                         f"layers; the configuration states "
                         f"{cfg['num_hidden_layers']}")
    model.load_state_dict(weights, strict=True)
    if w8a8:
        from rtdsd_tpu_torch.models.quantize import quantize_state_dict

        with torch.device(device):
            q = get_model(prog["model"], dtype=dt,
                          **adapter.program_kwargs(cfg, w8a8=True)
                          ).module.eval()
        q.load_state_dict(quantize_state_dict(model.state_dict()),
                          strict=True)
        model = q
    return model

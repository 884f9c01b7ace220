"""Weight-only int8 (w8) conversion of the XLSR transformer stack: the port
of ``rtdsd_tpu/models/quantize.py``.

:func:`quantize_state_dict` rewrites a float state dict of the port (as a
loaded model's ``state_dict()`` gives it) for a ``w8=True`` model: the six
transformer matmuls (q/k/v/out_proj, fc1, fc2 of every layer) lose their
``weight`` (out, in) and gain int8 ``vals`` (in, out) and float32
``scales`` (1, out) from :func:`rtdsd_tpu_torch.ops.quant.quantize_int8`,
the buffers of ``W8Linear`` / ``W8A8Linear``; every other entry passes
through. Quantization runs on the device the weights lie on: the CUDA
kernel with stochastic rounding on the card, round-to-nearest on the CPU,
as the JAX package does on and off the TPU.

Each matrix gets its own seed, ``seed + 7919 n`` for the n-th matrix taken
in the JAX package's order: every layer of ``q_proj``, then of ``k_proj``,
``v_proj``, ``out_proj``, ``fc1`` and ``fc2``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from rtdsd_tpu_torch.ops.quant import quantize_int8

W8_LEAVES = ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
             "self_attn.out_proj", "fc1", "fc2")
_MATMUL = re.compile(r"^(?P<prefix>(.*\.)?layers\.)(?P<layer>\d+)\."
                     r"(?P<leaf>" + "|".join(map(re.escape, W8_LEAVES)) +
                     r")\.weight$")


def matmul_keys(sd: Mapping[str, torch.Tensor]) -> list:
    """The transformer matmul weights of ``sd``, in the JAX order."""
    found = []
    for key in sd:
        m = _MATMUL.match(key)
        if m:
            found.append((m["prefix"], W8_LEAVES.index(m["leaf"]),
                          int(m["layer"]), key))
    return [key for *_, key in sorted(found)]


def quantize_state_dict(sd: Mapping[str, torch.Tensor], seed: int = 0
                        ) -> Dict[str, torch.Tensor]:
    """Float state dict -> w8 state dict (see the module docstring)."""
    keys = matmul_keys(sd)
    if not keys:
        raise ValueError(
            "quantize_state_dict found no transformer matmul weights; is "
            "this a w2v state dict (expected ...layers.{i}.{self_attn."
            "q_proj,...,fc2}.weight)?")
    out = dict(sd)
    for n, key in enumerate(keys, start=1):
        vals, scales = quantize_int8(out.pop(key).t(), seed=seed + 7919 * n)
        base = key[:-len("weight")]
        out[base + "vals"], out[base + "scales"] = vals, scales
    return out


def w8_bytes_saved(sd: Mapping[str, torch.Tensor]) -> int:
    """Bytes of weight traffic removed per forward against bf16 storage:
    one per element of every float transformer matmul weight."""
    return sum(sd[key].numel() for key in matmul_keys(sd))

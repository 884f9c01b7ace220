"""Checkpoint conversion CLI of the port, with the modes of
``rtdsd_tpu.cli.convert``; each writes ``{out}/weights.msgpack`` in flax's
msgpack format, which the JAX package reads as it reads its own:

    # fairseq XLS-R pre-training checkpoint -> SSL pytree directory
    python -m rtdsd_tpu_torch.cli.convert --fairseq xlsr2_300m.pt \\
        --out pretrained/xlsr_jax
    # HF transformers snapshot (config.json + model.safetensors or
    # pytorch_model.bin) -> the same
    python -m rtdsd_tpu_torch.cli.convert --hf wav2vec2-xls-r-300m \\
        --out pretrained/xlsr_jax
    # trained reference model .pt -> weights directory
    python -m rtdsd_tpu_torch.cli.convert --reference best.pt \\
        --model XLSR_AASIST --out runs/converted_best

An SSL pytree directory is what ``ssl_pytree_path`` names in every shipped
config. The conversion reads and writes files on the host only; no model
runs.
"""

from __future__ import annotations

import argparse
import os

from rtdsd_tpu_torch.models.convert import (load_reference_state_dict,
                                            to_jax_ssl_params,
                                            to_jax_variables)
from rtdsd_tpu_torch.models.convert_fairseq import encoder_state_dict
from rtdsd_tpu_torch.models.convert_hf import convert_hf_checkpoint, load_hf_dir
from rtdsd_tpu_torch.utils import flax_msgpack


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fairseq", type=str, default=None,
                   help="fairseq wav2vec2/XLSR .pt checkpoint")
    p.add_argument("--hf", type=str, default=None,
                   help="HF transformers snapshot dir (config.json + "
                        "model.safetensors / pytorch_model.bin)")
    p.add_argument("--reference", type=str, default=None,
                   help="trained reference model .pt state dict")
    p.add_argument("--model", type=str, default="XLSR_AASIST",
                   help="reference model class name (for --reference)")
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)

    if args.fairseq or args.hf:
        if args.hf:
            sd, _ = convert_hf_checkpoint(*load_hf_dir(args.hf))
        else:
            sd = encoder_state_dict(args.fairseq)
        params = to_jax_ssl_params(sd)
        os.makedirs(args.out, exist_ok=True)
        flax_msgpack.write(os.path.join(args.out, "weights.msgpack"),
                           {"params": params})
        n = sum(x.size for x in _leaves(params))
        print(f"Converted XLSR front-end: {n / 1e6:.1f}M params -> {args.out}")
    elif args.reference:
        tree = to_jax_variables(load_reference_state_dict(args.reference),
                                args.model)
        os.makedirs(args.out, exist_ok=True)
        flax_msgpack.write(os.path.join(args.out, "weights.msgpack"), tree)
        print(f"Converted {args.model} -> {args.out}")
    else:
        p.error("one of --fairseq / --hf / --reference required")


if __name__ == "__main__":
    main()

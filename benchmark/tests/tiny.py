"""Cells at a tiny size on the CPU, for the harness's tests."""

import json
import time

import torch

from benchmark.harness import runner

PARAMS = {
    "score_files": dict(files=10, min_s=0.3, max_s=1.5, duration_s=1.0,
                        batch=4, threads=2, trace_files=4),
    "serve_paced": dict(streams=3, compare=12, trace_ticks=2, bank_waves=2),
}


# A tiny float32 cell's own limits, set as the rules set a cell's: on four
# seeds of each kind and family, sound runs read 1e-6 to 4e-6 on both gaps
# (but see PERF.md: at some weights the CPU's vector and scalar sigmoid
# split the pools' ties); each fault reads at least 0.15 (gap_max) and the
# fp8 reference of the Conformer family at least 0.025 (gap_q50) and 0.073
# (gap_max). The cells' bf16 limits (0.04, 0.25) are set for the card at
# full size: a half batch of a tiny model's near-alike answers passes them
# on some seeds.
LIMITS = {"gap_q50": 1e-3, "gap_max": 1e-2, "low_precision_ops": 0}

CONFORMER_HEAD = {"name": "Conformer", "emb_size": 32, "heads": 4,
                  "kernel_size": 7, "n_encoders": 2, "ff_mult": 4,
                  "conv_expansion_factor": 2, "max_pos_emb": 512}


def config(name: str, layers: int = 2, width: int = 32) -> dict:
    """A configuration at a tiny width in float32: one of the benchmark's
    files, or ``tiny_conformer`` (the ``xlsr_conformer`` family on the
    flagship's front-end, a head of two blocks of width 32)."""
    if name == "tiny_conformer":
        cfg = config("xlsr_aasist", layers, width)
        cfg.pop("weights")
        cfg.update(name=name, family="xlsr_conformer",
                   backend=dict(CONFORMER_HEAD))
        cfg["program"] = {"model": "My_XLSR_Conformer",
                          "compute_dtype": "float32",
                          "kwargs": {"num_layers": layers,
                                     "w2v": {"fast_softmax": False}}}
        return cfg
    cfg = json.loads(json.dumps(runner.config(name)))
    cfg.update(hidden_size=width, num_attention_heads=4,
               intermediate_size=2 * width, conv_dim=[32] * 7,
               num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
               num_hidden_layers=layers)
    cfg["program"] = {"model": "My_XLSR_AASIST", "compute_dtype": "float32",
                      "kwargs": {"num_layers": layers, "fused_gat": True,
                                 "w2v": {"fast_softmax": False}}}
    return cfg


def context(cell: str, fault=None, trace=False, seed=2 ** 31 + 5,
            seconds=1.0, **cfg_kw) -> runner.Context:
    wl = json.loads(json.dumps(runner.workload(cell)))
    wl["params"].update(PARAMS[wl["kind"]])
    return runner.Context(cell=cell, workload=wl,
                          config=config(wl["config"], **cfg_kw), seed=seed,
                          seconds=seconds, trace=trace,
                          device=torch.device("cpu"), fault=fault,
                          t_start=time.perf_counter())


def run(ctx) -> dict:
    out = runner.traffic(ctx.workload["kind"]).run(ctx)
    return runner.result_line(runner.manifest(), ctx.cell, ctx, out,
                              {"platform": "cpu"})

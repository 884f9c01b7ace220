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


def config(name: str, layers: int = 2, width: int = 32) -> dict:
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

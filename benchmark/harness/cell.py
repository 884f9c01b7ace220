"""Steps every traffic kind shares: the model under test and its weights,
the census of its narrow operations, the device's peak memory, freeing the
program's state, and the reference's answers and the comparison."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import compare, program
from benchmark.harness.census import Census
from benchmark.harness.weights import model_weights
from benchmark.reference import xlsr_aasist as ref


class Phases:
    """Set-up's phases on standard error: the seconds each took, the
    first from process start (imports, the CUDA context)."""

    def __init__(self, t_start: float):
        self.t_start = self.last = t_start
        self.mark("imports and device")

    def mark(self, name: str) -> float:
        """Print the phase that just ended; returns set-up's seconds so
        far."""
        now = time.perf_counter()
        print(f"set-up: {name} {now - self.last:.2f} s", file=sys.stderr)
        self.last = now
        return now - self.t_start


def setup_model(ctx) -> Tuple[Dict[str, torch.Tensor], torch.nn.Module]:
    """(weights, the program's model) for the cell's configuration; the
    model with the program's int8 path on where ``ctx.w8a8`` asks."""
    w = model_weights(ctx.config, ctx.seed, ctx.device)
    return w, program.build_model(ctx.config, w, ctx.device, ctx.w8a8)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) \
        if device.type == "cuda" else 0


def free(device) -> None:
    """Release the program's state once the caller dropped its references,
    before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_gaps(ctx, weights, waves: torch.Tensor, got: np.ndarray,
                   index: np.ndarray, block: int = 40) -> Dict[str, float]:
    """The reference's float32 bonafide logits of ``waves`` (one row a
    distinct input), taken at ``index`` for each answer ``got``, against
    the answers: ``compare.gap_numbers``."""
    want = ref.bonafide_scores(weights, ref.ModelShape(ctx.config), waves,
                               block=block).numpy()
    return compare.gap_numbers(got, want[index])


def reference_checks(ctx, weights, waves: torch.Tensor, got: np.ndarray,
                     index: np.ndarray, census: Optional[Census],
                     block: int = 40) -> Dict[str, tuple]:
    """The comparison under the cell's limits: the answers' gaps, and the
    narrow operations the census counted in the timed path (none counted
    at all reads as infinitely many)."""
    numbers = reference_gaps(ctx, weights, waves, got, index, block)
    counted = None if census is None else census.count
    numbers["low_precision_ops"] = (float("inf") if counted is None
                                    else float(counted))
    return compare.checks(numbers, ctx.workload["limits"])

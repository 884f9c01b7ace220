"""Steps every traffic kind shares: the model under test and its weights,
the census of its narrow operations, the device's peak memory, freeing the
program's state, the kernels' roofline readings, and the reference's
answers and the comparison. Each goes through the configuration's family
(``runner.family``)."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.harness import card, compare, program
from benchmark.harness.census import Census
from benchmark.harness.weights import model_weights


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


def kernel_readings(ctx, before: Dict[str, Tuple[str, int]], tr,
                    rows: int, frames: int) -> Dict[str, float]:
    """``kernel_s.<kernel>`` and ``bound_s.<kernel>`` for each kernel of
    the family's ``program.kernels()``: its device seconds in the trace
    ``tr``, and the least time its launches since ``before`` (that list
    read earlier) could take, each launch at ``rows`` clips of ``frames``
    frames as ``counts.kernels`` counts it."""
    fam = ctx.family
    after = fam.program.kernels()
    counted = fam.counts.kernels(ctx.config, rows, frames)
    if set(counted) != set(after):
        raise ValueError(f"family {fam.name!r}: the program's kernels "
                         f"{sorted(after)} are not the counted "
                         f"{sorted(counted)}")
    out = {}
    for name, (in_trace, launches) in after.items():
        ops, nbytes, dtype = counted[name]
        out["kernel_s." + name] = tr.kernel_seconds(in_trace)
        out["bound_s." + name] = (launches - before[name][1]) \
            * card.bound_seconds(ops, nbytes, dtype)
    return out


def reference_scores(ctx, weights, waves: torch.Tensor, block: int = 40,
                     precision: str = "float32") -> np.ndarray:
    """The family reference's bonafide logits of ``waves``."""
    ref = ctx.family.reference
    return ref.bonafide_scores(weights, ref.ModelShape(ctx.config), waves,
                               block=block, precision=precision).numpy()


def reference_gaps(ctx, weights, waves: torch.Tensor, got: np.ndarray,
                   index: np.ndarray, block: int = 40) -> Dict[str, float]:
    """The reference's float32 bonafide logits of ``waves`` (one row a
    distinct input), taken at ``index`` for each answer ``got``, against
    the answers: ``compare.gap_numbers``."""
    want = reference_scores(ctx, weights, waves, block)
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

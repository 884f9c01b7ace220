"""Faults planted under the timed path, for the harness's own tests: the
run must come out not correct with each.

- ``half_batch``: a dispatch scores the first half of its rows and gives
  the rest the mean of those;
- ``altered``: a dispatch alters its first answer (+1 logit).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch

FAULTS = ("half_batch", "altered")


def _broken(scores_of, fault: str):
    def run(rows: torch.Tensor, *args):
        if fault == "half_batch":
            half = max(rows.shape[0] // 2, 1)
            s = scores_of(rows[:half], *args)
            rest = s.mean().expand(rows.shape[0] - half)
            return torch.cat([s, rest])
        s = scores_of(rows, *args).clone()
        s[0] += 1.0
        return s
    return run


@contextlib.contextmanager
def planted(fault: Optional[str]) -> Iterator[None]:
    """Break the scoring step (``cli/common.py``'s ``make_score_step``) and
    the serving engine's score dispatch while the block runs."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; have {FAULTS}")
    from rtdsd_tpu_torch.cli import common
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer

    make_step = common.make_score_step
    score_windows = MultiStreamScorer.score_windows

    def make_broken_step(model):
        step = make_step(model)
        return _broken(lambda w: step(w), fault)

    def broken_windows(self, model, feats, slots, starts):
        def rows_of(idx):
            return score_windows(self, model, feats, slots[idx], starts[idx])
        idx = torch.arange(slots.shape[0], device=slots.device)
        return _broken(rows_of, fault)(idx)

    common.make_score_step = make_broken_step
    MultiStreamScorer.score_windows = broken_windows
    try:
        yield
    finally:
        common.make_score_step = make_step
        MultiStreamScorer.score_windows = score_windows

"""Full-state checkpoints of the port: the counterpart of
``rtdsd_tpu/engine/checkpoint.py`` in the port's own format.

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of the
model's state dict under the reference's names, the optimizer's state dict,
the step and the epoch) and ``meta.json``. Both are written to a temporary
file first and moved into place with ``os.replace``, so a crash mid-save
leaves the previous checkpoint whole. Restoring the full state resumes a run
exactly. Saves are synchronous.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from rtdsd_tpu_torch.engine.steps import TrainState

STATE = "state.pt"


def _replace_into(path: str, name: str, write) -> None:
    tmp = os.path.join(path, name + ".tmp")
    write(tmp)
    os.replace(tmp, os.path.join(path, name))


def save_checkpoint(path: str, state: TrainState, epoch: Optional[int] = None,
                    meta: Optional[dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    blob = {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step, "epoch": epoch}
    _replace_into(path, STATE, lambda tmp: torch.save(blob, tmp))

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta or {}, f, indent=2)
    _replace_into(path, "meta.json", write_meta)


def is_checkpoint(path: str) -> bool:
    return os.path.isfile(os.path.join(path, STATE))


def _load(path: str) -> dict:
    return torch.load(os.path.join(path, STATE), map_location="cpu",
                      weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load the model, optimizer and step of ``path`` into ``state`` (built
    as the saving run built it); returns ``state``."""
    blob = _load(path)
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state


def load_model_state(path: str) -> dict:
    """The model's state dict of the checkpoint directory ``path``."""
    return _load(path)["model"]

"""Full-state checkpoints of the port: the counterpart of
``rtdsd_tpu/engine/checkpoint.py`` in the port's own format.

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of the
model's state dict under the reference's names, the optimizer's state dict,
the step and the epoch) and ``meta.json``. Both are written to a temporary
file first and moved into place with ``os.replace``, so a crash mid-save
leaves the previous checkpoint whole. Restoring the full state resumes a run
exactly. :func:`save_checkpoint` writes before it returns;
:func:`save_checkpoint_async` copies the state to the host before it
returns and writes it from a thread, as the JAX package's async saves let
the train loop go on.

The JAX package's checkpoint directories are read for their model only
(:func:`load_jax_variables`): ``state.msgpack`` (flax's bytes of ``step``,
``params``, ``batch_stats``, ``opt_state``) and the weights-only
``weights.msgpack``. Its orbax directories raise: reading them needs orbax
and tensorstore.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Optional

import torch

from rtdsd_tpu_torch.engine.steps import TrainState
from rtdsd_tpu_torch.utils import flax_msgpack

STATE = "state.pt"
JAX_STATE, JAX_WEIGHTS = "state.msgpack", "weights.msgpack"
ORBAX = ("orbax", "orbax.prev")


def _replace_into(path: str, name: str, write) -> None:
    tmp = os.path.join(path, name + ".tmp")
    write(tmp)
    os.replace(tmp, os.path.join(path, name))


def _blob(state: TrainState, epoch: Optional[int]) -> dict:
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step, "epoch": epoch}


def _write(path: str, blob: dict, meta: Optional[dict]) -> None:
    os.makedirs(path, exist_ok=True)
    _replace_into(path, STATE, lambda tmp: torch.save(blob, tmp))

    def write_meta(tmp):
        with open(tmp, "w") as f:
            json.dump(meta or {}, f, indent=2)
    _replace_into(path, "meta.json", write_meta)


def save_checkpoint(path: str, state: TrainState, epoch: Optional[int] = None,
                    meta: Optional[dict] = None) -> None:
    _write(path, _blob(state, epoch), meta)


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` whose tensors are fresh host tensors (a device
    tensor's copy completes before this returns)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class AsyncSave:
    """A save in flight: ``wait_until_finished()`` joins its writer and
    raises the writer's error, once."""

    def __init__(self, path: str, blob: dict, meta: Optional[dict]):
        self.path, self._error = path, None
        self._thread = threading.Thread(target=self._run,
                                        args=(path, blob, meta),
                                        name="checkpoint-writer", daemon=True)
        self._thread.start()

    def _run(self, path, blob, meta) -> None:
        try:
            _write(path, blob, meta)
        except Exception as e:           # re-raised in the caller's thread
            self._error = e

    def wait_until_finished(self) -> None:
        self._thread.join()
        err, self._error = self._error, None
        if err is not None:
            raise err


_IN_FLIGHT: Optional[AsyncSave] = None


def save_checkpoint_async(path: str, state: TrainState,
                          epoch: Optional[int] = None,
                          meta: Optional[dict] = None) -> AsyncSave:
    """Save as :func:`save_checkpoint` does, the writing in a thread. The
    model's and the optimizer's state are copied to the host before this
    returns, so the next step may update the parameters in place. A save
    still in flight is waited for first (its error raised here)."""
    global _IN_FLIGHT
    if _IN_FLIGHT is not None:
        prev, _IN_FLIGHT = _IN_FLIGHT, None
        prev.wait_until_finished()
    _IN_FLIGHT = AsyncSave(path, _to_host(_blob(state, epoch)), meta)
    return _IN_FLIGHT


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


def load_jax_variables(path: str) -> dict:
    """``{'params', 'batch_stats'}`` of one of the JAX package's checkpoint
    directories, with its precedence: an orbax directory first (it raises
    here), then ``state.msgpack``, then ``weights.msgpack``."""
    if any(os.path.exists(os.path.join(path, n)) for n in ORBAX):
        raise NotImplementedError(
            f"{path}: the JAX package's orbax checkpoints need orbax and "
            "tensorstore, which the port does not use; on a JAX install, "
            "write a reference .pt with "
            "rtdsd_tpu/models/export_reference.py::export_reference_model "
            "(or save the state with the synchronous msgpack writer) and "
            "load that")
    for name in (JAX_STATE, JAX_WEIGHTS):
        if os.path.isfile(os.path.join(path, name)):
            tree = flax_msgpack.read(os.path.join(path, name))
            if not tree.get("batch_stats"):
                raise ValueError(
                    f"{os.path.join(path, name)} holds no batch_stats: it is "
                    "not a whole model's checkpoint (an SSL pytree goes in "
                    "ssl_pytree_path)")
            return {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    raise FileNotFoundError(
        f"{path}: neither the port's {STATE} nor the JAX package's "
        f"{JAX_STATE} / {JAX_WEIGHTS} is in this directory")

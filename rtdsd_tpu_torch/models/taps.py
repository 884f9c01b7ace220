"""Named activations of a forward pass, for knowledge distillation.

The JAX package takes a distillation tap from flax's
``capture_intermediates`` (a module's ``__call__`` output) or from the
hidden states its encoder sows. Many of the port's modules are applied
functionally (``linear`` / ``batch_norm`` / ``conv2d`` on a module's
weights; the residual blocks' holders are never called), so a forward hook
would not fire or would see another tensor. The models instead call
:func:`record` at the points whose value is the JAX module's output, under
the JAX path (``backend/LL``, ``backend/encoder_3``, ``ssl_hidden:5`` ...),
in the JAX layout (the AASIST's 2-D maps NHWC). Nothing is kept unless a
:class:`capture` asks for that name.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable

import torch

_state = threading.local()


class capture:
    """``with capture(names) as taps:`` fills the dict ``taps`` with the
    recorded activations of ``names`` made in this thread inside the block
    (as they are: a student's keep their graph)."""

    def __init__(self, names: Iterable[str]):
        self.names = frozenset(names)
        self.taps: Dict[str, torch.Tensor] = {}

    def __enter__(self) -> Dict[str, torch.Tensor]:
        self._outer = getattr(_state, "active", None)
        _state.active = self
        return self.taps

    def __exit__(self, *exc) -> None:
        _state.active = self._outer


def active() -> bool:
    return getattr(_state, "active", None) is not None


def record(name: str, x: torch.Tensor, channels_first: bool = False
           ) -> torch.Tensor:
    """Keep ``x`` under ``name`` if the active capture asks for it;
    ``channels_first`` moves an NCHW map's channels last (flax's layout).
    Returns ``x``."""
    cap = getattr(_state, "active", None)
    if cap is not None and name in cap.names:
        cap.taps[name] = x.movedim(1, -1) if channels_first else x
    return x

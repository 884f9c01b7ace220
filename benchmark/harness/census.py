"""The operations of the timed path that compute below bfloat16.

:class:`Census` hooks the program's model, and the modules of it that the
timed path also calls on their own (the serving engine's extend calls the
conv front-end), and counts, in the forwards it is armed for, the
operations that read or write a tensor of one byte or less other than a
bool: an int8, uint8, sub-byte or float8 tensor. It counts them under a
``TorchDispatchMode``, so it sees what the forward computes, whatever
module or operator computes it. The program's own int8 path (``w8a8``)
runs every transformer matmul on int8 tensors; a bfloat16 forward reads 0.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ALL = "all"


def narrow(dtype: torch.dtype) -> bool:
    return dtype != torch.bool and dtype.itemsize <= 1


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and narrow(t.dtype)
               for t in tree_leaves((args, kwargs, out))):
            self.n += 1
        return out


class Census:
    """Counts narrow operations in chosen top-level forwards of
    ``modules`` (a forward of one of them inside another's is part of the
    outer one). ``count`` is ``None`` until an armed forward has run."""

    def __init__(self, modules: Sequence[torch.nn.Module]):
        self.count: Optional[int] = None
        self._pick = None          # None, ALL, or the index of the call
        self._calls = self._depth = 0
        self._mode: Optional[_Count] = None
        self._handles = []
        for m in modules:
            self._handles.append(m.register_forward_pre_hook(self._enter))
            self._handles.append(m.register_forward_hook(self._exit,
                                                         always_call=True))

    def observe_call(self, i: int) -> None:
        """Count the ``i``-th top-level forward from now (0: the next)."""
        self._calls, self._pick = 0, int(i)

    @contextlib.contextmanager
    def observing(self) -> Iterator[None]:
        """Count every top-level forward while the block runs."""
        self._pick = ALL
        try:
            yield
        finally:
            self._pick = None

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def _enter(self, module, args) -> None:
        if self._depth == 0 and self._pick is not None:
            if self._pick == ALL or self._calls == self._pick:
                self._mode = _Count()
                self._mode.__enter__()
            self._calls += 1
        self._depth += 1

    def _exit(self, module, args, out) -> None:
        self._depth -= 1
        if self._depth == 0 and self._mode is not None:
            self._mode.__exit__(None, None, None)
            self.count = (self.count or 0) + self._mode.n
            self._mode = None
            if self._pick != ALL:
                self._pick = None

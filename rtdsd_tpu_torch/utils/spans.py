"""Named host ranges at the program's layer boundaries, recorded only while
a ``torch.profiler`` session runs.

``span(name)`` is ``torch.profiler.record_function(name)`` under an active
profiler: kineto then keeps the range on the host timeline, on the clock of
the device events, so each range lines up with the operations launched
inside it. With no profiler running, and while ``torch.export`` or dynamo
traces the code, it is one shared no-op context and costs a flag check.

Spans: ``serve.poll`` and, inside it, ``serve.due``, ``serve.pack``,
``serve.extend``, ``serve.score``, ``serve.readback``
(``engine/serving.py``); ``score.loader_wait`` and ``score.readback``
(``cli/common.py::score_dataset``); ``model.frontend``, ``model.encoder``
with a ``model.ffn`` a transformer layer, and ``model.backend``.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_NOOP = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler runs."""
    if torch.compiler.is_compiling() or not torch.autograd._profiler_enabled():
        return _NOOP
    return torch.profiler.record_function(name)


def spanned(name: str):
    """Decorator: the whole call inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap

"""The device trace of a short traced section, and what is read from it.

``traced(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activities) and keeps the raw events: device operations (kernels, copies,
sets) on the device timeline and host ranges on the host timeline, both
in nanoseconds of one clock. The harness marks its own steps with
``record_function`` ranges whose names start with ``bench.``; the
per-layer readers and the result's ``breakdown`` read a :class:`Trace`.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

Span = Tuple[str, int, int]          # (name, start ns, end ns)


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _overlap(merged: List[Tuple[int, int]], s: int, e: int) -> int:
    return sum(max(0, min(e, b) - max(s, a)) for a, b in merged
               if a < e and b > s)


class Trace:
    """Device operations and host ranges of one traced section."""

    def __init__(self, device_ops: List[Span], host: List[Span],
                 start_ns: int, end_ns: int):
        self.device_ops = sorted(device_ops, key=lambda x: x[1])
        self.host = sorted(host, key=lambda x: x[1])
        self.start_ns, self.end_ns = start_ns, end_ns
        self._busy = _union([(s, e) for _, s, e in self.device_ops])

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return _overlap(self._busy, self.start_ns, self.end_ns) / 1e9

    def busy_within(self, s: int, e: int) -> float:
        return _overlap(self._busy, s, e) / 1e9

    def ranges(self, name: str) -> List[Span]:
        """The host ranges named ``name`` (a ``record_function`` of the
        harness)."""
        return [h for h in self.host if h[0] == name]

    def kernel_seconds(self, substring: str) -> float:
        """Seconds of the device operations whose name holds
        ``substring``."""
        return sum(e - s for n, s, e in self.device_ops
                   if substring in n) / 1e9

    def top_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time, summed by name."""
        tot: dict = {}
        for name, s, e in self.device_ops:
            tot[name] = tot.get(name, 0) + (e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The longest stretches with no device operation inside the traced
        section, each named by the innermost host range that covers its
        middle ("host: none" where the host ran no range there)."""
        edges = [self.start_ns] + [x for a, b in self._busy
                                   for x in (a, b)] + [self.end_ns]
        gaps = []
        for i in range(0, len(edges) - 1, 2):
            s, e = max(edges[i], self.start_ns), min(edges[i + 1],
                                                     self.end_ns)
            if e > s:
                gaps.append((e - s, s, e))
        gaps.sort(reverse=True)
        out = []
        for length, s, e in gaps[:n]:
            mid = (s + e) // 2
            cover = [h for h in self.host if h[1] <= mid < h[2]]
            label = (min(cover, key=lambda h: h[2] - h[1])[0] if cover
                     else "host: none")
            out.append([label[:200], length / 1e9])
        return out


def traced(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """(``fn()``, its :class:`Trace`): ``fn`` runs under the profiler inside
    the ``bench.section`` range, which bounds the traced window, and the
    device is synchronized before the range closes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
        with record_function("bench.section"):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    dev: List[Span] = []
    host: List[Span] = []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        span = (ev.name(), s, s + ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                dev.append(span)
        else:
            host.append(span)
    (_, start, end), = [h for h in host if h[0] == "bench.section"]
    return out, Trace(dev, host, start, end)

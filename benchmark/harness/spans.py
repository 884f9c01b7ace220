"""The program's own spans on a device trace, and the device time of the
operations launched inside each.

The program marks its layer boundaries with ``record_function`` ranges
named ``serve.*``, ``score.*`` and ``model.*`` while a profiler runs
(``rtdsd_tpu_torch/utils/spans.py``). ``traced(fn)`` profiles ``fn`` as
``harness.trace.traced`` does and returns the same device operations, host
ranges and window in a :class:`SpanTrace`, which also keeps, for each
device operation, the host time and thread of the runtime call that
launched it (matched by kineto's correlation id), and the program's spans.

A device operation belongs to the innermost program span open on its
launching thread at its launch, and to every span enclosing that one: a
span's device time is the union of the intervals of the operations
launched while it was open, so each operation counts once a span name,
and an operation launched outside every program span counts for none.

``serve_readings`` and ``score_readings`` give the per-layer quantities a
traced run of a cell can read from the spans; where the program records no
span (a build without them) they give nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.harness.trace import Span, Trace, _union

PROGRAM = ("serve.", "score.", "model.")
RUNTIME = "cu"        # CUDA runtime and driver calls: cudaLaunchKernel, ...

ProgramSpan = Tuple[str, int, int, int]     # (name, start ns, end ns, tid)
Launch = Tuple[int, int]                     # (launch ns, tid)


def _open_at(spans: List[ProgramSpan], points: List[Tuple[int, int]]
             ) -> Dict[int, List[ProgramSpan]]:
    """For each (time, key) of ``points``, the spans of ``spans`` (one
    thread's, properly nested) open at that time, outermost first."""
    by_start = sorted(spans, key=lambda x: (x[1], -x[2]))
    stack: List[ProgramSpan] = []
    out: Dict[int, List[ProgramSpan]] = {}
    i = 0
    for t, key in sorted(points):
        while i < len(by_start) and by_start[i][1] <= t:
            sp = by_start[i]
            i += 1
            while stack and stack[-1][2] <= sp[1]:
                stack.pop()
            stack.append(sp)
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[key] = list(stack)
    return out


def within(s: int, ranges: Sequence[Span]) -> bool:
    """Whether time ``s`` falls inside one of ``ranges``."""
    return any(a <= s < b for _, a, b in ranges)


class SpanTrace(Trace):
    """A :class:`Trace` with the program's spans and where each device
    operation was launched (``launches[i]`` is that of ``device_ops[i]``
    in time order, or ``None`` where no runtime call matched)."""

    def __init__(self, device_ops: List[Span], host: List[Span],
                 start_ns: int, end_ns: int, spans: List[ProgramSpan],
                 launches: List[Optional[Launch]]):
        order = sorted(range(len(device_ops)),
                       key=lambda i: device_ops[i][1])
        super().__init__(device_ops, host, start_ns, end_ns)
        self.launches = [launches[i] for i in order]
        self.spans = sorted(spans, key=lambda x: (x[1], -x[2]))
        self._owners = self._attribute()

    def _attribute(self) -> List[List[ProgramSpan]]:
        """Each device operation's open program spans at its launch."""
        owners: List[List[ProgramSpan]] = [[] for _ in self.device_ops]
        for tid in {sp[3] for sp in self.spans}:
            points = [(ln[0], i) for i, ln in enumerate(self.launches)
                      if ln is not None and ln[1] == tid]
            mine = [sp for sp in self.spans if sp[3] == tid]
            for i, chain in _open_at(mine, points).items():
                owners[i] = chain
        return owners

    def count(self, name: str, ranges: Sequence[Span]) -> int:
        """The spans named ``name`` that start inside ``ranges``."""
        return sum(1 for sp in self.spans
                   if sp[0] == name and within(sp[1], ranges))

    def _self(self, name: str, ranges: Sequence[Span]
              ) -> List[Tuple[int, int]]:
        """The stretches inside the spans named ``name`` that start inside
        ``ranges`` where no program span nested in them was open."""
        out = []
        for sp in self.spans:
            if sp[0] != name or not within(sp[1], ranges):
                continue
            t = sp[1]
            for a, b in _union([(a, b) for _, a, b, tid in self.spans
                                if tid == sp[3] and sp[1] <= a and b <= sp[2]
                                and (a, b) != (sp[1], sp[2])]):
                out.append((t, a))
                t = b
            out.append((t, sp[2]))
        return out

    def host_ms(self, name: str, ranges: Sequence[Span]) -> float:
        """Host ms inside the spans named ``name`` that start inside
        ``ranges``, less the program spans nested in them (self time)."""
        return sum(e - s for s, e in self._self(name, ranges)) / 1e6

    def idle_ms(self, name: str, ranges: Sequence[Span]) -> float:
        """The part of :meth:`host_ms` in which no operation ran on the
        device."""
        return sum((e - s) / 1e6 - 1e3 * self.busy_within(s, e)
                   for s, e in self._self(name, ranges))

    def device_ms(self, name: str, ranges: Sequence[Span]) -> float:
        """Device ms of the operations launched inside ``ranges`` while a
        span named ``name`` was open: the union of their intervals."""
        got = [(s, e) for (_, s, e), chain, ln
               in zip(self.device_ops, self._owners, self.launches)
               if ln is not None and within(ln[0], ranges)
               and any(sp[0] == name for sp in chain)]
        return sum(e - s for s, e in _union(got)) / 1e6

    def unattributed_ms(self, ranges: Sequence[Span]) -> float:
        """Device ms of the operations launched inside ``ranges`` outside
        every program span, or with no matched launch."""
        got = [(s, e) for (_, s, e), chain, ln
               in zip(self.device_ops, self._owners, self.launches)
               if not chain and within(ln[0] if ln else s, ranges)]
        return sum(e - s for s, e in _union(got)) / 1e6


def traced(fn: Callable[[], object]) -> Tuple[object, SpanTrace]:
    """``harness.trace.traced`` with the program's spans and each device
    operation's launch kept: the same device operations, host ranges and
    window."""
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
    dev_corr: List[int] = []
    host: List[Span] = []
    spans: List[ProgramSpan] = []
    launch: Dict[int, Launch] = {}
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        span = (ev.name(), s, s + ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                dev.append(span)
                dev_corr.append(ev.correlation_id())
            continue
        host.append(span)
        if ev.is_user_annotation():
            if ev.name().startswith(PROGRAM):
                spans.append(span + (ev.start_thread_id(),))
        elif ev.name().startswith(RUNTIME):
            # a runtime call shares its correlation id with the device
            # operations it enqueued; a framework operator's id is its own
            c = ev.correlation_id()
            if c not in launch or s < launch[c][0]:
                launch[c] = (s, ev.start_thread_id())
    (_, start, end), = [h for h in host if h[0] == "bench.section"]
    return out, SpanTrace(dev, host, start, end, spans,
                          [launch.get(c) for c in dev_corr])


def serve_readings(tr: SpanTrace) -> Dict[str, float]:
    """Per traced tick (the ``bench.tick`` ranges): host ms inside
    ``serve.due``, ``serve.pack``, ``serve.readback`` and the poll's self
    time, and device ms of the operations launched under ``serve.extend``
    and ``serve.score``; nothing without the program's spans or ticks."""
    ticks = tr.ranges("bench.tick")
    if not ticks or not tr.count("serve.poll", ticks):
        return {}
    n = len(ticks)
    return {"due_ms_per_tick.serve": tr.host_ms("serve.due", ticks) / n,
            "pack_ms_per_tick.serve": tr.host_ms("serve.pack", ticks) / n,
            "readback_ms_per_tick.serve":
                tr.host_ms("serve.readback", ticks) / n,
            "extend_device_ms_per_tick.serve":
                tr.device_ms("serve.extend", ticks) / n,
            "score_device_ms_per_tick.serve":
                tr.device_ms("serve.score", ticks) / n,
            "poll_self_ms_per_tick.serve":
                tr.host_ms("serve.poll", ticks) / n}


def score_readings(tr: SpanTrace, clips: int) -> Dict[str, float]:
    """Of the traced ``score_dataset`` call (``bench.section``) over
    ``clips`` clips: host ms a batch inside ``score.loader_wait``, and
    device ms a clip launched under each model layer; nothing without the
    program's spans."""
    whole = tr.ranges("bench.section")
    batches = tr.count("score.loader_wait", whole)
    if not batches or not clips:
        return {}
    out = {"loader_wait_ms_per_batch.score":
           tr.host_ms("score.loader_wait", whole) / batches}
    for layer in ("frontend", "encoder", "ffn", "backend"):
        out[f"{layer}_device_ms_per_clip.score"] = tr.device_ms(
            f"model.{layer}", whole) / clips
    return out

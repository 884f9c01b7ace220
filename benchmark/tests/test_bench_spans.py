"""The program's spans on a trace (``harness/spans.py``): attribution of
device operations to the spans that launched them, and the readings, on
synthetic traces with hand-computed values; the same device operations,
host ranges and readings as ``harness.trace.traced`` on one event list;
and tiny traced runs of the cells on the CPU through ``benchmark/spans.py``'s
summaries."""

import math
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import spans as tool
from benchmark.harness import runner, spans, trace
from benchmark.tests import tiny

M = 1_000_000                       # ns a ms: the synthetic times are in ms


def _ms(*xs):
    return tuple(int(x * M) for x in xs)


def _span(name, s, e, tid=1):
    return (name,) + _ms(s, e) + (tid,)


def _serve_trace():
    """Two ticks: the first launches four operations (under
    model.frontend in serve.extend, model.ffn in model.encoder in
    serve.score, model.backend, and serve.readback), the second none; one
    operation launched outside every span before the ticks, one by a
    drain's extend after them."""
    host = [("bench.section",) + _ms(0, 1000),
            ("bench.tick",) + _ms(100, 500), ("bench.tick",) + _ms(600, 900),
            ("bench.push",) + _ms(100, 110), ("bench.push",) + _ms(600, 610)]
    program = [
        _span("serve.poll", 110, 490), _span("serve.due", 120, 140),
        _span("serve.pack", 140, 170), _span("serve.extend", 170, 200),
        _span("model.frontend", 175, 195), _span("serve.due", 200, 210),
        _span("serve.pack", 210, 220), _span("serve.score", 220, 260),
        _span("model.encoder", 225, 250), _span("model.ffn", 230, 240),
        _span("model.backend", 250, 258), _span("serve.readback", 260, 480),
        _span("serve.poll", 610, 890), _span("serve.due", 620, 630),
        _span("serve.pack", 630, 640), _span("serve.extend", 640, 700),
        _span("serve.due", 700, 705), _span("serve.pack", 705, 715),
        _span("serve.score", 715, 800), _span("serve.readback", 800, 880),
        _span("serve.poll", 920, 990), _span("serve.extend", 930, 950)]
    ops = [("conv",) + _ms(200, 300), ("gemm",) + _ms(300, 350),
           ("gat",) + _ms(340, 380), ("cast",) + _ms(380, 390),
           ("early",) + _ms(60, 80), ("drain",) + _ms(950, 960)]
    launches = [_ms(180) + (1,), _ms(232) + (1,), _ms(255) + (1,),
                _ms(265) + (1,), _ms(50) + (1,), _ms(940) + (1,)]
    host += [sp[:3] for sp in program]
    return spans.SpanTrace(ops, host, 0, 1000 * M, program, launches)


def _score_trace():
    """Three batches' loader waits and one batch's model layers (four
    clips), and the read-back."""
    program = [
        _span("score.loader_wait", 10, 60), _span("model.frontend", 60, 80),
        _span("model.encoder", 80, 150), _span("model.ffn", 90, 120),
        _span("model.backend", 150, 170),
        _span("score.loader_wait", 300, 320),
        _span("score.loader_wait", 600, 610),
        _span("score.readback", 900, 990)]
    ops = [("conv",) + _ms(100, 200), ("fc1",) + _ms(200, 260),
           ("pos",) + _ms(260, 300), ("gat",) + _ms(300, 310),
           ("copy",) + _ms(920, 925), ("h2d",) + _ms(55, 58)]
    launches = [_ms(70) + (1,), _ms(100) + (1,), _ms(130) + (1,),
                _ms(160) + (1,), _ms(910) + (1,), _ms(62) + (2,)]
    host = [("bench.section",) + _ms(0, 1000)] + [sp[:3] for sp in program]
    return spans.SpanTrace(ops, host, 0, 1000 * M, program, launches)


def test_serve_readings_by_hand():
    got = spans.serve_readings(_serve_trace())
    want = {"due_ms_per_tick.serve": (20 + 10 + 10 + 5) / 2,
            "pack_ms_per_tick.serve": (30 + 10 + 10 + 10) / 2,
            "readback_ms_per_tick.serve": (220 + 80) / 2,
            "extend_device_ms_per_tick.serve": 100 / 2,
            "score_device_ms_per_tick.serve": 80 / 2,   # 50 and 40 overlap
            "poll_self_ms_per_tick.serve": (20 + 20) / 2}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


def test_score_readings_by_hand():
    got = spans.score_readings(_score_trace(), clips=4)
    want = {"loader_wait_ms_per_batch.score": (50 + 20 + 10) / 3,
            "frontend_device_ms_per_clip.score": 100 / 4,
            "encoder_device_ms_per_clip.score": (60 + 40) / 4,
            "ffn_device_ms_per_clip.score": 60 / 4,
            "backend_device_ms_per_clip.score": 10 / 4}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k


def test_an_operation_counts_once_under_every_span_open_at_its_launch():
    tr = _serve_trace()
    ticks = tr.ranges("bench.tick")
    # the GEMM (launched in model.ffn) and the GAT kernel overlap
    assert tr.device_ms("model.ffn", ticks) == pytest.approx(50)
    assert tr.device_ms("model.encoder", ticks) == pytest.approx(50)
    assert tr.device_ms("model.backend", ticks) == pytest.approx(40)
    assert tr.device_ms("serve.score", ticks) == pytest.approx(80)
    assert tr.device_ms("serve.poll", ticks) == pytest.approx(190)
    assert tr.device_ms("serve.readback", ticks) == pytest.approx(10)


def test_an_operation_launched_outside_every_span_belongs_to_none():
    tr = _serve_trace()
    whole = tr.ranges("bench.section")
    names = {sp[0] for sp in tr.spans}
    everything = sum(e - s for _, s, e in tr.device_ops) / M - 10  # overlap
    attributed = tr.device_ms("serve.poll", whole)
    assert attributed == pytest.approx(everything - 20)      # not "early"
    assert tr.unattributed_ms(whole) == pytest.approx(20)
    assert all(tr.device_ms(n, _ms_range(50, 51)) == 0 for n in names)
    # a launch on a thread with no open span belongs to none either
    sc = _score_trace()
    assert sc.unattributed_ms(sc.ranges("bench.section")) == \
        pytest.approx(3)


def _ms_range(s, e):
    return [("r",) + _ms(s, e)]


def test_spans_outside_the_ticks_are_not_counted():
    tr = _serve_trace()
    ticks = tr.ranges("bench.tick")
    whole = tr.ranges("bench.section")
    assert tr.device_ms("serve.extend", ticks) == pytest.approx(100)
    assert tr.device_ms("serve.extend", whole) == pytest.approx(110)
    assert tr.count("serve.poll", ticks) == 2
    assert tr.count("serve.poll", whole) == 3
    assert tr.host_ms("serve.extend", ticks) == pytest.approx(10 + 60)


def test_idle_time_by_innermost_span():
    tr = _serve_trace()
    ticks = tr.ranges("bench.tick")
    # the device is busy from 200 to 390 in the first tick, idle in the
    # second
    assert tr.idle_ms("serve.pack", ticks) == pytest.approx(30 + 10 + 10)
    assert tr.idle_ms("serve.readback", ticks) == pytest.approx(90 + 80)
    assert tr.idle_ms("serve.extend", ticks) == pytest.approx(10 + 60)
    assert tr.idle_ms("model.ffn", ticks) == pytest.approx(0)


def test_no_program_spans_give_no_readings():
    tr = _serve_trace()
    bare = spans.SpanTrace(tr.device_ops, tr.host, tr.start_ns, tr.end_ns,
                           [], tr.launches)
    assert spans.serve_readings(bare) == {}
    assert spans.score_readings(bare, clips=4) == {}
    assert tool.serve_summary(bare) == {}
    assert tool.score_summary(bare, 4) == {}


class _Event:
    """A kineto event: what ``torch.autograd._KinetoEvent`` gives."""

    def __init__(self, name, s, e, dev=False, note=False, corr=0, tid=1):
        self._v = (name, s, e, dev, note, corr, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


EVENTS = [
    _Event("bench.section", 0, 1000 * M, note=True, corr=1),
    _Event("bench.tick", 10 * M, 500 * M, note=True, corr=2),
    _Event("serve.poll", 20 * M, 490 * M, note=True, corr=3),
    _Event("serve.score", 30 * M, 60 * M, note=True, corr=4),
    _Event("aten::mm", 31 * M, 40 * M, corr=5),
    _Event("cudaLaunchKernel", 32 * M, 33 * M, corr=5),
    _Event("cudaMemcpyAsync", 70 * M, 71 * M, corr=9),
    _Event("gemm", 40 * M, 300 * M, dev=True, corr=5),
    _Event("Memcpy DtoH", 300 * M, 310 * M, dev=True, corr=9),
    _Event("serve.score", 40 * M, 300 * M, dev=True, note=True, corr=4),
]


def _fake_profile(monkeypatch):
    class Profile:
        def __init__(self, activities=None):
            self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
                events=lambda: list(EVENTS)))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "profile", Profile)


def test_the_same_trace_as_the_harness_on_one_event_list(monkeypatch):
    _fake_profile(monkeypatch)
    _, old = trace.traced(lambda: None)
    _, new = spans.traced(lambda: None)
    assert isinstance(new, trace.Trace)
    assert new.device_ops == old.device_ops and new.host == old.host
    assert (new.start_ns, new.end_ns) == (old.start_ns, old.end_ns)
    assert new.busy_s == old.busy_s and new.window_s == old.window_s
    assert new.top_ops(10) == old.top_ops(10)
    assert new.idle_gaps(10) == old.idle_gaps(10)
    assert new.kernel_seconds("gemm") == old.kernel_seconds("gemm")
    tick, = old.ranges("bench.tick")
    assert new.ranges("bench.tick") == [tick]
    assert new.busy_within(*tick[1:]) == old.busy_within(*tick[1:])
    # the kernel was launched under serve.score, the copy outside it
    assert [sp[0] for sp in new.spans] == ["serve.poll", "serve.score"]
    assert new.launches == [(32 * M, 1), (70 * M, 1)]
    assert new.device_ms("serve.score", [tick]) == pytest.approx(260)
    assert new.device_ms("serve.poll", [tick]) == pytest.approx(270)


@pytest.mark.parametrize("cell", ["aasist_score_b40", "aasist_serve_paced"])
def test_a_tiny_traced_run_reads_the_spans(cell, monkeypatch):
    """A traced run on the CPU with the spans' trace in the harness's
    place: the result line's metrics are the harness's, and the span
    summaries read the host spans (the CPU has no device operations)."""
    kept = []

    def keep(fn):
        out, tr = spans.traced(fn)
        kept.append(tr)
        return out, tr

    monkeypatch.setattr(trace, "traced", keep)
    ctx = tiny.context(cell, trace=True)
    line = tiny.run(ctx)
    assert line["correct"]
    want = {m["name"] for m in runner.cell_metrics(runner.manifest(), cell,
                                                   True)}
    assert set(line["metrics"]) <= want
    tr, = kept
    p = ctx.workload["params"]
    if ctx.workload["kind"] == "serve_paced":
        got = tool.serve_summary(tr)
        assert got["due_ms_per_tick.serve"] > 0
        assert got["pack_ms_per_tick.serve"] > 0
        assert got["poll_self_ms_per_tick.serve"] > 0
        assert got["spans_per_tick"] >= 7
    else:
        got = tool.score_summary(tr, min(p["trace_files"], p["files"]))
        assert got["batches"] == -(-p["trace_files"] // p["batch"])
        assert got["loader_wait_ms_per_batch.score"] > 0
        assert got["spans_per_batch"] >= 4
    for v in got.values():
        vals = v.values() if isinstance(v, dict) else [v]
        assert all(x is None or math.isfinite(x) for x in vals)

"""Live streams served by ``MultiStreamScorer``, in an open loop paced to
the hop.

``streams`` constant streams of 16 kHz audio, each a slowly modulated tone
in noise with no silence (a bank of ``bank_waves`` seeded waves, each
stream reading one at its own offset, so no two windows are alike), are
served with ``window_s`` windows every ``hop_s``, on the engine's defaults
otherwise (no cascade, no gate). Set-up opens the streams, pushes each
one's first window and the conv's receptive-field tail (so that every
later hop completes one window), drains, and runs ``warmup_ticks`` ticks.
In the window, at each due time ``t0 + k * hop_s`` a hop of audio is
pushed to every stream and one ``poll`` runs; a tick that starts late is
run at once, and its lateness is counted.

A window's latency runs from the due time of the tick whose push
completed it to the return of the ``poll`` that returned its score.
End-to-end: ``window_p95_ms`` over every window due in the measured
window. ``compare`` windows drawn from the seed are held to the
reference's forward of their ``window_s`` of samples, and one tick drawn
from the seed (its extend and score dispatches) to the census of narrow
operations.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import audio, card, cell, faults, trace
from benchmark.harness.census import Census
from benchmark.harness.runner import Outcome


class Streams:
    """The streams' audio: stream ``s`` reads bank wave ``s % n`` from
    sample ``(s // n) * spacing`` on."""

    def __init__(self, rng, streams: int, n_waves: int, samples: int,
                 device, spacing: int = 1009):
        self.n, self.spacing = n_waves, spacing
        span = samples + (streams // n_waves + 1) * spacing
        self.bank = np.stack(audio.tones(rng, [span] * n_waves, device))

    def samples(self, s: int, start: int, n: int) -> np.ndarray:
        off = (s // self.n) * self.spacing + start
        return self.bank[s % self.n, off:off + n]


def _inputs(ctx, p: dict, ticks: int):
    """(streams, first, picked streams, picked windows, counted tick) from
    the seed; the bank has room for the traced ticks whether or not the
    run traces, so that a traced run, an untraced one and the control read
    the same audio."""
    rng = np.random.default_rng(ctx.seed)
    window = int(p["window_s"] * audio.SR)
    hop = int(p["hop_s"] * audio.SR)
    first = window + ref_tail(ctx.family.reference.ModelShape(ctx.config))
    total = first + (int(p["warmup_ticks"]) + ticks
                     + int(p["trace_ticks"])) * hop
    S = int(p["streams"])
    streams = Streams(rng, S, int(p["bank_waves"]), total, ctx.device)
    pick_s, pick_w = _sample(p, rng, S, ticks)
    return streams, first, pick_s, pick_w, int(rng.integers(ticks))


def _sample(p: dict, rng, streams: int, windows: int):
    """(stream, window index) pairs whose answers are compared: ``compare``
    draws over the streams and the windows due in the measured window."""
    n = min(int(p["compare"]), streams * windows)
    flat = rng.choice(streams * windows, size=n, replace=False)
    return flat // windows, flat % windows


def run(ctx) -> Outcome:
    p = ctx.workload["params"]
    S, warm = int(p["streams"]), int(p["warmup_ticks"])
    ticks = int(round(ctx.seconds / p["hop_s"]))
    traced_ticks = int(p["trace_ticks"]) if ctx.trace else 0
    phases = cell.Phases(ctx.t_start)
    streams, first, pick_s, pick_w, counted = _inputs(ctx, p, ticks)
    phases.mark("stream audio")
    weights, model = cell.setup_model(ctx)
    census = Census(ctx.family.program.census_modules(model))
    phases.mark("weights and model")
    window = int(p["window_s"] * audio.SR)
    hop = int(p["hop_s"] * audio.SR)
    eng = ctx.family.program.serving_engine(model, duration=window, hop=hop,
                                            max_streams=S)
    if first != window + eng.seg_samples - eng.seg_hop:
        raise RuntimeError("the engine's segment tail is not the conv's "
                           "receptive field less one stride")
    handles = [eng.open_stream(s) for s in range(S)]
    hop_s = float(p["hop_s"])

    def push(g: int) -> None:
        """Tick g's hop (g counts from the first tick after set-up)."""
        start = first + g * hop
        for s, h in enumerate(handles):
            eng.push(h, streams.samples(s, start, hop))

    with faults.planted(ctx.fault):
        for s, h in enumerate(handles):
            eng.push(h, streams.samples(s, 0, first))
        eng.drain()
        phases.mark("engine, first window")
        for g in range(warm):
            push(g)
            eng.poll()
        cell.sync(ctx.device)
        setup_s = phases.mark("warm-up ticks")

        # window w of a stream is completed by tick w - 1; the window's
        # ticks are k = 0 .. ticks - 1, global tick warm + k, so they
        # complete windows warm + 1 .. warm + ticks
        w0 = warm + 1
        scores = np.full((S, ticks), np.nan)
        latency = np.full((S, ticks), np.nan)
        counts0 = dict(eng.dispatch_counts)
        late, tick_ms = [], []
        t0 = time.perf_counter() + 0.05
        due = [t0 + k * hop_s for k in range(ticks)]

        def record(results, t_ret):
            for r in results:
                k = r.start_sample // hop - w0
                if 0 <= k < ticks:
                    s = int(r.stream_id)
                    scores[s, k] = r.score
                    latency[s, k] = t_ret - due[k]

        for k in range(ticks):
            rest = due[k] - time.perf_counter()
            if rest > 0:
                time.sleep(rest)
            late.append(max(0.0, -rest))
            t_tick = time.perf_counter()
            push(warm + k)
            if k == counted:
                with census.observing():
                    res = eng.poll()
            else:
                res = eng.poll()
            t_ret = time.perf_counter()
            tick_ms.append(1e3 * (t_ret - t_tick))
            record(res, t_ret)
        record(eng.drain(), time.perf_counter())
        census.remove()
        done = np.isfinite(latency)
        readings = {
            "dispatches_per_tick": sum(
                v - counts0.get(k, 0) for k, v in eng.dispatch_counts.items()
            ) / ticks,
            "late_ms_max": 1e3 * max(late),
            "late_ms_last": 1e3 * late[-1],
            "tick_p50_ms": float(np.percentile(tick_ms, 50)),
            "tick_p95_ms": float(np.percentile(tick_ms, 95))}
        tr = None
        if traced_ticks:
            tr = _traced_ticks(ctx, eng, push, warm + ticks, traced_ticks,
                               hop_s, readings)
    peak = cell.peak_bytes(ctx.device)
    p95 = float(np.percentile(latency[done], 95) * 1e3) if done.any() \
        else float("inf")
    del eng, model
    cell.free(ctx.device)
    got = scores[pick_s, pick_w]
    waves = torch.from_numpy(np.stack([
        streams.samples(int(s), (w0 + int(w)) * hop, window)
        for s, w in zip(pick_s, pick_w)]))
    checks = cell.reference_checks(ctx, weights, waves, got,
                                   np.arange(len(got)), census, block=64)
    return Outcome(setup_s=setup_s, attempted=S * ticks,
                   failed=int((~done).sum()),
                   end_to_end={"window_p95_ms": p95}, readings=readings,
                   checks=checks, memory_peak_bytes=peak, trace=tr)


def _traced_ticks(ctx, eng, push, g0: int, n: int, hop_s: float,
                  readings: dict) -> trace.Trace:
    """``n`` more paced ticks under the profiler, each a ``bench.tick``
    range; their host and device time, the kernels', and the model
    operations of the windows their polls returned."""
    fam = ctx.family
    rf = torch.profiler.record_function
    scored = []

    def ticks():
        t0 = time.perf_counter()
        for i in range(n):
            rest = t0 + i * hop_s - time.perf_counter()
            if rest > 0:
                with rf("bench.pace"):
                    time.sleep(rest)
            with rf("bench.tick"):
                with rf("bench.push"):
                    push(g0 + i)
                with rf("bench.poll"):
                    scored.append(len(eng.poll()))
        eng.drain()

    launches = fam.program.kernels()
    _, tr = trace.traced(ticks)
    spans = tr.ranges("bench.tick")
    walls = [(e - s) / 1e9 for _, s, e in spans]
    busy = [tr.busy_within(s, e) for _, s, e in spans]
    readings["host_ms_per_tick"] = 1e3 * float(np.mean(
        [w - b for w, b in zip(walls, busy)])) if spans else None
    readings["idle_busy_s"], readings["idle_span_s"] = sum(busy), sum(walls)
    cfg = ctx.config
    readings["model_flops"] = sum(scored) * fam.counts.forward_flops(
        cfg, int(ctx.workload["params"]["window_s"] * audio.SR))
    readings["mfu_seconds"] = sum(busy)
    readings["peak_flops"] = card.PEAK_FLOPS[
        cfg["program"]["compute_dtype"]]
    readings.update(cell.kernel_readings(ctx, launches, tr, eng.score_batch,
                                         eng.win_frames))
    return tr


def fp8_gaps(ctx) -> dict:
    """The answers' gaps of the reference computed in fp8 in the program's
    place, on the windows a run with this seed compares."""
    from benchmark.harness.weights import model_weights

    p = ctx.workload["params"]
    warm = int(p["warmup_ticks"])
    ticks = int(round(ctx.seconds / p["hop_s"]))
    streams, _first, pick_s, pick_w, _ = _inputs(ctx, p, ticks)
    weights = model_weights(ctx.config, ctx.seed, ctx.device)
    window = int(p["window_s"] * audio.SR)
    hop = int(p["hop_s"] * audio.SR)
    waves = torch.from_numpy(np.stack([
        streams.samples(int(s), (warm + 1 + int(w)) * hop, window)
        for s, w in zip(pick_s, pick_w)]))
    got = cell.reference_scores(ctx, weights, waves, block=64,
                                precision="fp8")
    return cell.reference_gaps(ctx, weights, waves, got,
                               np.arange(len(got)), block=64)


def ref_tail(shape) -> int:
    """Samples a segment reads past its last frame's stride: the conv
    stack's receptive field less one stride (80 for XLS-R), from the
    reference's ``shape.conv``."""
    rf, stride = 1, 1
    for _, k, s in reversed(shape.conv):
        rf = (rf - 1) * s + k
    for _, _, s in shape.conv:
        stride *= s
    return rf - stride

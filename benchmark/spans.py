"""Read the program's spans in a traced run of a cell.

    python3 benchmark/spans.py --workload aasist_serve_paced --seed 7 \
        --seconds 51

Runs the cell as ``benchmark/run.py --trace 1`` does, its traced section
profiled by ``harness.spans.traced`` in place of ``harness.trace.traced``
(the same device operations, host ranges and window, so the result line
printed is the one run.py prints). Then prints one more JSON line,
``spans``: the span readings of ``harness.spans``; what they are held
against (a serving tick's host time with the card idle and its busy
time; the traced scoring call's busy time a clip); the program spans a
tick or a batch; and the host cost of one span with a profiler running
and with none. A program without the spans gives no readings.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def span_cost_us(n: int = 20000) -> dict:
    """Host us of one ``span`` entered and left, with no profiler and
    under one tracing the CPU and the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        from rtdsd_tpu_torch.utils.spans import span
    except ImportError:         # a program without the spans
        return {}

    def loop() -> float:
        t = time.perf_counter()
        for _ in range(n):
            with span("model.cost"):
                pass
        return (time.perf_counter() - t) / n * 1e6

    off = loop()
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on = loop()
    return {"span_us_on": on, "span_us_off": off}


def serve_summary(tr) -> dict:
    from benchmark.harness import spans

    ticks = tr.ranges("bench.tick")
    n = len(ticks)
    out = spans.serve_readings(tr)
    if not out:
        return out
    wall = sum(e - s for _, s, e in ticks) / 1e6 / n
    busy = sum(tr.busy_within(s, e) for _, s, e in ticks) * 1e3 / n
    push = sum(e - s for _, s, e in tr.ranges("bench.push")
               if spans.within(s, ticks)) / 1e6 / n
    dev = (out["extend_device_ms_per_tick.serve"]
           + out["score_device_ms_per_tick.serve"])
    idle = {name: tr.idle_ms(name, ticks) / n for name in _names(tr, ticks)}
    idle["bench.push"] = push - sum(tr.busy_within(s, e) * 1e3 for _, s, e
                                    in tr.ranges("bench.push")
                                    if spans.within(s, ticks)) / n
    out.update({
        "wall_ms_per_tick": wall, "busy_ms_per_tick": busy,
        "host_ms_per_tick": wall - busy, "push_ms_per_tick": push,
        "extend_host_ms_per_tick": tr.host_ms("serve.extend", ticks) / n,
        "score_host_ms_per_tick": tr.host_ms("serve.score", ticks) / n,
        "attributed_share": dev / busy if busy else None,
        "unattributed_device_ms_per_tick": tr.unattributed_ms(ticks) / n,
        "spans_per_tick": sum(1 for sp in tr.spans
                              if spans.within(sp[1], ticks)) / n,
        "idle_ms_per_tick_by_span": idle,
        "host_ms_by_tick": {str(i): (e - s) / 1e6 - 1e3 * tr.busy_within(s, e)
                            for i, (_, s, e) in enumerate(ticks)},
        "pack_idle_ms_by_tick": {str(i): tr.idle_ms("serve.pack", [t])
                                 for i, t in enumerate(ticks)}})
    return out


def _names(tr, ranges) -> list:
    from benchmark.harness import spans

    return sorted({sp[0] for sp in tr.spans if spans.within(sp[1], ranges)})


def score_summary(tr, clips: int) -> dict:
    from benchmark.harness import spans

    out = spans.score_readings(tr, clips)
    if not out:
        return out
    whole = tr.ranges("bench.section")
    batches = tr.count("score.loader_wait", whole)
    busy = tr.busy_s * 1e3 / clips
    layers = sum(out[f"{k}_device_ms_per_clip.score"]
                 for k in ("frontend", "encoder", "backend"))
    out.update({
        "busy_ms_per_clip": busy,
        "attributed_share": layers / busy if busy else None,
        "readback_ms": tr.host_ms("score.readback", whole),
        "unattributed_device_ms_per_clip": tr.unattributed_ms(whole) / clips,
        "batches": batches,
        "spans_per_batch": len(tr.spans) / batches,
        "idle_ms_by_span": {name: tr.idle_ms(name, whole)
                            for name in _names(tr, whole)},
        "idle_ms": (tr.window_s - tr.busy_s) * 1e3})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from benchmark import run
    from benchmark.harness import runner, spans, trace

    kept = []

    def keep(fn):
        out, tr = spans.traced(fn)
        kept.append(tr)
        return out, tr

    trace.traced = keep
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or not kept:
        return rc or 1
    wl = runner.workload(args.workload)
    p = wl["params"]
    if wl["kind"] == "serve_paced":
        got = serve_summary(kept[-1])
    else:
        got = score_summary(kept[-1], min(int(p["trace_files"]),
                                          int(p["files"])))
    got.update(span_cost_us())
    print(json.dumps({"spans": got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

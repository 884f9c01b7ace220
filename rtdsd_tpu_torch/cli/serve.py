"""Multi-stream serving CLI of the port, with the flags of
``rtdsd_tpu.cli.serve``: audio files are served as concurrent live
streams (samples arrive hop by hop, interleaved across streams) and scored
by the fixed-shape ``MultiStreamScorer`` (``engine/serving.py``):

    python -m rtdsd_tpu_torch.cli.serve --config cfg.yaml --ckpt model.pt \\
        --audio a.wav b.wav ... [--window_sec 1 --hop_sec 0.5] \\
        [--max_streams 16] [--realtime] [--per_window] [--w8 | --w8a8] \\
        [--device cuda|cpu]

Output: per-window lines ``"{path}#{w} {t_start_sec:.2f} {score}"`` as
windows complete (with ``--per_window``), then one ``"{path} {score}"``
mean line per file. stderr reports the tick latency percentiles and the
throughput; with ``--realtime`` the feed is paced to the wall clock, so
they are end-to-end serving latencies.

``--ckpt`` is a reference-format ``.pt``, as in ``cli/main.py``.
``--artifact PREFIX`` serves from a ``cli.export --serving`` bundle instead
of ``--config``/``--ckpt``, with no model code: the geometry, the batches,
the transport and the models are baked into it, and the host's knobs (the
energy gate, the escalation band and center, the memory guard) stay
flags. The device defaults to ``cuda``; without a GPU the run raises
unless ``--device cpu`` is given. ``--shard`` (serving over several GPUs)
exits: the multi-GPU part of the port does not exist yet.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np

from rtdsd_tpu_torch.cli.common import load_eval_model
from rtdsd_tpu_torch.config import load_yaml_config
from rtdsd_tpu_torch.data.dataset import resample
from rtdsd_tpu_torch.data.io import load_audio
from rtdsd_tpu_torch.device import resolve_device
from rtdsd_tpu_torch.engine.serving import (MultiStreamScorer,
                                            dispatch_detail_keys)
from rtdsd_tpu_torch.utils.metrics import (calibration_threshold,
                                           load_calibration,
                                           load_cascade_calibration,
                                           platt_prob)


def add_engine_args(p):
    """Engine and model flags, shared with a network daemon."""
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--artifact", type=str, default=None,
                   help="serve from a cli.export --serving bundle (prefix) "
                        "instead of --config/--ckpt: no model code")
    p.add_argument("--window_sec", type=float, default=None,
                   help="window length (default: ExpConfig.test_duration_sec)")
    p.add_argument("--hop_sec", type=float, default=None,
                   help="hop between windows (default: window / 2)")
    p.add_argument("--max_streams", type=int, default=None,
                   help="stream-slot count (default: #files)")
    p.add_argument("--w8", action="store_true", default=False)
    p.add_argument("--w8a8", action="store_true", default=False)
    p.add_argument("--cascade_ckpt", type=str, default=None,
                   help="cascade: a cheap screener (e.g. a layer-pruned KD "
                        "student) scores every window; scores inside the "
                        "band are re-scored by --ckpt's model")
    p.add_argument("--cascade_config", type=str, default=None,
                   help="screener config (default: --config)")
    p.add_argument("--no_extend_fastpath", action="store_true",
                   default=False,
                   help="disable the zero-segment (dead-air) fastpath: "
                        "precomputed rows for exact-zero segments and the "
                        "extend ladder")
    p.add_argument("--extend_rungs", type=int, default=2,
                   help="halving rungs below the full extend shape the "
                        "fastpath may dispatch at (default 2 = half + "
                        "quarter)")
    p.add_argument("--score_rungs", type=int, default=0,
                   help="halving rungs below score_batch the window-score "
                        "dispatch may drop to when few loud windows are "
                        "due (opt-in)")
    p.add_argument("--esc_rungs", type=int, default=0,
                   help="halving rungs below esc_batch for the final "
                        "part-full escalation chunk (opt-in)")
    p.add_argument("--no_auto_provision", action="store_true",
                   default=False,
                   help="disable adaptive provisioning (the engine "
                        "deepening its rung ladders from observed "
                        "live-row EMAs)")
    p.add_argument("--esc_gather", type=str, default="slice",
                   choices=("slice", "flat"),
                   help="escalation window gather: 'slice' (slot rows, "
                        "then a contiguous slice per window, default) or "
                        "'flat' (per-sample gather)")
    p.add_argument("--cascade_w8a8", action="store_true", default=False,
                   help="quantize the screener's transformer stack (w8a8); "
                        "composes with --w8a8 (escalation flagship)")
    p.add_argument("--cascade_band", type=float, default=None,
                   help="escalation half-band (default 2.0)")
    p.add_argument("--cascade_center", type=float, default=None,
                   help="escalation band center (default 0.0)")
    p.add_argument("--cascade_calibration", type=str, default=None,
                   help="cascade band sidecar from 'cli.evaluate "
                        "--cascade-sweep --cascade-out': sets the "
                        "escalation band/center (explicit --cascade_band/"
                        "--cascade_center override it) and sizes the "
                        "escalation chunk from its dev escalation rate")
    p.add_argument("--score_batch", type=int, default=None,
                   help="cap the window-score batch below max_streams (the "
                        "memory escape hatch for large stream counts); each "
                        "tick then needs ceil(due/score_batch) dispatches")
    p.add_argument("--esc_batch", type=int, default=None,
                   help="cascade escalation chunk rows (default: ~1.25 x "
                        "the calibrated escalation rate x score_batch, "
                        "else score_batch/4)")
    p.add_argument("--extend_batch", type=int, default=None,
                   help="cap the conv-extend batch (default: full width "
                        "when the pre-flight memory estimate fits, else "
                        "follows --score_batch)")
    p.add_argument("--auto_batch", action="store_true", default=False,
                   help="when the pre-flight memory estimate exceeds the "
                        "device's, shrink the dispatch batches to fit "
                        "instead of raising")
    p.add_argument("--hbm_limit_gb", type=float, default=None,
                   help="override the pre-flight guard's device memory "
                        "(GiB); 0 disables the guard")
    p.add_argument("--shard", action="store_true", default=False,
                   help="serve over several GPUs (not ported yet: exits, "
                        "ROADMAP Queue 1 item 8)")
    p.add_argument("--device_ms", action="store_true", default=False,
                   help="after serving, time each dispatch shape on the "
                        "device and report device ms per tick")
    p.add_argument("--f32_transport", action="store_true", default=False,
                   help="push float32 samples to the device instead of "
                        "16-bit PCM")
    p.add_argument("--transport", default=None,
                   choices=("float32", "int16", "mulaw8"),
                   help="sample transport dtype (overrides --f32_transport; "
                        "mulaw8 = companded 8-bit, ~38 dB SNR)")
    p.add_argument("--gate_db", type=float, default=None,
                   help="energy gate: windows below this RMS dBFS "
                        "(re full scale 1.0; try -50) emit --gate_score "
                        "without a model dispatch")
    p.add_argument("--gate_score", type=float, default=0.0,
                   help="CM score emitted for energy-gated (silent) "
                        "windows (default 0.0 = undecided)")
    p.add_argument("--calibration", type=str, default=None,
                   help="calibration JSON from 'cli.evaluate --calibrate': "
                        "per-window lines gain calibrated P(bonafide), "
                        "aggregate lines an accept/reject decision at "
                        "--operating_point")
    p.add_argument("--operating_point", type=str, default="eer",
                   help="decision threshold from --calibration: 'eer', "
                        "'far=<rate>' or 'frr=<rate>'")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    add_engine_args(p)
    p.add_argument("--audio", required=True, nargs="+",
                   help="WAV/FLAC file(s); each is served as a live stream")
    p.add_argument("--realtime", action="store_true", default=False,
                   help="pace the feed to the wall clock (true serving "
                        "latency); default fast-forwards")
    p.add_argument("--per_window", action="store_true", default=False)
    p.add_argument("--out", type=str, default=None,
                   help="write '{path} {score}' aggregate lines here too")
    return p.parse_args(argv)


def snap_to_stride(n: int, stride: int, what: str) -> int:
    snapped = max(stride, (n // stride) * stride)
    if snapped != n:
        print(f"[serve] {what} snapped {n} -> {snapped} samples "
              f"(conv frame grid, stride {stride})", file=sys.stderr)
    return snapped


def _not_ported(args) -> None:
    if args.shard:
        raise SystemExit("--shard: serving over several GPUs is not ported "
                         "to rtdsd_tpu_torch yet (ROADMAP Queue 1 item 8); "
                         "serve on one device")


def _load_models(args, sys_config, exp_config, device):
    """(primary spec, flagship module or None) with build_engine's model
    prep: in a cascade the --cascade_ckpt screener is the primary and
    --ckpt's model the escalation flagship."""
    spec = load_eval_model(sys_config, exp_config, args.ckpt, device,
                           w8=args.w8, w8a8=args.w8a8)
    if not args.cascade_ckpt:
        return spec, None
    screen_sys, screen_exp = (load_yaml_config(args.cascade_config)
                              if args.cascade_config
                              else (sys_config, exp_config))
    screener = load_eval_model(screen_sys, screen_exp, args.cascade_ckpt,
                               device, w8a8=args.cascade_w8a8)
    return screener, spec.module


def build_engine(args, n_streams: int):
    """A warmed :class:`MultiStreamScorer` from the engine flags
    (``add_engine_args``) -> ``(engine, sample_rate_hz)``."""
    _not_ported(args)
    esc_rate = None  # the calibrated dev escalation rate
    if args.cascade_calibration:
        cal = load_cascade_calibration(args.cascade_calibration)
        # explicit flags win; the sidecar fills the rest
        if args.cascade_band is None:
            args.cascade_band = float(cal["band"])
        if args.cascade_center is None:
            args.cascade_center = float(cal["center"])
        rate = cal.get("escalation_rate")
        if rate is not None and math.isfinite(float(rate)):
            esc_rate = float(rate)
        print(f"[serve] cascade band {args.cascade_band} around "
              f"{args.cascade_center} from {args.cascade_calibration} "
              f"(dev escalation "
              f"{cal.get('escalation_rate', float('nan')) * 100:.1f}%, "
              f"cascade EER {cal.get('cascade_eer', float('nan')):.4f}%)",
              file=sys.stderr)
    args.cascade_esc_rate = esc_rate  # observability (daemon stats)
    if args.artifact:
        return _artifact_engine(args, esc_rate)
    if not args.config or not args.ckpt:
        raise SystemExit("--config and --ckpt are required "
                         "(or serve from a bundle with --artifact)")
    device = resolve_device(args.device)
    sys_config, exp_config = load_yaml_config(args.config)
    sr = float(exp_config.sample_rate)
    window_sec = (args.window_sec if args.window_sec is not None
                  else float(exp_config.test_duration_sec))
    hop_sec = args.hop_sec if args.hop_sec is not None else window_sec / 2
    if window_sec <= 0:
        raise SystemExit(f"--window_sec must be > 0 (got {window_sec})")
    if hop_sec <= 0:
        raise SystemExit(f"--hop_sec must be > 0 (got {hop_sec})")

    spec, flagship = _load_models(args, sys_config, exp_config, device)
    cfg = spec.module.w2v_cfg
    esc_kwargs = {}
    if flagship is not None:
        esc_kwargs = dict(escalate=flagship,
                          escalate_band=(2.0 if args.cascade_band is None
                                         else args.cascade_band),
                          escalate_center=(0.0 if args.cascade_center
                                           is None
                                           else args.cascade_center),
                          esc_batch=args.esc_batch, esc_rate=esc_rate,
                          esc_gather=args.esc_gather)
    duration = snap_to_stride(int(round(window_sec * sr)), cfg.total_stride,
                              "--window_sec")
    hop = snap_to_stride(int(round(hop_sec * sr)), cfg.total_stride,
                         "--hop_sec")
    eng = MultiStreamScorer(
        spec.module, cfg, duration=duration, hop=hop,
        max_streams=args.max_streams or n_streams,
        score_batch=args.score_batch, extend_batch=args.extend_batch,
        extend_fastpath=not args.no_extend_fastpath,
        extend_rungs=args.extend_rungs,
        score_rungs=args.score_rungs, esc_rungs=args.esc_rungs,
        auto_provision=not args.no_auto_provision,
        auto_batch=args.auto_batch,
        transport_dtype=(args.transport if args.transport else
                         "float32" if args.f32_transport else "int16"),
        hbm_limit=(None if args.hbm_limit_gb is None
                   else int(args.hbm_limit_gb * 2**30)),
        gate_rms_dbfs=args.gate_db, gate_score=args.gate_score,
        **esc_kwargs)
    eng.warmup()
    return eng, sr


def _artifact_engine(args, esc_rate):
    """build_engine's ``--artifact`` branch: the bundle's engine, with the
    flags baked into it at export refused."""
    from rtdsd_tpu_torch.cli.export import load_serving, read_serving_meta

    if args.config or args.ckpt:
        raise SystemExit("--artifact replaces --config/--ckpt (the bundle "
                         "carries the programs and weights)")
    baked = [flag for flag, val in (
        ("--window_sec", args.window_sec), ("--hop_sec", args.hop_sec),
        ("--score_batch", args.score_batch),
        ("--extend_batch", args.extend_batch),
        ("--esc_batch", args.esc_batch),
        ("--cascade_ckpt", args.cascade_ckpt),
        ("--transport", args.transport)) if val is not None]
    if args.w8 or args.w8a8 or args.cascade_w8a8 or args.auto_batch \
            or args.shard or args.f32_transport:
        baked.append("--w8/--w8a8/--cascade_w8a8/--auto_batch/--shard")
    if baked:
        raise SystemExit(
            f"{', '.join(baked)} are baked into the serving artifact at "
            f"export time (cli.export --serving); re-export to change them")
    if esc_rate is not None:
        print(f"[serve] --artifact: the escalation chunk was sized at "
              f"export; the calibration's escalation rate "
              f"({esc_rate * 100:.1f}%) is not applied (only its band and "
              f"center are)", file=sys.stderr)
    max_streams = read_serving_meta(args.artifact)["max_streams"]
    if args.max_streams is not None and args.max_streams != max_streams:
        raise SystemExit(
            f"--max_streams {args.max_streams} != the artifact's slot "
            f"count {max_streams}; re-export to change it (or drop the "
            f"flag / pass the baked value)")
    eng, meta = load_serving(
        args.artifact, device=args.device,
        hbm_limit=(None if args.hbm_limit_gb is None
                   else int(args.hbm_limit_gb * 2**30)),
        gate_rms_dbfs=args.gate_db, gate_score=args.gate_score,
        escalate_band=args.cascade_band,
        escalate_center=args.cascade_center,
        extend_fastpath=not args.no_extend_fastpath)
    eng.warmup()
    return eng, float(meta["sample_rate"])


def reload_params(args):
    """Read the checkpoint(s) again with build_engine's model prep (the
    same quantization flags; in a cascade --cascade_ckpt is the primary
    and --ckpt the flagship) -> ``(state_dict, escalate_state_dict or
    None)`` for :meth:`MultiStreamScorer.swap_model`, on the serving
    device. In ``--artifact`` mode the bundle's weight sidecars are read
    again (overwrite them with a re-export's, then reload)."""
    _not_ported(args)
    if args.artifact:
        from rtdsd_tpu_torch.cli.export import (load_serving_params,
                                                read_serving_meta)

        return load_serving_params(args.artifact,
                                   read_serving_meta(args.artifact),
                                   resolve_device(args.device))
    spec, flagship = _load_models(args, *load_yaml_config(args.config),
                                  resolve_device(args.device))
    esc = None if flagship is None else flagship.state_dict()
    return spec.module.state_dict(), esc


def main(argv=None):
    args = parse_args(argv)

    n_streams = len(args.audio)
    cal = thr = None
    if args.calibration:  # fail on a bad file before building the engine
        cal = load_calibration(args.calibration)
        thr = calibration_threshold(cal, args.operating_point)
    eng, sr = build_engine(args, n_streams)
    hop = eng.hop

    waves = []
    for path in args.audio:
        wave, rate = load_audio(path)
        if rate != int(sr):
            wave = resample(wave, rate, int(sr))
        waves.append(np.asarray(wave, np.float32).squeeze())

    # stream ids are (occurrence index, path), so duplicate --audio paths
    # stay distinct streams with their own windows and aggregates
    files = list(enumerate(args.audio))
    handles = {eng.open_stream((i, p)): i
               for i, p in files[:eng.max_streams]}
    if len(args.audio) > eng.max_streams:
        print(f"[serve] {len(args.audio)} files > {eng.max_streams} slots; "
              f"remaining files start as slots free", file=sys.stderr)
    queue = files[eng.max_streams:]
    cursors = {h: 0 for h in handles}

    per_file = [[] for _ in args.audio]
    tick_ms = []
    total_windows = 0
    total_audio = sum(len(w) for w in waves) / sr
    t_start = time.perf_counter()
    tick = 0
    # --device_ms attributes only the paced loop's dispatches to ticks
    counts0 = dict(eng.dispatch_counts)
    pending_lines = []  # --per_window lines, printed outside the timed tick

    def take(ws):
        nonlocal total_windows
        total_windows += 1
        idx, path = ws.stream_id
        per_file[idx].append(ws)
        if args.per_window:
            # a flush-time tail window starts off the hop grid
            w_idx = (ws.start_sample // hop
                     if ws.start_sample % hop == 0 else "tail")
            mark = " gated" if ws.gated else \
                   " escalated" if ws.escalated else ""
            prob = f" p={platt_prob(ws.score, cal):.4f}" if cal else ""
            pending_lines.append(
                f"{path}#{w_idx} {ws.start_sample / sr:.2f} "
                f"{ws.score}{prob}{mark}")

    def flush_lines():
        if pending_lines:
            print("\n".join(pending_lines))
            pending_lines.clear()

    # with a capped score or extend batch each tick needs several
    # dispatches to clear the due backlog: drain it
    capped = (eng.score_batch < eng.max_streams
              or eng.extend_batch < eng.max_streams)
    tick_poll = eng.drain if capped else eng.poll

    while handles or queue:
        t0 = time.perf_counter()
        done = []
        for h, i in handles.items():
            w = waves[i]
            c = cursors[h]
            if c < len(w):
                eng.push(h, w[c:c + hop])
                cursors[h] = c + hop
            if cursors[h] >= len(w):
                done.append(h)
        for ws in tick_poll():
            take(ws)
        for h in done:
            eng.close_stream(h, flush=True)
            del handles[h], cursors[h]
        # closed slots free once drained; admit queued files
        while queue and eng.active_streams < eng.max_streams:
            try:
                h = eng.open_stream(queue[0])
            except RuntimeError:
                break  # closing streams still draining
            handles[h] = queue.pop(0)[0]
            cursors[h] = 0
        if not handles and eng.active_streams:
            for ws in eng.poll():
                take(ws)
        dt = time.perf_counter() - t0
        tick_ms.append(dt * 1000)
        flush_lines()
        if args.realtime and dt < hop / sr:
            time.sleep(hop / sr - dt)
        tick += 1
    counts_loop = dict(eng.dispatch_counts)  # before drain's extra polls
    for ws in eng.drain():
        take(ws)
    flush_lines()

    wall = time.perf_counter() - t_start
    out_fh = open(args.out, "w") if args.out else None
    try:
        for i, path in files:
            scores = [w.score for w in per_file[i]]
            agg = float(np.mean(scores)) if scores else float("nan")
            extra = ""
            if cal and np.isfinite(agg):
                verdict = "accept" if agg >= thr else "reject"
                extra = (f" p={platt_prob(agg, cal):.4f} "
                         f"{verdict}@{args.operating_point}")
            print(f"{path} {agg}{extra}")
            if out_fh:  # --out stays raw '{path} {score}'
                out_fh.write(f"{path} {agg}\n")
    finally:
        if out_fh:
            out_fh.close()
    tick_ms = np.asarray(tick_ms)
    mode = "realtime" if args.realtime else "fast-forward"
    print(f"  [{n_streams} streams, {total_windows} windows, "
          f"{total_audio:.1f}s audio in {wall:.2f}s ({mode}); "
          f"tick p50 {np.percentile(tick_ms, 50):.1f} ms / "
          f"p95 {np.percentile(tick_ms, 95):.1f} ms vs "
          f"{hop / sr * 1000:.0f} ms hop budget]", file=sys.stderr)
    if args.cascade_ckpt:
        n_esc = sum(w.escalated for ws_list in per_file for w in ws_list)
        print(f"  [cascade: {n_esc}/{total_windows} windows escalated "
              f"(band {eng.escalate_band} around {eng.escalate_center})]",
              file=sys.stderr)
    if args.gate_db is not None:
        print(f"  [energy gate: {eng.gated_windows}/{total_windows} "
              f"windows below {args.gate_db} dBFS scored as "
              f"{args.gate_score} with no model dispatch]",
              file=sys.stderr)
    if args.device_ms and tick:
        costs = eng.device_costs()
        per_tick = {k: (counts_loop[k] - counts0.get(k, 0)) / tick
                    for k in counts_loop}
        dev = sum(costs.get(k, 0.0) * per_tick[k] for k in per_tick)
        detail = " ".join(f"{k}:{costs.get(k, 0.0):.2f}ms x{per_tick[k]:.2f}"
                          for k in dispatch_detail_keys(per_tick)
                          if per_tick.get(k))
        print(f"  [device {dev:.1f} ms/tick ({detail}) vs "
              f"{hop / sr * 1000:.0f} ms hop budget]", file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])

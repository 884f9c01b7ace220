"""Network serving daemon of the port, with the flags of
``rtdsd_tpu.cli.daemon``: a long-running process that owns the serving
engine and takes concurrent live PCM streams from external producers over
a Unix or TCP socket, answering with per-window CM scores as they are
computed. Protocol and threading: ``rtdsd_tpu_torch/engine/netserve.py``.

    python -m rtdsd_tpu_torch.cli.daemon --config cfg.yaml --ckpt model.pt \\
        --max_streams 256 --listen unix:/run/rtdsd.sock [--device cpu]
    python -m rtdsd_tpu_torch.cli.daemon ... --listen 0.0.0.0:7750

All of ``cli/serve.py``'s engine flags apply (--window_sec/--hop_sec,
--w8a8, --cascade_ckpt, --score_batch/--auto_batch, --transport, --device,
...). --max_streams is required: a daemon has no file list to infer the
slot count from. The device defaults to ``cuda``; without a GPU the daemon
raises unless ``--device cpu`` is given.

Signals: SIGINT and SIGTERM stop the daemon; SIGHUP reads --ckpt (and
--cascade_ckpt) again and swaps the weights in between ticks.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys

from rtdsd_tpu_torch.cli.serve import add_engine_args, build_engine, \
    reload_params
from rtdsd_tpu_torch.engine.netserve import ServeDaemon
from rtdsd_tpu_torch.utils.metrics import load_calibration, platt_prob


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    add_engine_args(p)
    p.add_argument("--listen", required=True, type=str,
                   help="unix:/path/to.sock or host:port")
    p.add_argument("--tick_sec", type=float, default=None,
                   help="poll cadence (default: the hop interval; every "
                        "poll pads a fixed-shape batch, so do not set it "
                        "far below the hop)")
    p.add_argument("--max_pending_sec", type=float, default=30.0,
                   help="shed a stream once this many seconds of its audio "
                        "are buffered but unscored (producer outrunning "
                        "the engine); 0 disables")
    p.add_argument("--idle_timeout_sec", type=float, default=0.0,
                   help="shed a stream with no PUSH for this long (its "
                        "connection stays up; re-OPEN resumes); 0 disables "
                        "(default)")
    p.add_argument("--stats_every", type=float, default=60.0,
                   help="stderr stats interval in seconds (0 = off)")
    args = p.parse_args(argv)
    if not args.max_streams:
        p.error("--max_streams is required for the daemon (fixed dispatch "
                "shapes; no file list to infer it from)")
    return args


async def _amain(args):
    transform = None
    if args.calibration:
        cal = load_calibration(args.calibration)
        transform = lambda s: platt_prob(s, cal)  # noqa: E731
        print(f"[daemon] calibrated wire scores: "
              f"P(bonafide)=sigmoid({cal['platt_a']:.4g}*s"
              f"{cal['platt_b']:+.4g}) from {args.calibration}",
              file=sys.stderr, flush=True)
    eng, sr = build_engine(args, args.max_streams)
    daemon = ServeDaemon(eng, int(sr), tick_sec=args.tick_sec,
                         max_pending_sec=args.max_pending_sec,
                         idle_timeout_sec=args.idle_timeout_sec,
                         score_transform=transform)

    # handlers before the socket exists: a supervisor that TERMs as soon as
    # it sees the socket must not find the default disposition
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)

    # SIGHUP: zero-downtime checkpoint reload. Reads --ckpt (and
    # --cascade_ckpt) from disk again; same-architecture checkpoints swap
    # in between ticks with no dropped stream. A failed load (missing
    # file, other architecture) is logged and the old weights keep serving.
    # The reload holds a second copy of the models on the device until the
    # swap has copied it in.
    reload_tasks = set()

    def _schedule_reload():
        if reload_tasks:
            print("[daemon] reload already in progress; ignoring SIGHUP",
                  file=sys.stderr, flush=True)
            return

        async def do():
            try:
                sd, esc = await loop.run_in_executor(None, reload_params,
                                                     args)
                await daemon.swap_model(sd, escalate=esc)
                del sd, esc
                src = f"checkpoint {args.ckpt}" + (
                    f" + cascade screener {args.cascade_ckpt}"
                    if args.cascade_ckpt else "")
                print(f"[daemon] reloaded {src} (swap #{daemon.reloads})",
                      file=sys.stderr, flush=True)
            except Exception as e:  # noqa: BLE001: keep serving
                print(f"[daemon] reload FAILED, serving continues on the "
                      f"previous weights: {e}", file=sys.stderr, flush=True)

        task = asyncio.ensure_future(do())
        reload_tasks.add(task)
        task.add_done_callback(reload_tasks.discard)

    loop.add_signal_handler(signal.SIGHUP, _schedule_reload)

    if args.listen.startswith("unix:"):
        path = args.listen[len("unix:"):]
        if os.path.exists(path):
            os.unlink(path)  # stale socket of an earlier run
        await daemon.start(unix_path=path)
        where = f"unix:{path}"
    else:
        host, _, port = args.listen.rpartition(":")
        if not host or not port.isdigit():
            raise SystemExit(f"--listen must be unix:/path or host:port, "
                             f"got {args.listen!r}")
        await daemon.start(host=host, port=int(port))
        where = f"{host}:{port}"
    print(f"[daemon] serving on {where} - {eng.max_streams} slots, "
          f"window {eng.duration / sr:.2f}s hop {eng.hop / sr:.2f}s, "
          f"transport {eng._tdtype.__name__}, device {eng.device}, "
          f"~{eng.hbm_estimate / 2**30:.2f} GiB device memory estimated",
          file=sys.stderr, flush=True)

    async def stats():
        while args.stats_every > 0:
            await asyncio.sleep(args.stats_every)
            print(f"[daemon] streams={eng.active_streams}/"
                  f"{eng.max_streams} ticks={daemon.ticks} "
                  f"scores={daemon.scores_sent} "
                  f"overruns={daemon.overruns} "
                  f"idle_sheds={daemon.idle_sheds} "
                  f"reloads={daemon.reloads} "
                  f"gated={eng.gated_windows} "
                  f"zero_segs={eng.zero_segments} "
                  f"dispatches={dict(eng.dispatch_counts)} "
                  f"provisioning={eng.provisioning()}",
                  file=sys.stderr, flush=True)

    stats_task = asyncio.ensure_future(stats())
    await stop.wait()
    stats_task.cancel()
    for task in list(reload_tasks):
        task.cancel()
    await daemon.stop()
    print("[daemon] stopped", file=sys.stderr, flush=True)


def main(argv=None):
    asyncio.run(_amain(parse_args(argv)))


if __name__ == "__main__":
    main(sys.argv[1:])

"""Sweep a serving cell's traffic over stream counts, to find its knee.

    python3 benchmark/sweep.py --workload aasist_serve_paced \
        --streams 512 640 768 --seconds 15 --seed 7

For each stream count it runs the cell's traffic (the cell's own
parameters, ``streams`` replaced) in this process for ``--seconds`` and
prints the tick's p50 / p95 (push and poll), the window latency's p95,
how late the last tick and the latest tick started (a backlog grows
where these rise through the run), and whether the answers compared
correct. The knee is the largest count whose tick p95 stays under the hop
with no growing backlog.
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import runner

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    wl = runner.workload(args.workload)
    cfg = runner.config(wl["config"])
    print(f"{torch.cuda.get_device_name(0)}; {args.workload}; "
          f"{args.seconds} s a count", flush=True)
    for s in args.streams:
        wl_s = dict(wl, params=dict(wl["params"], streams=s))
        ctx = runner.Context(cell=args.workload, workload=wl_s, config=cfg,
                             seed=args.seed, seconds=args.seconds,
                             trace=False, device=torch.device("cuda", 0),
                             t_start=time.perf_counter())
        torch.cuda.reset_peak_memory_stats()
        try:
            out = runner.traffic(wl["kind"]).run(ctx)
        except (ValueError, RuntimeError) as e:
            print(f"streams {s}: refused: {e}", flush=True)
            continue
        r = out.readings
        ok = all(v <= lim for v, lim in out.checks.values())
        print(f"streams {s}: tick p50 {r['tick_p50_ms']:.2f} ms p95 "
              f"{r['tick_p95_ms']:.2f} ms; window p95 "
              f"{out.end_to_end['window_p95_ms']:.2f} ms; late last "
              f"{r['late_ms_last']:.1f} ms max {r['late_ms_max']:.1f} ms; "
              f"failed {out.failed}/{out.attempted}; peak "
              f"{out.memory_peak_bytes / 2**30:.2f} GiB; set-up "
              f"{out.setup_s:.1f} s; correct {ok}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's limits are set from: sound runs of the
program, its controls, and faults planted under the timed path.

    python3 benchmark/control.py --workload aasist_serve_paced \
        --seeds 1 2 ... 12 --control-seeds 13 14 15 [--seconds 4]

In one process (set-up paid once), for each of ``--seeds`` it runs the
cell as ``run.py`` does, with a window of ``--seconds``, and prints the
numbers compared beside their limits. For each of ``--control-seeds`` it
then reads each of ``--runs``' other kinds: ``w8a8``, the program with its
own int8 path on (the control that the configuration's precision names);
``fp8``, the reference computed in fp8 in the program's place (answers'
gaps only); ``half_batch`` and ``altered``, the faults of
``harness/faults.py``. Each of those has to come out not correct on every
seed. The benchmark's runs do not run this.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KINDS = ("w8a8", "fp8", "half_batch", "altered")


def reading(runner, wl: dict, kind: str, seed: int, seconds: float,
            device) -> dict:
    """{number: (value, limit)} of one run of ``kind`` with ``seed``."""
    ctx = runner.Context(cell=wl["name"], workload=wl,
                         config=runner.config(wl["config"]), seed=seed,
                         seconds=seconds, trace=False, device=device,
                         fault=kind if kind in ("half_batch", "altered")
                         else None, w8a8=kind == "w8a8",
                         t_start=time.perf_counter())
    traffic = runner.traffic(wl["kind"])
    if kind == "fp8":
        gaps = traffic.fp8_gaps(ctx)
        return {k: (v, float(wl["limits"][k])) for k, v in gaps.items()}
    return traffic.run(ctx).checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--runs", nargs="+", default=list(KINDS),
                    choices=KINDS)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import runner

    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    wl = runner.workload(args.workload)
    plan = [("sound", s) for s in args.seeds] + [
        (k, s) for k in args.runs for s in args.control_seeds]
    caught = {k: True for k in args.runs}
    for kind, seed in plan:
        checks = reading(runner, wl, kind, seed, args.seconds, dev)
        correct = all(v <= lim for v, lim in checks.values())
        if kind != "sound":
            caught[kind] &= not correct
        print("reading " + json.dumps(
            {"cell": args.workload, "kind": kind, "seed": seed,
             "correct": correct,
             "numbers": {k: v for k, (v, _) in checks.items()},
             "limits": {k: lim for k, (_, lim) in checks.items()}}),
            flush=True)
    for kind in args.runs if args.control_seeds else ():
        print(f"{args.workload} {kind}: " + (
            "not correct on every seed" if caught[kind]
            else "CORRECT ON SOME SEED: the limits do not catch it"),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

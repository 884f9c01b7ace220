"""Run one benchmark cell of the PyTorch and CUDA port on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell (inputs and weights from the seed, warm-up), measures
for ``--seconds`` seconds, checks the answers of the timed path against
the plain reference, and prints one JSON object as the last line of
standard output: with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a traced section. The
numbers compared, each beside its limit, are the last lines of standard
error and the last key of the result.

Exits non-zero, printing no result, when there is no CUDA device or fewer
than the cell asks for, when the program is not beside the benchmark, and
when JAX or the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "bench_cache")
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, ROOT)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, out) -> dict:
    """The card, and the program's peak memory, read before the reference
    ran."""
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": out.memory_peak_bytes}
    if out.trace is not None:
        info["busy_s"] = out.trace.busy_s
        info["window_s"] = out.trace.window_s
    return info


def main(argv=None) -> int:
    args = parse(argv)
    if importlib.util.find_spec("rtdsd_tpu_torch") is None:
        print("the program under test (rtdsd_tpu_torch) is not beside the "
              "benchmark; nothing to run", file=sys.stderr)
        return 2
    from benchmark.harness import runner

    man = runner.manifest()
    if args.workload not in [w["name"] for w in man["workloads"]]:
        print(f"{args.workload!r} is not a cell of BENCHMARK.json",
              file=sys.stderr)
        return 2
    wl = runner.workload(args.workload)

    import torch

    chips = int(wl["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f"; no CPU fall-back", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    ctx = runner.Context(cell=args.workload, workload=wl,
                         config=runner.config(wl["config"]), seed=args.seed,
                         seconds=args.seconds, trace=bool(args.trace),
                         device=torch.device("cuda", 0), t_start=T_START)
    out = runner.traffic(wl["kind"]).run(ctx)
    bad = runner.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 4
    line = runner.result_line(man, args.workload, ctx, out,
                              device_info(torch, out))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

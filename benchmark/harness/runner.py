"""Finding a cell's parts by name and assembling its result line.

Everything that belongs to one configuration, traffic kind or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` and the
cell's file give it:

- ``benchmark/workloads/<cell>.json``: the configuration, the traffic
  kind and its parameters, and the limits of the comparison;
- ``benchmark/configs/<config>.json``: the model's sizes, how the
  program builds it, and its ``family``;
- ``benchmark/traffic/<kind>.py``: ``run(ctx) -> Outcome``;
- ``benchmark/metrics/<metric>.py``: ``read(readings) -> float | None``;
- a family's three parts (:class:`Family`): ``benchmark/reference/
  <family>.py``, the plain float32 reference; ``benchmark/counts/
  <family>.py``, its operations and its kernels' operations and bytes;
  ``benchmark/programs/<family>.py``, the adapter to the program.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rtdsd_tpu")
FAMILY_PARTS = ("reference", "counts", "programs")


@dataclasses.dataclass(frozen=True)
class Family:
    """What the shared code knows of a model family, each part a module
    found by the family's name:

    - ``reference``: ``ModelShape(cfg)`` (its ``conv``: the front-end's
      (channels, kernel, stride) a layer), ``param_shapes(shape)``,
      ``bonafide_scores(p, shape, waves, block, precision)``;
    - ``counts``: ``forward_flops(cfg, samples)``, ``num_frames(cfg,
      samples)``, ``kernels(cfg, rows, frames)``;
    - ``program``: ``program_kwargs(cfg, w8a8)``, ``encoder_depth(model)``,
      ``stages(model)``, ``census_modules(model)``, ``serving_engine(model,
      **kw)``, ``kernels()``.
    """
    name: str
    reference: object
    counts: object
    program: object


def family(cfg: dict) -> Family:
    """The parts of the family a configuration file names."""
    name = cfg["family"]
    parts = []
    for part in FAMILY_PARTS:
        path = os.path.join(BENCH, part, name + ".py")
        if not os.path.exists(path):
            raise SystemExit(f"family {name!r} has no {part} ({path} is "
                             f"missing)")
        parts.append(importlib.import_module(f"benchmark.{part}.{name}"))
    return Family(name, *parts)


@dataclasses.dataclass
class Context:
    """What a traffic kind's ``run`` is given."""
    cell: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object                  # torch.device
    fault: Optional[str] = None     # a planted fault (harness/faults.py)
    w8a8: bool = False              # the program's own int8 path: the control
    t_start: float = 0.0            # perf_counter at process start

    @property
    def family(self) -> Family:
        return family(self.config)


@dataclasses.dataclass
class Outcome:
    """What a traffic kind's ``run`` returns."""
    setup_s: float
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    readings: dict                          # for the per-layer readers
    checks: Dict[str, tuple]                # name -> (value, limit)
    memory_peak_bytes: int
    trace: object = None                    # harness.trace.Trace


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(name: str) -> dict:
    path = os.path.join(BENCH, "workloads", name + ".json")
    if not os.path.exists(path):
        raise SystemExit(f"no cell named {name!r} ({path} is missing)")
    return load_json(path)


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH, "configs", name + ".json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(kind: str):
    return _module(os.path.join(BENCH, "traffic", kind + ".py"),
                   f"bench_traffic_{kind}")


def reader(metric: str):
    return _module(os.path.join(BENCH, "metrics", metric + ".py"),
                   "bench_metric_" + metric.replace(".", "_"))


def reports(metric: dict, cell: str, man: dict) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    key lists; without the key, every cell that reports the end-to-end
    metric it moves (every cell, for an end-to-end metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = next(m for m in man["end_to_end"] if m["name"] == moves)
    return reports(e2e, cell, man)


def cell_metrics(man: dict, cell: str, per_layer: bool) -> List[dict]:
    group = man["per_layer" if per_layer else "end_to_end"]
    return [m for m in group if reports(m, cell, man)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``rtdsd_tpu_torch`` is not ``rtdsd_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(man: dict, cell: str, ctx: Context, out: Outcome,
                device: dict) -> dict:
    """The result object: ``checks`` comes last."""
    metrics = {}
    for m in cell_metrics(man, cell, ctx.trace):
        if ctx.trace:
            value = reader(m["name"]).read(out.readings)
        elif m["name"] == "setup_s":
            value = out.setup_s
        else:
            value = out.end_to_end.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    correct = all(v <= lim for v, lim in out.checks.values())
    line = {"correct": bool(correct and out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if ctx.trace and out.trace is not None:
        line["breakdown"] = {"device_ops": out.trace.top_ops(10),
                             "idle_gaps": out.trace.idle_gaps(10)}
    line["checks"] = {k: {"value": float(v), "limit": float(lim)}
                      for k, (v, lim) in out.checks.items()}
    return line

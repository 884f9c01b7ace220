"""Batch scoring of a track of WAV files through the scoring CLI's path.

Set-up writes ``files`` 16 kHz 16-bit WAV files into a fresh directory
under ``TMPDIR``: their lengths are a fixed, evenly spaced set from
``min_s`` to ``max_s`` seconds in an order drawn from the seed, so the
loader both tiles the short ones and cuts the long ones, and every seed
decodes the same amount of audio. The window calls
``rtdsd_tpu_torch/cli/common.py::score_dataset`` (``EvalLoader``, the
native decoder on ``threads`` threads, first-N crops of ``duration_s``,
then ``make_score_step``) over the whole track at ``batch``, again and
again until ``--seconds`` have passed. Every answer of every call is held
to the reference's score of its file, tiled and cut as the reference repo
evaluates, and one batch of the window's first call, drawn from the seed,
to the census of narrow operations.

End-to-end: ``card_ms_per_clip``, the card's busy milliseconds a clip
in a traced call over the first ``trace_files`` files, made after the
window in every run. Per-layer (``--trace 1``): the clips scored over the
window's whole time, the loader alone over the files, the front-end,
encoder and back-end alone on one batch (CUDA events), and that traced
call's kernels, operations and idle time.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import audio, card, cell, faults, trace
from benchmark.harness.census import Census
from benchmark.harness.runner import Outcome


def _lengths(p: dict, rng: np.random.Generator) -> np.ndarray:
    lo, hi = int(p["min_s"] * audio.SR), int(p["max_s"] * audio.SR)
    return rng.permutation(np.linspace(lo, hi, int(p["files"])).astype(int))


def _reference_waves(paths, duration: int) -> torch.Tensor:
    return torch.stack([audio.fit_duration(audio.read_wav(f), duration)
                        for f in paths])


def _dataset(paths, duration: int):
    from rtdsd_tpu_torch.data.dataset import AudioDataset
    from rtdsd_tpu_torch.data.protocols import Trial

    trials = [Trial(path=f, utt_id=os.path.basename(f)[:-4], label=0)
              for f in paths]
    return AudioDataset(trials, duration, is_random_start=False,
                        sample_rate=audio.SR)


def _score(ds, model, p, device):
    from rtdsd_tpu_torch.cli.common import score_dataset

    return score_dataset(ds, SimpleNamespace(module=model), int(p["batch"]),
                         device, num_workers=int(p["threads"]))


def _event_ms(fn, reps: int = 5) -> float:
    """Device ms of one call of ``fn``, by CUDA events over ``reps`` calls
    after one warm-up call."""
    with torch.inference_mode():
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / reps


def _per_layer(ctx, model, ds, p, readings):
    """The per-layer readings of a traced run, after the window; returns
    ``_traced_call``'s trace and clips."""
    from rtdsd_tpu_torch.data.loader import EvalLoader

    fam = ctx.family
    b = int(p["batch"])
    loader = EvalLoader(ds, b, num_workers=int(p["threads"]),
                        use_native=True)
    took, first = [], None
    t = time.perf_counter()
    for batch in loader:
        now = time.perf_counter()
        took.append(now - t)
        first = batch if first is None else first
        t = time.perf_counter()
    readings["decode_ms_per_batch"] = 1e3 * float(np.mean(took))
    if ctx.device.type == "cuda":
        frontend, encoder, backend = fam.program.stages(model)
        waves = torch.from_numpy(first.waves).to(ctx.device)
        with torch.inference_mode():
            conv = frontend(waves)
            feats = encoder(conv)
        readings["frontend_ms_per_clip"] = _event_ms(
            lambda: frontend(waves)) / b
        readings["encoder_ms_per_clip"] = _event_ms(
            lambda: encoder(conv)) / b
        readings["backend_ms_per_clip"] = _event_ms(
            lambda: backend(feats)) / b
    launches = fam.program.kernels()
    tr, n = _traced_call(ctx, model, ds, p)
    readings.update(cell.kernel_readings(
        ctx, launches, tr, b, fam.counts.num_frames(ctx.config, ds.duration)))
    readings["idle_busy_s"], readings["idle_span_s"] = tr.busy_s, tr.window_s
    readings["card_flops"] = n * fam.counts.forward_flops(ctx.config,
                                                          ds.duration)
    readings["card_busy_s"] = tr.busy_s
    return tr, n


def _traced_call(ctx, model, ds, p):
    """(the trace of one ``score_dataset`` call over the first
    ``trace_files`` files, the clips it scored)."""
    sub = _dataset([t.path for t in ds.trials[:int(p["trace_files"])]],
                   ds.duration)

    def call():
        with torch.profiler.record_function("bench.score_dataset"):
            return _score(sub, model, p, ctx.device)

    _, tr = trace.traced(call)
    return tr, len(sub.trials)


def run(ctx) -> Outcome:
    p = ctx.workload["params"]
    rng = np.random.default_rng(ctx.seed)
    duration = int(p["duration_s"] * audio.SR)
    phases = cell.Phases(ctx.t_start)
    tmp = tempfile.mkdtemp(prefix="bench_score_")
    try:
        paths = audio.write_track(tmp, rng, _lengths(p, rng), ctx.device)
        counted = int(rng.integers(-(-len(paths) // int(p["batch"]))))
        ds = _dataset(paths, duration)
        expected = [t.utt_id for t in ds.trials]
        phases.mark("files written")
        weights, model = cell.setup_model(ctx)
        census = Census(ctx.family.program.census_modules(model))
        phases.mark("weights and model")
        with faults.planted(ctx.fault):
            _score(_dataset(paths[:2 * int(p["batch"])], duration), model, p,
                   ctx.device)                           # warm-up
            cell.sync(ctx.device)
            setup_s = phases.mark("warm-up")
            calls = []
            census.observe_call(counted)
            t0 = time.perf_counter()
            while True:
                names, scores = _score(ds, model, p, ctx.device)
                calls.append(scores if names == expected else [])
                if time.perf_counter() - t0 >= ctx.seconds:
                    break
            window = time.perf_counter() - t0
            census.remove()
            clips = sum(len(c) for c in calls)
            counts = ctx.family.counts
            readings = {"model_flops": clips * counts.forward_flops(
                            ctx.config, duration),
                        "mfu_seconds": window,
                        "peak_flops": card.PEAK_FLOPS[
                            ctx.config["program"]["compute_dtype"]],
                        "clips_per_s": clips / window}
            tr, traced = (_per_layer(ctx, model, ds, p, readings)
                          if ctx.trace else _traced_call(ctx, model, ds, p))
        peak = cell.peak_bytes(ctx.device)
        del model
        cell.free(ctx.device)
        got = np.concatenate([np.asarray(c, np.float64) for c in calls])
        index = np.tile(np.arange(len(paths)), len(calls))
        failed = sum(len(paths) - len(c) for c in calls)
        if failed:
            got = np.full(len(index), np.nan)
        checks = cell.reference_checks(ctx, weights,
                                       _reference_waves(paths, duration),
                                       got, index, census)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # no device operation in the trace (a CPU run): no card time to give
    e2e = ({"card_ms_per_clip": 1e3 * tr.busy_s / traced} if tr.busy_s
           else {})
    return Outcome(setup_s=setup_s, attempted=len(index), failed=failed,
                   end_to_end=e2e, readings=readings, checks=checks,
                   memory_peak_bytes=peak, trace=tr if ctx.trace else None)


def fp8_gaps(ctx) -> dict:
    """The answers' gaps of the reference computed in fp8 in the program's
    place, on the files a run with this seed scores."""
    p = ctx.workload["params"]
    rng = np.random.default_rng(ctx.seed)
    duration = int(p["duration_s"] * audio.SR)
    tmp = tempfile.mkdtemp(prefix="bench_control_")
    try:
        paths = audio.write_track(tmp, rng, _lengths(p, rng), ctx.device)
        waves = _reference_waves(paths, duration)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    from benchmark.harness.weights import model_weights

    weights = model_weights(ctx.config, ctx.seed, ctx.device)
    got = cell.reference_scores(ctx, weights, waves, precision="fp8")
    return cell.reference_gaps(ctx, weights, waves, got,
                               np.arange(len(paths)))

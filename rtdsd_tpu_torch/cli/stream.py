"""Streaming / long-audio scoring CLI of the port, with the flags of
``rtdsd_tpu.cli.stream``:

    python -m rtdsd_tpu_torch.cli.stream --config cfg.yaml --ckpt model.pt \\
        --audio long1.wav long2.flac --window_sec 4 --hop_sec 2 \\
        [--aggregate mean|min|max|median] [--per_window] [--out scores.txt] \\
        [--w8 | --w8a8] [--calibration cal.json [--operating_point eer]] \\
        [--incremental] [--device cuda|cpu]

Fixed windows slide over audio files of any length (resampled to the
config's sample rate); each file gets one ``"{path} {score}"`` line
(score = the aggregated bonafide logit), and with ``--per_window`` one
``"{path}#{window_idx} {t_start_sec:.2f} {score}"`` line per window.
``--calibration`` adds ``p=`` (calibrated P(bonafide)) to every line and an
accept/reject decision at ``--operating_point`` to the file's line.
``--incremental`` computes the conv front-end once per file and snaps
window starts to the 20 ms frame grid (``engine/streaming.py``). A line
``[N windows over S s in W s -> xRT X]`` per file goes to stderr.

``--ckpt`` is a reference-format ``.pt``, as in ``cli/main.py``. The
device defaults to ``cuda``; without a GPU the run raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from rtdsd_tpu_torch.cli.common import load_eval_model
from rtdsd_tpu_torch.config import load_yaml_config
from rtdsd_tpu_torch.data.dataset import resample
from rtdsd_tpu_torch.data.io import load_audio
from rtdsd_tpu_torch.device import resolve_device
from rtdsd_tpu_torch.engine.steps import make_score_step
from rtdsd_tpu_torch.engine.streaming import (IncrementalStreamingScorer,
                                              StreamingScorer)
from rtdsd_tpu_torch.utils.metrics import (calibration_threshold,
                                           load_calibration, platt_prob)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, type=str)
    p.add_argument("--ckpt", required=True, type=str)
    p.add_argument("--audio", required=True, nargs="+",
                   help="WAV/FLAC file(s) of any length")
    p.add_argument("--window_sec", type=float, default=None,
                   help="window length (default: ExpConfig.test_duration_sec)")
    p.add_argument("--hop_sec", type=float, default=None,
                   help="hop between windows (default: window / 2)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--aggregate", default="mean",
                   choices=["mean", "min", "max", "median"])
    p.add_argument("--per_window", action="store_true", default=False)
    p.add_argument("--out", type=str, default=None,
                   help="write '{path} {score}' lines here as well")
    p.add_argument("--w8", action="store_true", default=False)
    p.add_argument("--w8a8", action="store_true", default=False)
    p.add_argument("--calibration", type=str, default=None,
                   help="calibration JSON from 'cli.evaluate --calibrate': "
                        "output lines gain calibrated P(bonafide) and the "
                        "aggregate an accept/reject decision")
    p.add_argument("--operating_point", type=str, default="eer",
                   help="decision threshold from --calibration: 'eer', "
                        "'far=<rate>' or 'frr=<rate>'")
    p.add_argument("--incremental", action="store_true", default=False,
                   help="cache conv features across overlapping windows "
                        "(exact on the 20 ms frame grid; ~(window/hop)x "
                        "fewer conv FLOPs)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    sys_config, exp_config = load_yaml_config(args.config)

    sr = float(exp_config.sample_rate)
    # compare against None, not falsiness: an explicit 0 must be rejected
    # below, not silently replaced by the default
    window_sec = (args.window_sec if args.window_sec is not None
                  else float(exp_config.test_duration_sec))
    hop_sec = args.hop_sec if args.hop_sec is not None else window_sec / 2
    if window_sec <= 0:
        raise SystemExit(f"--window_sec must be > 0 (got {window_sec})")
    if hop_sec <= 0:
        raise SystemExit(f"--hop_sec must be > 0 (got {hop_sec})")
    duration = int(round(window_sec * sr))
    hop = int(round(hop_sec * sr))
    if hop < 1:
        raise SystemExit(f"--hop_sec {hop_sec} is under one sample at "
                         f"sample_rate {sr:g}")

    device = resolve_device(args.device)
    spec = load_eval_model(sys_config, exp_config, args.ckpt, device,
                           w8=args.w8, w8a8=args.w8a8)
    if args.incremental:
        scorer = IncrementalStreamingScorer(
            spec.module, spec.module.w2v_cfg, duration=duration, hop=hop,
            batch_size=args.batch_size, aggregate=args.aggregate)
    else:
        scorer = StreamingScorer(
            make_score_step(spec.module), duration=duration, hop=hop,
            batch_size=args.batch_size, aggregate=args.aggregate,
            device=device)

    # warm up once, so that the first file's wall clock (and the xRT below)
    # leaves out the kernels' first build and cuDNN's first calls; the
    # incremental scorer's shapes follow the audio-length bucket, so it is
    # warmed once for each new bucket inside the loop too
    scorer.window_scores(np.zeros(duration, np.float32))
    warmed_buckets = set()

    cal = thr = None
    if args.calibration:
        cal = load_calibration(args.calibration)
        thr = calibration_threshold(cal, args.operating_point)

    out_fh = open(args.out, "w") if args.out else None
    try:
        for path in args.audio:
            wave, rate = load_audio(path)
            if rate != int(sr):
                wave = resample(wave, rate, int(sr))
            if args.incremental:
                key = scorer.bucket_key(len(wave))
                if key not in warmed_buckets:
                    scorer.window_scores(np.zeros(len(wave), np.float32))
                    warmed_buckets.add(key)
            t0 = time.perf_counter()
            ws = scorer.window_scores(wave)
            wall = time.perf_counter() - t0
            agg = scorer.aggregate_scores(ws)
            if args.per_window:
                # true window starts: the tail window sits at T - duration,
                # off the hop grid; the incremental scorer snaps starts to
                # the conv frame grid
                starts = scorer.window_starts(len(wave))
                for i, (s0, s) in enumerate(zip(starts, ws)):
                    prob = f" p={platt_prob(s, cal):.4f}" if cal else ""
                    print(f"{path}#{i} {s0 / sr:.2f} {s}{prob}")
            audio_sec = len(wave) / sr
            extra = ""
            if cal:
                verdict = "accept" if agg >= thr else "reject"
                extra = (f" p={platt_prob(agg, cal):.4f} "
                         f"{verdict}@{args.operating_point}")
            print(f"{path} {agg}{extra}")
            print(f"  [{len(ws)} windows over {audio_sec:.1f}s in {wall:.3f}s "
                  f"-> xRT {wall / max(audio_sec, 1e-9):.4f}]", file=sys.stderr)
            if out_fh:
                out_fh.write(f"{path} {agg}\n")
    finally:
        if out_fh:
            out_fh.close()


if __name__ == "__main__":
    main(sys.argv[1:])

"""Score audio with an exported artifact, with no config, checkpoint or
model code: the port of ``rtdsd_tpu/cli/infer.py``.

The consumer side of ``cli.export``: given the artifact and a list of audio
files, it writes the ``utt_id score`` lines of ``cli.main --is_score``
(score = bonafide logit, no pre-emphasis). It imports no module that
defines a model, only the kernels' operator registrations the programs
call.

    # batch scorer artifact (one fixed-duration score per file)
    python -m rtdsd_tpu_torch.cli.infer --artifact student.tpex \\
        --audio a.flac b.wav --out scores.txt

    # streaming bundle (long audio; per-window scores + aggregate)
    python -m rtdsd_tpu_torch.cli.infer --artifact stream_art \\
        --audio long.wav --per_window --aggregate median

The artifact's kind comes from its ``.json`` sidecar. Clips are fitted to
the duration as the eval datasets fit them (repeat-tile, first-N crop,
``data/dataset.py::adjust_duration``); a sample rate other than the
artifact's is refused. The device defaults to ``cuda`` (the artifact's
GPU program); without a GPU the run raises unless ``--device cpu`` is
given, which runs its CPU program.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from rtdsd_tpu_torch.cli.export import ScoringArtifact, StreamingArtifact
from rtdsd_tpu_torch.data.dataset import adjust_duration
from rtdsd_tpu_torch.data.io import load_audio
from rtdsd_tpu_torch.utils.metrics import (calibration_threshold,
                                           load_calibration, platt_prob)


def _utt_id(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _load_checked(path: str, expect_sr: int) -> np.ndarray:
    wave, sr = load_audio(path)
    if sr != expect_sr:
        raise ValueError(f"{path}: sample rate {sr} != artifact's "
                         f"{expect_sr}; resample before scoring")
    return wave


def score_batch_artifact(artifact, meta: dict, paths, batch_size: int = 8):
    """Score files through an ``export_scorer`` artifact -> ``(names,
    scores)``. A fixed-batch artifact pads the tail batch by repeating the
    last clip; a symbolic-batch one dispatches the exact remainder."""
    sr = int(meta["sample_rate"])
    n = int(round(float(meta["duration_sec"]) * sr))
    fixed = meta.get("batch")
    fixed = None if fixed in (None, "symbolic") else int(fixed)
    if fixed is not None:
        batch_size = fixed

    names, scores = [], []
    for lo in range(0, len(paths), batch_size):
        chunk = paths[lo: lo + batch_size]
        waves = np.stack([adjust_duration(_load_checked(p, sr), n)
                          for p in chunk])
        valid = waves.shape[0]
        if fixed is not None and valid < fixed:
            waves = np.concatenate(
                [waves, np.repeat(waves[-1:], fixed - valid, axis=0)])
        out = artifact.call(waves.astype(np.float32))
        names.extend(_utt_id(p) for p in chunk)
        scores.extend(out[:valid].tolist())
    return names, scores


def main(argv=None):
    p = argparse.ArgumentParser(
        description="score audio files with an exported artifact "
                    "(no config/checkpoint)")
    p.add_argument("--artifact", required=True,
                   help="path from cli.export --out: a batch scorer file or "
                        "a streaming bundle prefix (detected)")
    p.add_argument("--audio", required=True, nargs="+")
    p.add_argument("--out", type=str, default=None,
                   help="write 'utt_id score' lines here (default: stdout)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="dispatch batch of a symbolic-batch scorer, and of "
                        "a streaming bundle's windows")
    p.add_argument("--aggregate", default="mean",
                   choices=("mean", "min", "max", "median"),
                   help="window-score aggregate (streaming bundles)")
    p.add_argument("--per_window", action="store_true", default=False,
                   help="also print per-window scores (streaming bundles)")
    p.add_argument("--calibration", type=str, default=None,
                   help="calibration JSON from 'cli.evaluate --calibrate': "
                        "stdout lines gain calibrated P(bonafide) and an "
                        "accept/reject decision (--out stays raw scores)")
    p.add_argument("--operating_point", type=str, default="eer",
                   help="decision threshold from --calibration: 'eer', "
                        "'far=<rate>' or 'frr=<rate>'")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu: the program of that "
                        "platform runs")
    args = p.parse_args(argv)

    with open(args.artifact + ".json") as fh:
        meta = json.load(fh)

    cal = thr = None
    if args.calibration:
        cal = load_calibration(args.calibration)
        thr = calibration_threshold(cal, args.operating_point)

    names, scores = [], []
    if meta.get("streaming"):
        art = StreamingArtifact.load(args.artifact, args.device)
        sr = int(meta["sample_rate"])
        agg = {"mean": np.mean, "min": np.min, "max": np.max,
               "median": np.median}[args.aggregate]
        for path in args.audio:
            ws, starts = art.window_scores(_load_checked(path, sr),
                                           return_starts=True,
                                           batch_size=args.batch_size)
            if args.per_window:
                # the actual window positions: hop-grid starts snapped to
                # the conv frame grid plus the tail window, not i * hop
                for i, (s, st) in enumerate(zip(ws, starts)):
                    prob = (f" p={platt_prob(float(s), cal):.4f}"
                            if cal else "")
                    print(f"{_utt_id(path)}#{i} {st / sr:.2f} "
                          f"{float(s)}{prob}")
            names.append(_utt_id(path))
            scores.append(float(agg(ws)))
    else:
        art = ScoringArtifact.load(args.artifact, args.device)
        names, scores = score_batch_artifact(art, meta, args.audio,
                                             args.batch_size)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            for f, cm in zip(names, scores):
                fh.write("{} {}\n".format(f, cm))
        print(f"Wrote {len(names)} scores -> {args.out}")
    else:
        for f, cm in zip(names, scores):
            extra = ""
            if cal:
                verdict = "accept" if cm >= thr else "reject"
                extra = (f" p={platt_prob(cm, cal):.4f} "
                         f"{verdict}@{args.operating_point}")
            print(f"{f} {cm}{extra}")


if __name__ == "__main__":
    main()

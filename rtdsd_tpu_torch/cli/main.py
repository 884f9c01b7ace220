"""Scoring CLI of the port, with the scoring flags of ``rtdsd_tpu.cli.main``:

    python -m rtdsd_tpu_torch.cli.main --config cfg.yaml --is_eval \\
        --is_score --ckpt model.pt --tracks LA19,LA21 [--comment tag] \\
        [--w8 | --w8a8] [--device cuda|cpu]
    # cascade: a screener scores every trial, the band escalates to --ckpt
    python -m rtdsd_tpu_torch.cli.main --config cfg.yaml --is_eval \\
        --is_score --ckpt full.pt --cascade_ckpt screener.pt \\
        [--cascade_config screener.yaml] [--cascade_band 2.0] \\
        [--cascade_center 0.0]
    # every directory or .pt of a folder, in sorted order
    python -m rtdsd_tpu_torch.cli.main --config cfg.yaml --is_eval \\
        --score_all_folder_path runs/ [--comment base]

The device defaults to ``cuda``; without a GPU the run raises unless
``--device cpu`` is given. ``--ckpt`` is a reference-format ``.pt``
(``rtdsd_tpu.models.export_reference`` writes one from a JAX checkpoint;
a JAX checkpoint directory raises and says so). ``--w8`` scores with int8
transformer weights and ``--w8a8`` with int8 weights and int8 activations
(``ExpConfig.w8_scoring`` / ``w8a8_scoring`` turn them on too); the
weights are quantized after the load, on the run's device. The cascade's
screener takes its model, kwargs, duration and quantization flags from
``--cascade_config`` (default: ``--config``) and its dataset paths from
``--config``; trials with ``|screener score - center| <= band`` are scored
again by ``--ckpt``'s model. ``--score_all_folder_path`` scores each entry
with the comment ``{comment}_{name}`` (or ``name``). Training and eval
without ``--is_score`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import os
import sys

from rtdsd_tpu_torch.cli.common import (load_eval_model,
                                        produce_evaluation_file,
                                        produce_evaluation_file_cascade,
                                        tag_score_path)
from rtdsd_tpu_torch.config import load_yaml_config
from rtdsd_tpu_torch.data.dataset import (ASVSpoof5, ASVspoof2019LA_eval,
                                          ASVspoof2021DF_eval,
                                          ASVspoof2021LA_eval, FakeOrReal,
                                          InTheWild)
from rtdsd_tpu_torch.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="./configs/paper.yaml", type=str)
    p.add_argument("--is_eval", action="store_true", default=False)
    p.add_argument("--ckpt", default=None, type=str)
    p.add_argument("--comment", default=None, type=str,
                   help="suffix appended to score file names")
    p.add_argument("--is_score", action="store_true", default=False)
    p.add_argument("--score_all_folder_path", type=str, default=None,
                   help="score every directory or .pt of this folder")
    p.add_argument("--tracks", type=str, default="DF21",
                   help="comma list: LA19/LA21/DF21/InTheWild/ASVspoof5/FakeOrReal")
    p.add_argument("--w8", action="store_true", default=False,
                   help="int8 weight-only scoring of the XLSR transformer "
                        "(or ExpConfig.w8_scoring)")
    p.add_argument("--w8a8", action="store_true", default=False,
                   help="w8 plus dynamic int8 activations, int8 x int8 "
                        "matmuls (or ExpConfig.w8a8_scoring)")
    p.add_argument("--cascade_ckpt", type=str, default=None,
                   help="cascade scoring: checkpoint of a cheap screener "
                        "model that scores every trial first; trials inside "
                        "the uncertainty band escalate to --ckpt's model")
    p.add_argument("--cascade_config", type=str, default=None,
                   help="screener YAML (model/kwargs/duration/quant flags; "
                        "dataset paths still come from --config). Default: "
                        "--config itself")
    p.add_argument("--cascade_band", type=float, default=2.0,
                   help="escalate when |screener score - center| <= band "
                        "(logit units)")
    p.add_argument("--cascade_center", type=float, default=0.0,
                   help="center of the uncertainty band (decision "
                        "threshold, ~0 for bonafide-logit scores)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu, for every model of the run "
                        "(scoring, cascade and folder scoring alike)")
    return p.parse_args(argv)


TRACK_DATASETS = {
    "LA19": (ASVspoof2019LA_eval, "la19_score_save_path"),
    "LA21": (ASVspoof2021LA_eval, "la21_score_save_path"),
    "DF21": (ASVspoof2021DF_eval, "df21_score_save_path"),
    "InTheWild": (InTheWild, "itw_score_save_path"),
    "ASVspoof5": (ASVSpoof5, "asvspoof5_score_save_path"),
    "FakeOrReal": (FakeOrReal, "itw_score_save_path"),
}


def validate_tracks(tracks) -> None:
    for track in tracks:
        if track not in TRACK_DATASETS:
            raise ValueError(f"Invalid track {track!r}; "
                             f"have {sorted(TRACK_DATASETS)}")


def run_score(args, sys_config, exp_config, tracks, device):
    spec = load_eval_model(sys_config, exp_config, args.ckpt, device,
                           w8=args.w8, w8a8=args.w8a8)
    if args.cascade_ckpt:
        # the screener's YAML decides its model, kwargs, duration and
        # quantization flags; dataset paths come from the primary config
        if args.cascade_config:
            screen_sys, screen_exp = load_yaml_config(args.cascade_config)
        else:
            screen_sys, screen_exp = sys_config, exp_config
        spec_s = load_eval_model(screen_sys, screen_exp, args.cascade_ckpt,
                                 device)
    for track in tracks:
        ds_cls, path_attr = TRACK_DATASETS[track]
        save_path = tag_score_path(getattr(sys_config, path_attr),
                                   args.comment, path_attr)
        if os.path.exists(save_path):
            print(f"{track}: score file exists, skip")
            continue
        print(f"Evaluating {track}")
        dataset = ds_cls(sys_config, exp_config)
        if args.cascade_ckpt:
            # the screener may crop to its own test duration
            ds_screen = (dataset if screen_exp is exp_config
                         else ds_cls(sys_config, screen_exp))
            produce_evaluation_file_cascade(
                ds_screen, dataset, spec_s, spec, save_path,
                exp_config.batch_size_test, device, band=args.cascade_band,
                center=args.cascade_center)
        else:
            produce_evaluation_file(dataset, spec, save_path,
                                    exp_config.batch_size_test, device,
                                    sys_config.decode_error_policy)


def score_folder(args, sys_config, exp_config, tracks, device):
    """Score every directory or ``.pt`` of ``--score_all_folder_path`` in
    sorted order, each with the comment ``{comment}_{name}`` or ``name``."""
    base_comment = args.comment or ""
    for name in sorted(os.listdir(args.score_all_folder_path)):
        ckpt = os.path.join(args.score_all_folder_path, name)
        if not (os.path.isdir(ckpt) or ckpt.endswith(".pt")):
            continue
        args.ckpt = ckpt
        args.comment = f"{base_comment}_{name}" if base_comment else name
        run_score(args, sys_config, exp_config, tracks, device)


def main(argv=None):
    args = parse_args(argv)
    tracks = args.tracks.split(",")
    if args.is_eval and (args.is_score or args.score_all_folder_path):
        validate_tracks(tracks)           # fail fast, before any checkpoint IO
    sys_config, exp_config = load_yaml_config(args.config)
    if not args.is_eval:
        raise NotImplementedError("training is not yet ported; score with "
                                  "--is_eval --is_score")
    if args.score_all_folder_path:
        score_folder(args, sys_config, exp_config, tracks,
                     resolve_device(args.device))
        return
    if args.ckpt is None:
        raise ValueError("ckpt is None")
    if not args.is_score:
        raise NotImplementedError("eval without --is_score is not yet ported")
    run_score(args, sys_config, exp_config, tracks, resolve_device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])

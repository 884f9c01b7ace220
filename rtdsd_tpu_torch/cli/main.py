"""Scoring CLI of the port, with the flag surface of ``rtdsd_tpu.cli.main``:

    python -m rtdsd_tpu_torch.cli.main --config cfg.yaml --is_eval \\
        --is_score --ckpt model.pt --tracks LA19,LA21 [--comment tag] \\
        [--w8 | --w8a8] [--device cuda|cpu]

The device defaults to ``cuda``; without a GPU the run raises unless
``--device cpu`` is given. ``--ckpt`` is a reference-format ``.pt``
(``rtdsd_tpu.models.export_reference`` writes one from a JAX checkpoint).
``--w8`` scores with int8 transformer weights and ``--w8a8`` with int8
weights and int8 activations (``ExpConfig.w8_scoring`` /
``w8a8_scoring`` turn them on too); the weights are quantized after the
load, on the run's device. Training and cascade scoring
(``--cascade_ckpt``) are not ported yet and raise; so does eval without
``--is_score``.
"""

from __future__ import annotations

import argparse
import os
import sys

from rtdsd_tpu_torch.cli.common import (load_eval_model,
                                        produce_evaluation_file, tag_score_path)
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
    p.add_argument("--tracks", type=str, default="DF21",
                   help="comma list: LA19/LA21/DF21/InTheWild/ASVspoof5/FakeOrReal")
    p.add_argument("--w8", action="store_true", default=False,
                   help="int8 weight-only scoring of the XLSR transformer "
                        "(or ExpConfig.w8_scoring)")
    p.add_argument("--w8a8", action="store_true", default=False,
                   help="w8 plus dynamic int8 activations, int8 x int8 "
                        "matmuls (or ExpConfig.w8a8_scoring)")
    p.add_argument("--cascade_ckpt", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu")
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
    for track in tracks:
        ds_cls, path_attr = TRACK_DATASETS[track]
        save_path = tag_score_path(getattr(sys_config, path_attr),
                                   args.comment, path_attr)
        if os.path.exists(save_path):
            print(f"{track}: score file exists, skip")
            continue
        print(f"Evaluating {track}")
        produce_evaluation_file(ds_cls(sys_config, exp_config), spec,
                                save_path, exp_config.batch_size_test, device,
                                sys_config.decode_error_policy)


def main(argv=None):
    args = parse_args(argv)
    if args.cascade_ckpt:
        raise NotImplementedError("--cascade_ckpt is not yet ported")
    tracks = args.tracks.split(",")
    if args.is_eval and args.is_score:
        validate_tracks(tracks)           # fail fast, before any checkpoint IO
    sys_config, exp_config = load_yaml_config(args.config)
    if not args.is_eval:
        raise NotImplementedError("training is not yet ported; score with "
                                  "--is_eval --is_score")
    if args.ckpt is None:
        raise ValueError("ckpt is None")
    if not args.is_score:
        raise NotImplementedError("eval without --is_score is not yet ported")
    run_score(args, sys_config, exp_config, tracks, resolve_device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])

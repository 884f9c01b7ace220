"""Train / evaluate / score CLI of the port, with the flags of
``rtdsd_tpu.cli.main``:

    python -m rtdsd_tpu_torch.cli.main --config cfg.yaml [--max_epoch N] \\
        [--ckpt runs/last] [--device cuda|cpu]                    # train
    python -m rtdsd_tpu_torch.cli.main --config cfg.yaml --accuracy \\
        --ckpt runs/best                                  # test accuracy
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
``--device cpu`` is given. ``--ckpt`` is a reference-format ``.pt``, one
of the port's checkpoint directories (``engine/checkpoint.py``) or one of
the JAX package's (``state.msgpack`` or ``weights.msgpack``; an orbax
directory raises and names the route that works). ``--w8`` scores with int8
transformer weights and ``--w8a8`` with int8 weights and int8 activations
(``ExpConfig.w8_scoring`` / ``w8a8_scoring`` turn them on too); the
weights are quantized after the load, on the run's device. The cascade's
screener takes its model, kwargs, duration and quantization flags from
``--cascade_config`` (default: ``--config``) and its dataset paths from
``--config``; trials with ``|screener score - center| <= band`` are scored
again by ``--ckpt``'s model. ``--score_all_folder_path`` scores each entry
with the comment ``{comment}_{name}`` (or ``name``).

Training (no ``--is_eval``) trains the XLSR_AASIST and XLSR_Conformer
families on the ASVspoof 2019 LA train set, the encoder initialised from
``ssl_pytree_path`` (a JAX pytree directory, as ``cli.convert`` writes it,
or an HF snapshot) or ``ssl_ckpt_path`` (a fairseq ``.pt``), a dev pass
each epoch, as the JAX CLI does: a
``best_LA_epoch{e}_{loss}_{acc}`` checkpoint when the dev loss improves
with accuracy above 95 or a new best accuracy above 95 comes in another
epoch, the rolling ``last`` checkpoint every epoch (both written by a
background thread from a host copy, ``save_checkpoint_async``; the run
waits for the last before it exits), and early stopping on the dev loss
with ``kwargs.early_stop_patience`` (its save synchronous). ``restore_checkpoint``
(or ``--ckpt``) resumes from a checkpoint directory (its full state) or
starts from a reference ``.pt``'s weights. ``--accuracy`` only runs the
test pass (the DF21 eval set when configured, else dev).
"""

from __future__ import annotations

import argparse
import os
import sys

from rtdsd_tpu_torch.cli.common import (build_model, init_state,
                                        load_checkpoint_for_eval,
                                        load_eval_model,
                                        produce_evaluation_file,
                                        produce_evaluation_file_cascade,
                                        tag_score_path)
from rtdsd_tpu_torch.config import load_yaml_config
from rtdsd_tpu_torch.data.dataset import (ASVSpoof5, ASVspoof2019LA,
                                          ASVspoof2019LA_eval,
                                          ASVspoof2021DF_eval,
                                          ASVspoof2021LA_eval, FakeOrReal,
                                          InTheWild)
from rtdsd_tpu_torch.data.loader import DataLoader
from rtdsd_tpu_torch.device import resolve_device
from rtdsd_tpu_torch.engine import checkpoint
from rtdsd_tpu_torch.engine.trainer import Trainer
from rtdsd_tpu_torch.utils.logging import Logger
from rtdsd_tpu_torch.utils.metrics import EarlyStopping


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="./configs/paper.yaml", type=str)
    p.add_argument("--is_eval", action="store_true", default=False)
    p.add_argument("--ckpt", default=None, type=str)
    p.add_argument("--comment", default=None, type=str,
                   help="suffix appended to score file names")
    p.add_argument("--is_score", action="store_true", default=False)
    p.add_argument("--accuracy", action="store_true", default=False,
                   help="only the test pass of a model (--ckpt)")
    p.add_argument("--max_epoch", type=int, default=None,
                   help="override ExpConfig.max_epoch")
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
                        "(training, scoring, cascade and folder scoring "
                        "alike)")
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


def run_train(args, sys_config, exp_config, device):
    """The JAX CLI's train path on one device (see the module docstring);
    every registered model trains."""
    seed = exp_config.random_seed
    save_dir = sys_config.path_to_save_model
    logger = Logger(sys_config, metrics_path=os.path.join(save_dir,
                                                          "metrics.jsonl"))
    logger.print(f"device: {device}")
    train_set = ASVspoof2019LA(sys_config, exp_config, is_train=True)
    dev_set = ASVspoof2019LA(sys_config, exp_config, is_train=False)
    logger.print(f"train: {len(train_set)} utts ({train_set.num_of_spoof} "
                 f"spoof / {train_set.num_of_bonafide} bonafide), dev: "
                 f"{len(dev_set)}")

    def loader(ds, batch_size, shuffle):
        return DataLoader(ds, batch_size, shuffle=shuffle, drop_last=shuffle,
                          seed=seed, num_workers=sys_config.num_workers,
                          on_decode_error=sys_config.decode_error_policy)
    train_loader = loader(train_set, exp_config.batch_size_train, True)
    dev_loader = loader(dev_set, exp_config.batch_size_test, False)

    spec = build_model(sys_config, exp_config, device, train=True)
    state = init_state(spec, sys_config, exp_config, seed)
    start = exp_config.restore_checkpoint or args.ckpt
    if start and checkpoint.is_checkpoint(start):
        checkpoint.restore_checkpoint(start, state)
        logger.print(f"restored {start} (step {state.step})")
    elif start:
        load_checkpoint_for_eval(start, spec)
        logger.print(f"loaded ckpt {start}")

    test_loader = dev_loader
    if args.accuracy and sys_config.path_label_asv_spoof_2021_df_eval:
        test_loader = loader(ASVspoof2021DF_eval(sys_config, exp_config),
                             exp_config.batch_size_test, False)
    trainer = Trainer(state, train_loader, dev_loader, test_loader, logger,
                      exp_config, device, rng_seed=seed)
    if args.accuracy:
        loss, acc = trainer.test(is_dev=test_loader is dev_loader)
        logger.print(f"Test acc: {acc}, Test loss: {loss}")
        return

    patience = int(exp_config.kwargs.get("early_stop_patience", 0) or 0)
    stopper = (EarlyStopping(patience=patience, save_dir=save_dir)
               if patience > 0 else None)
    best_loss, best_acc = float("inf"), 0.0
    best_loss_epoch, best_acc_epoch = -1, -2
    handle = None
    for epoch in range(args.max_epoch or exp_config.max_epoch):
        trainer.train()
        dev_loss, dev_acc = trainer.test(is_dev=True)
        logger.print(f"epoch {epoch}: dev loss {dev_loss:.5f} acc {dev_acc:.2f}")
        # both reference save triggers: the dev loss improved with accuracy
        # above 95, or a new best accuracy above 95 in another epoch
        save = False
        if dev_loss < best_loss and dev_acc > 95:
            best_loss, best_loss_epoch, save = dev_loss, epoch, True
        if dev_acc > best_acc:
            best_acc, best_acc_epoch = dev_acc, epoch
            if best_acc_epoch != best_loss_epoch and best_acc > 95:
                save = True
        if save:
            path = os.path.join(save_dir, f"best_LA_epoch{epoch}_"
                                          f"{dev_loss:.5f}_{dev_acc:.2f}")
            checkpoint.save_checkpoint_async(path, state, epoch, meta={
                "epoch": epoch, "dev_loss": dev_loss, "dev_acc": dev_acc})
            logger.print(f"saved {path}")
        handle = checkpoint.save_checkpoint_async(
            os.path.join(save_dir, "last"), state, epoch,
            meta={"epoch": epoch, "dev_loss": dev_loss})
        if stopper is not None:
            stopper(dev_loss, epoch, lambda p: checkpoint.save_checkpoint(
                p, state, epoch, meta={"epoch": epoch}))
            if stopper.early_stop:
                logger.print(f"early stop at epoch {epoch} "
                             f"(patience {patience})")
                break
    if handle is not None:          # commit the save in flight before exit
        handle.wait_until_finished()
    logger.close()


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
        run_train(args, sys_config, exp_config, resolve_device(args.device))
        return
    if args.score_all_folder_path:
        score_folder(args, sys_config, exp_config, tracks,
                     resolve_device(args.device))
        return
    if args.ckpt is None:
        raise ValueError("ckpt is None")
    if args.is_score:
        run_score(args, sys_config, exp_config, tracks,
                  resolve_device(args.device))
        return
    run_train(args, sys_config, exp_config, resolve_device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])

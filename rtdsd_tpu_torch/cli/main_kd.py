"""Knowledge-distillation CLI of the port, with the flags of
``rtdsd_tpu.cli.main_kd``:

    python -m rtdsd_tpu_torch.cli.main_kd --config kd.yaml --ckpt teacher \\
        [--max_epoch N] [--accuracy] [--device cuda|cpu]           # train
    python -m rtdsd_tpu_torch.cli.main_kd --config kd.yaml --is_eval \\
        --is_score --eval student --ckpt runs/kd/last_kd --tracks DF21 \\
        [--comment tag] [--w8 | --w8a8] [--device cuda|cpu]        # score

The YAML schema is the reference's: ``SysConfig.model`` (the teacher,
with ``ExpConfig.kwargs``) and ``SysConfig.student_model``,
``ExpConfig.kd_kwargs`` with ``student_kwargs``, ``copy_weights``,
``custom_order_copy_weights``, ``ce_loss_weight``, ``kd_criterions`` and
``kd_criterion_weights`` (see ``engine/kd.py``).

Training loads the teacher from ``--ckpt`` (a reference ``.pt``, one of the
port's checkpoint directories or one of the JAX package's; without it the
teacher is initialised as a model to train is), builds the student
(``student_kwargs``, its encoder from ``ssl_pytree_path`` /
``ssl_ckpt_path``), copies the teacher's parameters into it when
``copy_weights`` is set (student layer ``j`` from teacher layer
``custom_order_copy_weights[j]``, resolved against the teacher's depth),
resumes the student from ``restore_checkpoint``, and trains it with a dev
pass each epoch: ``student_best_epoch{e}_{loss}_{acc}`` when the dev loss
improves, the rolling ``last_kd`` every epoch (both written in the
background, ``save_checkpoint_async``), early stopping with
``kwargs.early_stop_patience``; metrics go to ``kd_metrics.jsonl``.
Scoring builds the teacher (``--eval teacher``) or the student and writes
the score files as ``cli.main`` does. The device defaults to ``cuda``;
without a GPU the run raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

from rtdsd_tpu_torch.cli.common import (build_model, init_state,
                                        load_checkpoint_for_eval,
                                        load_eval_model,
                                        produce_evaluation_file,
                                        tag_score_path)
from rtdsd_tpu_torch.cli.main import TRACK_DATASETS, validate_tracks
from rtdsd_tpu_torch.config import load_yaml_config
from rtdsd_tpu_torch.data.dataset import ASVspoof2019LA
from rtdsd_tpu_torch.data.loader import DataLoader
from rtdsd_tpu_torch.device import resolve_device
from rtdsd_tpu_torch.engine import checkpoint
from rtdsd_tpu_torch.engine.kd import KDTrainer, copy_teacher_weights
from rtdsd_tpu_torch.engine.steps import make_optimizer
from rtdsd_tpu_torch.models.wav2vec2 import resolve_layer_indices
from rtdsd_tpu_torch.utils.logging import Logger
from rtdsd_tpu_torch.utils.metrics import EarlyStopping


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", default="./configs/kd.yaml", type=str)
    p.add_argument("--is_eval", action="store_true", default=False)
    p.add_argument("--eval", default="teacher", choices=["teacher", "student"])
    p.add_argument("--ckpt", default=None, type=str)
    p.add_argument("--comment", default=None, type=str)
    p.add_argument("--is_score", action="store_true", default=False)
    p.add_argument("--accuracy", action="store_true", default=False)
    p.add_argument("--tracks", type=str, default="DF21")
    p.add_argument("--max_epoch", type=int, default=None)
    p.add_argument("--w8a8", action="store_true", default=False,
                   help="int8 weights + dynamic int8 activations")
    p.add_argument("--w8", action="store_true", default=False,
                   help="weight-only int8 scoring (or ExpConfig.w8_scoring)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (default) or cpu, for the teacher and the "
                        "student")
    return p.parse_args(argv)


def student_kwargs(exp_config) -> dict:
    return (exp_config.kd_kwargs or {}).get("student_kwargs", {})


def build_teacher(args, sys_config, exp_config, device, logger):
    """The frozen teacher in eval mode: ``--ckpt``'s weights, or without it
    the initialisation of a model to train (its optimizer dropped)."""
    spec = build_model(sys_config, exp_config, device)
    if args.ckpt:
        load_checkpoint_for_eval(args.ckpt, spec)
        logger.print(f"Load Teacher checkpoint from {args.ckpt}")
    else:
        init_state(spec, sys_config, exp_config, exp_config.random_seed)
    spec.module.eval().requires_grad_(False)
    return spec


def run_kd_train(args, sys_config, exp_config, device):
    seed = exp_config.random_seed
    save_dir = sys_config.path_to_save_model
    logger = Logger(sys_config, metrics_path=os.path.join(save_dir,
                                                          "kd_metrics.jsonl"))
    logger.print(f"device: {device}")
    kd = exp_config.kd_kwargs or {}
    teacher_spec = build_teacher(args, sys_config, exp_config, device, logger)

    s_kwargs = student_kwargs(exp_config)
    student_spec = build_model(sys_config, exp_config, device,
                               name=sys_config.student_model, kwargs=s_kwargs,
                               train=True)
    state = init_state(student_spec, sys_config, exp_config, seed + 1)
    count = lambda m: sum(p.numel() for p in m.parameters())
    logger.print(f"Number of teacher model parameters: "
                 f"{count(teacher_spec.module)}")
    logger.print(f"Number of student model parameters: {count(state.model)}")

    if kd.get("copy_weights", False):
        total = len(teacher_spec.layer_indices)
        indices = resolve_layer_indices(
            total, int(s_kwargs.get("num_layers", total)),
            s_kwargs.get("order", "first"),
            kd.get("custom_order_copy_weights", s_kwargs.get("custom_order")))
        copy_teacher_weights(state.model, teacher_spec.module, indices)
        state.optimizer = make_optimizer(
            state.model, exp_config.lr, exp_config.weight_decay,
            student_spec.freeze_patterns, student_spec.unfreeze_patterns,
            optimizer=exp_config.optimizer, mu_dtype=exp_config.adam_mu_dtype)
        logger.print(f"Copied teacher weights to student (layer map {indices})")
    if exp_config.restore_checkpoint:
        start = exp_config.restore_checkpoint
        if checkpoint.is_checkpoint(start):
            checkpoint.restore_checkpoint(start, state)
        else:
            load_checkpoint_for_eval(start, student_spec)
        logger.print(f"restored student {start}")

    def loader(ds, batch_size, shuffle):
        return DataLoader(ds, batch_size, shuffle=shuffle, drop_last=shuffle,
                          seed=seed, num_workers=sys_config.num_workers,
                          on_decode_error=sys_config.decode_error_policy)
    train_set = ASVspoof2019LA(sys_config, exp_config, is_train=True)
    dev_set = ASVspoof2019LA(sys_config, exp_config, is_train=False)
    trainer = KDTrainer(
        teacher_spec.module, state, kd,
        loader(train_set, exp_config.batch_size_train, True),
        loader(dev_set, exp_config.batch_size_test, False), None, logger,
        exp_config, device, rng_seed=seed)
    if args.accuracy:
        loss, acc = trainer.test(is_dev=True)
        logger.print(f"Student dev acc: {acc}, loss: {loss}")
        return

    patience = int(exp_config.kwargs.get("early_stop_patience", 0) or 0)
    stopper = (EarlyStopping(patience=patience, save_dir=save_dir)
               if patience > 0 else None)
    best_loss, handle = float("inf"), None
    for epoch in range(args.max_epoch or exp_config.max_epoch):
        trainer.train()
        dev_loss, dev_acc = trainer.test(is_dev=True)
        logger.print(f"epoch {epoch}: student dev loss {dev_loss:.5f} "
                     f"acc {dev_acc:.2f}")
        if dev_loss < best_loss:
            best_loss = dev_loss
            path = os.path.join(save_dir, f"student_best_epoch{epoch}_"
                                          f"{dev_loss:.5f}_{dev_acc:.2f}")
            handle = checkpoint.save_checkpoint_async(
                path, state, epoch, meta={"epoch": epoch, "dev_loss": dev_loss,
                                          "dev_acc": dev_acc, "kind": "student"})
            logger.print(f"saved {path}")
        handle = checkpoint.save_checkpoint_async(
            os.path.join(save_dir, "last_kd"), state, epoch,
            meta={"epoch": epoch, "dev_loss": dev_loss, "kind": "student"})
        if stopper is not None:
            stopper(dev_loss, epoch, lambda p: checkpoint.save_checkpoint(
                p, state, epoch, meta={"epoch": epoch, "kind": "student"}))
            if stopper.early_stop:
                logger.print(f"early stop at epoch {epoch} "
                             f"(patience {patience})")
                break
    if handle is not None:          # commit the save in flight before exit
        handle.wait_until_finished()
    logger.close()


def run_kd_score(args, sys_config, exp_config, tracks, device):
    validate_tracks(tracks)           # fail fast, before any checkpoint IO
    name = kwargs = None
    if args.eval == "student":
        name, kwargs = sys_config.student_model, student_kwargs(exp_config)
    spec = load_eval_model(sys_config, exp_config, args.ckpt, device,
                           w8=args.w8, w8a8=args.w8a8, name=name,
                           kwargs=kwargs)
    for track in tracks:
        ds_cls, path_attr = TRACK_DATASETS[track]
        save_path = tag_score_path(getattr(sys_config, path_attr),
                                   args.comment, path_attr)
        if os.path.exists(save_path):
            print(f"{track}: score file exists, skip")
            continue
        produce_evaluation_file(ds_cls(sys_config, exp_config), spec,
                                save_path, exp_config.batch_size_test, device,
                                sys_config.decode_error_policy)


def main(argv=None):
    args = parse_args(argv)
    sys_config, exp_config = load_yaml_config(args.config)
    if args.is_eval:
        sys_config.wandb_disabled = True
        if args.ckpt is None:
            raise ValueError("ckpt is None")
        if args.is_score:
            run_kd_score(args, sys_config, exp_config,
                         args.tracks.split(","), resolve_device(args.device))
            return
    run_kd_train(args, sys_config, exp_config, resolve_device(args.device))


if __name__ == "__main__":
    main(sys.argv[1:])

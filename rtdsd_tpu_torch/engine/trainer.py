"""Epoch-level training engine: the port of ``rtdsd_tpu/engine/trainer.py``
(one process).

``Trainer.train()`` runs one epoch of train steps (reshuffled per epoch),
logging the mean loss every 2% of the epoch's batches and the epoch's train
accuracy; ``test(is_dev)`` runs the dev or test pass and returns
``(eval_loss, accuracy)``, logging the EER when both classes are present.
Step metrics stay on the device until a log point reads them.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from rtdsd_tpu_torch.config import ExpConfig
from rtdsd_tpu_torch.data.loader import DataLoader
from rtdsd_tpu_torch.engine.steps import (TrainState, make_eval_step,
                                          make_train_step, pick_rawboost_algo,
                                          post_device_augs, pre_device_augs)
from rtdsd_tpu_torch.utils.logging import Logger
from rtdsd_tpu_torch.utils.metrics import compute_eer


def to_device(batch, device: torch.device):
    """(waves float32, labels int64) of a loader batch on ``device``."""
    return (torch.from_numpy(batch.waves).to(device, non_blocking=True),
            torch.from_numpy(batch.labels).to(device, non_blocking=True).long())


class Trainer:
    def __init__(self, state: TrainState, train_loader: DataLoader,
                 dev_loader: Optional[DataLoader],
                 test_loader: Optional[DataLoader], logger: Logger,
                 exp_config: ExpConfig, device: torch.device,
                 rng_seed: int = 1024):
        self.state = state
        self.train_loader = train_loader
        self.dev_loader = dev_loader
        self.test_loader = test_loader
        self.logger = logger
        self.exp_config = exp_config
        self.device = device
        self.seed = rng_seed
        self.epoch = 0
        preemph = exp_config.pre_emphasis if exp_config.is_pre_emphasis else None
        da = list(exp_config.data_augmentation or [])
        ce_weight = tuple(exp_config.ce_weight)
        self.train_step = make_train_step(
            ce_weight=ce_weight, preemph=preemph,
            rawboost_algo=pick_rawboost_algo(da),
            pre_aug_list=pre_device_augs(da),
            aug_list=post_device_augs(da, exp_config.allow_data_augmentation),
            sample_rate=float(exp_config.sample_rate))
        self.eval_step = make_eval_step(state.model, ce_weight=ce_weight,
                                        preemph=preemph)

    def train(self) -> float:
        """One epoch. Returns the mean train loss."""
        self.train_loader.set_epoch(self.epoch)
        log_every = max(int(len(self.train_loader) * 0.02), 1)
        epoch_loss, batches_seen, num_correct, num_total = 0.0, 0, 0, 0
        pending = []
        t0 = time.time()

        def flush():
            nonlocal epoch_loss, num_correct
            losses = [float(m["loss"]) for m in pending]
            num_correct += sum(int(m["num_correct"]) for m in pending)
            epoch_loss += sum(losses)
            pending.clear()
            return sum(losses) / len(losses)

        for batch in self.train_loader:
            waves, labels = to_device(batch, self.device)
            pending.append(self.train_step(self.state, waves, labels,
                                           self.seed))
            num_total += waves.shape[0]
            batches_seen += 1
            if len(pending) >= log_every:
                self.logger.wandbLog({"Loss": flush()}, step=self.state.step)
        if pending:
            flush()
        acc = 100.0 * num_correct / max(num_total, 1)
        wall = time.time() - t0
        self.logger.wandbLog({"Train Acc": acc})
        self.logger.print(
            f"epoch {self.epoch}: train loss "
            f"{epoch_loss / max(batches_seen, 1):.5f} acc {acc:.2f}% "
            f"({wall:.1f}s, {num_total / max(wall, 1e-9):.1f} utt/s)")
        self.epoch += 1
        return epoch_loss / max(batches_seen, 1)

    def test(self, is_dev: bool = False) -> Tuple[float, float]:
        loader = self.dev_loader if is_dev else self.test_loader
        eval_loss, accuracy, scores, labels = run_eval_loop(
            self.eval_step, loader, self.device)
        logs = {"Dev Acc": accuracy, "Dev Loss": eval_loss}
        if len(np.unique(labels)) == 2:
            logs["Dev EER"] = compute_eer(scores, labels, pos_label=1)
        self.logger.wandbLog(logs)
        return eval_loss, accuracy


def run_eval_loop(eval_step, loader: DataLoader, device: torch.device
                  ) -> Tuple[float, float, np.ndarray, np.ndarray]:
    """The dev/eval pass: the weighted loss over the real rows only (the
    loader's pad rows would count the last trial again), the accuracy, and
    the per-trial (scores, labels). Every batch is dispatched before the
    first is read back."""
    outs = []
    for b in loader:
        waves, labels = to_device(b, device)
        outs.append((eval_step(waves, labels), b.labels, b.valid))
    loss_sum, num_correct, num_total = 0.0, 0, 0
    scores, labels = [], []
    for out, blabels, v in outs:
        wsum = float(out["loss_weights"][:v].sum())
        loss_sum += float(out["loss_terms"][:v].sum()) / max(wsum, 1e-12) * v
        num_correct += int(out["correct"][:v].sum())
        num_total += v
        scores.append(out["scores"][:v].float().cpu().numpy())
        labels.append(blabels[:v])
    scores = np.concatenate(scores) if scores else np.zeros(0)
    labels = np.concatenate(labels) if labels else np.zeros(0)
    return (loss_sum / max(num_total, 1), 100.0 * num_correct / max(num_total, 1),
            scores, labels)

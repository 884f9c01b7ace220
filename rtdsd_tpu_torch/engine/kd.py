"""Knowledge distillation: the port of ``rtdsd_tpu/engine/kd.py``.

A distillation step augments the batch as a train step does, runs the
teacher in eval mode without gradients and the student in train mode with
its dropout, and minimises ``ce_loss_weight`` x the student's weighted
cross-entropy plus, for each configured criterion, its weight x the
criterion of a student tap against a teacher tap (both float32). Each
weight is applied once (the reference multiplies by it twice; square the
weights in the YAML to reproduce a reference run). The optimizer holds the
student's parameters only (the reference built it over the teacher's).

Taps are named by the JAX package's paths, and accept the reference's
torch module paths (:func:`normalize_tap_path`): ``logits``,
``ssl_hidden:{i}`` (transformer layer ``i``'s output before the final
LayerNorm), ``ssl_model`` (the encoder's output), and the back-end's JAX
module outputs (``backend/LL``, ``backend/encoder_3``,
``backend/att_conv2``, ``backend/GAT_layer_S``, ``backend/pool_hT2``,
``backend/HtrgGAT_layer_ST11`` (its first output),
``backend/conformer/block_0/attn`` ...), which the models record
(:mod:`rtdsd_tpu_torch.models.taps`) only when a step asks for them.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtdsd_tpu_torch.engine.steps import (TrainState, make_eval_step,
                                          pick_rawboost_algo, post_device_augs,
                                          pre_device_augs, preprocess_train,
                                          step_seeds, weighted_cross_entropy)
from rtdsd_tpu_torch.engine.trainer import run_eval_loop, to_device
from rtdsd_tpu_torch.models import dropout, taps
from rtdsd_tpu_torch.utils.metrics import AverageMeter, compute_eer

# --------------------------------------------------------------- criteria


def _flat(x):
    return x.reshape(x.shape[0], -1) if x.dim() > 2 else x


def mse_loss(student, teacher, labels, **kw):
    return torch.mean((student - teacher) ** 2)


def l1_loss(student, teacher, labels, **kw):
    return torch.mean(torch.abs(student - teacher))


def cosine_loss(student, teacher, labels, **kw):
    s, t = _flat(student), _flat(teacher)
    s = s / (torch.linalg.norm(s, dim=-1, keepdim=True) + 1e-8)
    t = t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-8)
    return torch.mean(1.0 - torch.sum(s * t, dim=-1))


def kl_div_loss(student, teacher, labels, temperature: float = 1.0, **kw):
    """KL(teacher || student) on logits with temperature, x T^2 (Hinton KD)."""
    t = float(temperature)
    log_p_s = F.log_softmax(student / t, dim=-1)
    p_t = F.softmax(teacher / t, dim=-1)
    return torch.mean(torch.sum(p_t * (torch.log(p_t + 1e-12) - log_p_s),
                                dim=-1)) * t * t


def smooth_l1_loss(student, teacher, labels, beta: float = 1.0, **kw):
    """torch SmoothL1Loss / Huber: quadratic inside ``beta``, linear out."""
    d = torch.abs(_flat(student) - _flat(teacher))
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta,
                                  d - 0.5 * beta))


def soft_ce_loss(student, teacher, labels, temperature: float = 1.0, **kw):
    """Soft-label cross-entropy H(softmax(teacher/T), log_softmax(student/T))
    x T^2."""
    t = float(temperature)
    log_p_s = F.log_softmax(student / t, dim=-1)
    p_t = F.softmax(teacher / t, dim=-1)
    return -torch.mean(torch.sum(p_t * log_p_s, dim=-1)) * t * t


def attention_transfer_loss(student, teacher, labels, **kw):
    """Attention transfer on (B, T, C) taps: the squared L2 distance of the
    L2-normalised per-position energy maps (sum over channels of x^2)."""
    def amap(x):
        a = torch.sum(torch.square(x.float()), dim=-1)
        a = a.reshape(a.shape[0], -1)
        return a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-8)

    return torch.mean(torch.sum(torch.square(amap(student) - amap(teacher)),
                                dim=-1))


KD_CRITERIA: Dict[str, Callable] = {
    "MSELoss": mse_loss,
    "mse": mse_loss,
    "L1Loss": l1_loss,
    "SmoothL1Loss": smooth_l1_loss,
    "HuberLoss": smooth_l1_loss,
    "CosineLoss": cosine_loss,
    "KDLoss": kl_div_loss,
    "KLDivLoss": kl_div_loss,
    "logits_kd": kl_div_loss,
    "CrossEntropyLoss": soft_ce_loss,
    "soft_ce": soft_ce_loss,
    "ATLoss": attention_transfer_loss,
    "attention_transfer": attention_transfer_loss,
}


def get_mid_level_loss(criterion_config: dict) -> Tuple[Callable, dict]:
    """torchdistill-style lookup: {'key': name, 'kwargs': {...}} -> (fn, kwargs)."""
    key = criterion_config.get("key", "MSELoss")
    if key not in KD_CRITERIA:
        raise ValueError(f"Unknown KD criterion {key!r}; have {sorted(KD_CRITERIA)}")
    return KD_CRITERIA[key], dict(criterion_config.get("kwargs", {}))


# ----------------------------------------------------------- tap resolution

_LAYER_RE = re.compile(r"(?:^|\.)(?:model\.)?encoder\.layers\.(\d+)$")

# reference module names under the JAX package's ``backend`` module
_BACKEND_NAMES = frozenset({
    "LL", "first_bn", "first_bn1",
    "GAT_layer_S", "GAT_layer_T",
    "HtrgGAT_layer_ST11", "HtrgGAT_layer_ST12",
    "HtrgGAT_layer_ST21", "HtrgGAT_layer_ST22",
    "pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2", "pool_hT2",
    "conformer",
})


def normalize_tap_path(path: str) -> str:
    """Translate a reference torch module path to a tap path (the JAX
    package's function): SSL encoder layers, AASIST graph modules,
    Conformer blocks (``conformer.encoder_blocks.N[.sub]``), Sequential
    indices (``encoder.3``) and slash paths."""
    p = path.replace("module.", "")
    p = re.sub(r"encoder_blocks\.(\d+)", r"block_\1", p)
    m = _LAYER_RE.search(p)
    if m:
        return f"ssl_hidden:{m.group(1)}"
    if p in ("ssl_model", "ssl_model.model", "ssl_model.model.encoder"):
        return "ssl_model"
    if p in ("", ".", "logits", "out_layer", "fc5", "output",
             "backend.out_layer", "conformer.fc5", "backend.conformer.fc5"):
        return "logits"
    if p.startswith("block_"):
        p = "conformer." + p
    m = re.fullmatch(r"(?:backend\.)?encoder\.(\d+)", p)
    if m:
        return f"backend/encoder_{m.group(1)}"
    if p in ("encoder", "backend.encoder"):
        return "backend/encoder_5"
    if p in ("attention", "backend.attention"):
        return "backend/att_conv2"
    parts = p.split(".")
    if parts[0] in _BACKEND_NAMES:
        parts = ["backend"] + parts
    return "/".join(parts)


def resolve_tap(tap_path: str, logits: torch.Tensor,
                captured: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The activation of ``tap_path`` from a forward's logits and captured
    taps."""
    if tap_path == "logits":
        return logits
    if tap_path not in captured:
        raise KeyError(f"tap path {tap_path!r} not found in intermediates")
    return captured[tap_path]


# ------------------------------------------------------------- weight copy

_LAYER_KEY = re.compile(r"^(.*\bencoder\.layers\.)(\d+)\.(.*)$")


def _num_layers(names) -> int:
    return 1 + max((int(m.group(2)) for m in map(_LAYER_KEY.match, names)
                    if m), default=-1)


@torch.no_grad()
def copy_teacher_weights(student: nn.Module, teacher: nn.Module,
                         layer_indices: Optional[Sequence[int]] = None
                         ) -> list:
    """The JAX package's strict=False copy, on parameters only (the
    BatchNorm statistics stay at the student's init, as the JAX CLI copies
    ``params`` alone): every student parameter whose name and shape match
    the teacher's takes the teacher's values, cast to the student's dtype,
    written into the student's own storage. Student transformer layer ``j``
    reads teacher layer ``layer_indices[j]``; without indices a layer is
    copied only when both have as many layers (the JAX stacked leaf's
    shapes agree). Returns the names copied."""
    t_params = dict(teacher.named_parameters())
    s_names = [n for n, _ in student.named_parameters()]
    n_t, n_s = _num_layers(t_params), _num_layers(s_names)
    if layer_indices is not None:
        bad = [i for i in layer_indices if not 0 <= int(i) < n_t]
        if bad:
            raise ValueError(f"layer indices {bad} out of range for a "
                             f"teacher of {n_t} layers")
    copied = []
    for name, p in student.named_parameters():
        m = _LAYER_KEY.match(name)
        src_name = name
        if m:
            j = int(m.group(2))
            if layer_indices is not None:
                if j >= len(layer_indices):
                    continue
                src_name = f"{m.group(1)}{int(layer_indices[j])}.{m.group(3)}"
            elif n_t != n_s:
                continue
        src = t_params.get(src_name)
        if src is not None and src.shape == p.shape:
            p.copy_(src.to(p.dtype))
            copied.append(name)
    return copied


# --------------------------------------------------------------- KD step

def build_criteria(kd_kwargs: dict) -> list:
    """[(fn, kwargs, student tap, teacher tap, weight, metric name)] of a
    ``kd_kwargs`` block; a weights list of another length raises."""
    criterions = list(kd_kwargs.get("kd_criterions", []))
    weights = [float(w) for w in kd_kwargs.get(
        "kd_criterion_weights", [1.0] * len(criterions))]
    if len(weights) != len(criterions):
        raise ValueError(
            f"kd_criterion_weights has {len(weights)} entries for "
            f"{len(criterions)} kd_criterions")
    crits = []
    for cfg_i, w in zip(criterions, weights):
        fn, kw = get_mid_level_loss(cfg_i)
        sp = normalize_tap_path(kw.pop("student_module_path", "logits"))
        tp = normalize_tap_path(kw.pop("teacher_module_path", "logits"))
        crits.append((fn, kw, sp, tp, w,
                      f"{cfg_i.get('key', 'MSELoss')}_{sp}_{tp}"))
    return crits


def make_kd_train_step(kd_kwargs: dict, *,
                       ce_weight: Optional[Sequence[float]] = (0.9, 0.1),
                       preemph: Optional[float] = 0.97,
                       rawboost_algo: Optional[int] = None,
                       pre_aug_list: Tuple[str, ...] = (),
                       aug_list: Tuple[str, ...] = (),
                       sample_rate: float = 16000.0
                       ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, teacher, waves, labels, seed) -> metrics``: one
    distillation step of the student ``state`` (its step count advances)
    against ``teacher`` (untouched). Metrics: ``total_loss``, ``ce_loss``,
    ``num_correct`` and each criterion's weighted term under
    ``{key}_{student tap}_{teacher tap}``, on the device."""
    ce_loss_weight = float(kd_kwargs.get("ce_loss_weight", 1.0))
    crits = build_criteria(kd_kwargs)
    t_names = {c[3] for c in crits} - {"logits"}
    s_names = {c[2] for c in crits} - {"logits"}

    def step(state: TrainState, teacher: nn.Module, waves: torch.Tensor,
             labels: torch.Tensor, seed: int) -> Dict[str, torch.Tensor]:
        k_aug, k_drop = step_seeds(seed, state.step)
        waves = preprocess_train(waves, k_aug, preemph=preemph,
                                 rawboost_algo=rawboost_algo,
                                 pre_aug_list=pre_aug_list, aug_list=aug_list,
                                 sample_rate=sample_rate)
        # no_grad, not inference_mode: a criterion's autograd may keep
        # the teacher's taps
        teacher.eval()
        with torch.no_grad(), taps.capture(t_names) as t_taps:
            t_logits = teacher(waves)
        model, opt = state.model, state.optimizer
        model.train()
        with taps.capture(s_names) as s_taps:
            s_logits = model(waves, src=dropout.source(k_drop))
        ce = weighted_cross_entropy(s_logits, labels, ce_weight)
        terms, kd_total = {}, 0.0
        for fn, kw, sp, tp, w, name in crits:
            term = fn(resolve_tap(sp, s_logits, s_taps).float(),
                      resolve_tap(tp, t_logits, t_taps).float(),
                      labels, **kw) * w
            terms[name] = term.detach()
            kd_total = kd_total + term
        total = ce_loss_weight * ce + kd_total
        opt.zero_grad(set_to_none=True)
        total.backward()
        opt.step()
        state.step += 1
        return {"total_loss": total.detach(), "ce_loss": ce.detach(),
                "num_correct": (s_logits.detach().argmax(-1) == labels).sum(),
                **terms}

    return step


class KDTrainer:
    """The JAX package's ``KDTrainer`` on one device: ``train()`` one epoch
    of distillation steps with each metric's running mean logged every 2%
    of the epoch, ``test(is_dev)`` the student's dev or test pass."""

    def __init__(self, teacher: nn.Module, state: TrainState, kd_kwargs: dict,
                 train_loader, dev_loader, test_loader, logger, exp_config,
                 device: torch.device, rng_seed: int = 1024):
        self.teacher = teacher
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
        self.kd_step = make_kd_train_step(
            kd_kwargs, ce_weight=tuple(exp_config.ce_weight), preemph=preemph,
            rawboost_algo=pick_rawboost_algo(da),
            pre_aug_list=pre_device_augs(da),
            aug_list=post_device_augs(da, exp_config.allow_data_augmentation),
            sample_rate=float(exp_config.sample_rate))
        self.eval_step = make_eval_step(state.model,
                                        ce_weight=tuple(exp_config.ce_weight),
                                        preemph=preemph)

    def train(self) -> float:
        """One epoch. Returns the mean total loss."""
        self.train_loader.set_epoch(self.epoch)
        meters: Dict[str, Any] = {}
        log_every = max(int(len(self.train_loader) * 0.02), 1)
        num_correct = num_total = iter_count = 0
        pending = []                   # read back only at log points

        def flush():
            nonlocal num_correct
            for metrics, bsz in pending:
                for k, v in metrics.items():
                    if k == "num_correct":
                        num_correct += int(v)
                        continue
                    meters.setdefault(k, AverageMeter(k)).update(float(v), bsz)
            pending.clear()

        for batch in self.train_loader:
            waves, labels = to_device(batch, self.device)
            pending.append((self.kd_step(self.state, self.teacher, waves,
                                         labels, self.seed), waves.shape[0]))
            num_total += waves.shape[0]
            iter_count += 1
            if iter_count >= log_every:
                flush()
                self.logger.wandbLog({k: m.avg for k, m in meters.items()},
                                     step=self.state.step)
                iter_count = 0
        flush()
        self.logger.wandbLog({"Train Acc": 100.0 * num_correct
                              / max(num_total, 1)})
        self.epoch += 1
        return meters["total_loss"].avg if meters else 0.0

    def test(self, is_dev: bool = False) -> Tuple[float, float]:
        """The student's dev (or test) pass, as ``Trainer.test``."""
        loader = self.dev_loader if is_dev else self.test_loader
        eval_loss, accuracy, scores, labels = run_eval_loop(
            self.eval_step, loader, self.device)
        logs = {"Dev Acc": accuracy, "Dev Loss": eval_loss}
        if len(np.unique(labels)) == 2:
            logs["Dev EER"] = compute_eer(scores, labels, pos_label=1)
        self.logger.wandbLog(logs)
        return eval_loss, accuracy

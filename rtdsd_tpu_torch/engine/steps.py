"""Train, eval and score steps: the port of ``rtdsd_tpu/engine/steps.py``.

A train step is augmentation -> train-mode forward -> weighted
cross-entropy -> backward -> AdamW step, all on the model's device; its
metrics stay there until the caller reads them. The augmentation runs in
the order of the JAX package's ``_preprocess_train``: RawBoost, or else
the dataset-side ``mul_augment`` chain's device half, then pre-emphasis,
then the trainer-side chain (gated by ``allow_data_augmentation``). Its
randomness (the augmentations' draws and the dropout masks) comes from
generators seeded by (seed, step),
as the JAX step folds the step into its key, so a resumed run draws what an
unbroken one draws. The eval step applies pre-emphasis, as the reference's
dev pass does; the score step does not, as its score files are made.

Freezing: a parameter is frozen by the JAX package's pattern rules
(``_freeze_mask`` and ``_mask_stacked_layers``): plain patterns are
substrings of the reference's parameter names, and a pattern with
``layers.{i}`` addresses transformer layer ``i``, which in the port is the
parameters under ``encoder.layers.{i}.`` (the JAX layers are one stacked
leaf, the port's are modules). A frozen parameter is left out of the
optimizer, so it gets neither an update nor weight decay, as optax's
``set_to_zero`` gives it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtdsd_tpu_torch.models import dropout
from rtdsd_tpu_torch.ops.augment import augment
from rtdsd_tpu_torch.ops.preemphasis import pre_emphasis
from rtdsd_tpu_torch.ops.rawboost import RawBoostArgs, rawboost

_DEFERRED = "ROADMAP Queue 1, item 7"


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           weight: Optional[Sequence[float]] = None
                           ) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss(weight=w)``: sum(w[y] nll) / sum(w[y]),
    in float32; the plain mean without ``weight``."""
    nll = _nll(logits, labels)
    if weight is None:
        return nll.mean()
    w = _row_weights(weight, labels)
    return (w * nll).sum() / w.sum()


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def _row_weights(weight: Sequence[float], labels: torch.Tensor
                 ) -> torch.Tensor:
    return torch.tensor(list(weight), dtype=torch.float32,
                        device=labels.device)[labels.long()]


# ------------------------------------------------------- freeze and re-init

_LAYER_IDX_RE = re.compile(r"layers[./](\d+)")
_LAYER_OF_RE = re.compile(r"(?:^|\.)encoder\.layers\.(\d+)\.")


def _split_layer_patterns(patterns: Sequence[str]
                          ) -> Tuple[List[str], List[Tuple[int, str]]]:
    """-> (plain substring patterns, [(layer index, rest of the pattern)])."""
    plain, indexed = [], []
    for p in patterns:
        m = _LAYER_IDX_RE.search(p)
        if m:
            indexed.append((int(m.group(1)), p[m.end():].strip("./")))
        else:
            plain.append(p)
    return plain, indexed


def _layer_of(name: str) -> Optional[int]:
    m = _LAYER_OF_RE.search(name)
    return int(m.group(1)) if m else None


def is_trainable(name: str, freeze_patterns: Sequence[str] = (),
                 unfreeze_patterns: Sequence[str] = ()) -> bool:
    """The JAX package's freeze rules for the parameter ``name``: frozen if
    a plain freeze pattern matches and no unfreeze pattern does, or if a
    layer-indexed freeze pattern names its layer; a layer-indexed unfreeze
    pattern keeps its layer trainable, and under a plain freeze it keeps
    only the layers it names."""
    plain_f, idx_f = _split_layer_patterns(freeze_patterns or ())
    plain_u, idx_u = _split_layer_patterns(unfreeze_patterns or ())
    f_hit = any(p in name for p in plain_f)
    u_hit = any(p in name for p in plain_u)
    layer = _layer_of(name)
    if layer is None:
        return u_hit or not f_hit
    unfr = [i for i, rest in idx_u if not rest or rest in name]
    froz = [i for i, rest in idx_f if not rest or rest in name]
    if f_hit and not u_hit and not unfr:
        return False
    if f_hit and not u_hit:
        return layer in unfr
    if froz:
        return layer not in froz or layer in unfr
    return True


def make_optimizer(model: nn.Module, lr: float, weight_decay: float,
                   freeze_patterns: Sequence[str] = (),
                   unfreeze_patterns: Sequence[str] = (),
                   optimizer: str = "adamw",
                   mu_dtype: Optional[str] = None) -> torch.optim.AdamW:
    """AdamW with torch's defaults (betas 0.9 / 0.999, eps 1e-8) and decay
    on every trainable parameter, as the reference and the JAX package.
    Frozen parameters get ``requires_grad = False`` and stay out of it."""
    if optimizer == "adafactor" or mu_dtype:
        raise NotImplementedError(
            f"optimizer {optimizer!r} with adam_mu_dtype {mu_dtype!r} is not "
            f"yet ported ({_DEFERRED}); use optimizer 'adamw' and no "
            "adam_mu_dtype")
    if optimizer != "adamw":
        raise ValueError(f"unknown optimizer {optimizer!r} "
                         "(have: adamw, adafactor)")
    params = []
    for name, p in model.named_parameters():
        train = is_trainable(name, freeze_patterns, unfreeze_patterns)
        p.requires_grad_(train)
        if train:
            params.append(p)
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@torch.no_grad()
def reinit_params(module: nn.Module, patterns: Sequence[str], seed: int
                  ) -> List[str]:
    """Xavier-uniform re-init of the parameters of two or more dimensions
    whose name a plain pattern matches, or that a layer-indexed pattern
    ``layers.{i}[.rest]`` names; drawn on the CPU from ``seed``, in
    ``named_parameters`` order. Returns the names re-initialised."""
    plain, indexed = _split_layer_patterns(patterns or ())
    gen = torch.Generator().manual_seed(seed)
    done = []
    for name, p in module.named_parameters():
        if p.dim() < 2:
            continue
        layer = _layer_of(name)
        if (any(pat in name for pat in plain) or any(
                i == layer and (not rest or rest in name)
                for i, rest in indexed)):
            p.copy_(nn.init.xavier_uniform_(torch.empty(p.shape),
                                            generator=gen))
            done.append(name)
    return done


# ------------------------------------------------------------ augmentation

def pick_rawboost_algo(data_augmentation: Sequence[str]) -> Optional[int]:
    """The first k in 1..8 with ``RawBoost{k}`` configured."""
    for k in range(1, 9):
        if f"RawBoost{k}" in data_augmentation:
            return k
    return None


def pre_device_augs(data_augmentation: Sequence[str]) -> Tuple[str, ...]:
    """Dataset-side augmentations (the mul_augment chain): none when a
    RawBoost code is configured (the reference's if/elif)."""
    if pick_rawboost_algo(data_augmentation) is not None:
        return ()
    if "mul_augment" in data_augmentation:
        return ("TST", "GAN", "AIR", "TMK")
    return ()


def post_device_augs(data_augmentation: Sequence[str],
                     allow: bool) -> Tuple[str, ...]:
    """Trainer-side augmentations after pre-emphasis, gated by
    ``allow_data_augmentation``, in the chain's fixed order."""
    if not allow:
        return ()
    return tuple(a for a in ("ACN", "HPF", "LPF", "GAN", "TMK")
                 if a in data_augmentation)


def step_seeds(seed: int, step: int) -> Tuple[int, int]:
    """(augmentation seed, dropout seed) of train step ``step``."""
    a, d = np.random.SeedSequence((int(seed), int(step))).generate_state(
        2, np.uint64)
    return int(a), int(d)


# ------------------------------------------------------------------- steps

def make_train_step(*, ce_weight: Optional[Sequence[float]] = (0.9, 0.1),
                    preemph: Optional[float] = 0.97,
                    rawboost_algo: Optional[int] = None,
                    pre_aug_list: Tuple[str, ...] = (),
                    aug_list: Tuple[str, ...] = (),
                    sample_rate: float = 16000.0
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``step(state, waves, labels, seed) -> {loss, num_correct}``: one
    AdamW step on ``state`` (its step count advances), waves (B, T) float32
    and labels (B,) on the model's device. RawBoost (or the ``pre_aug_list``
    chain) runs on the static-shape crop before pre-emphasis and the
    ``aug_list`` chain after it, as in the JAX package; all draw from one
    generator seeded by the step's augmentation seed."""

    def step(state: TrainState, waves: torch.Tensor, labels: torch.Tensor,
             seed: int) -> Dict[str, torch.Tensor]:
        k_aug, k_drop = step_seeds(seed, state.step)
        gen = torch.Generator(device=waves.device).manual_seed(k_aug)
        if rawboost_algo is not None and 1 <= rawboost_algo <= 8:
            waves = rawboost(waves, rawboost_algo, gen, RawBoostArgs(),
                             sample_rate)
        elif pre_aug_list:
            waves = augment(waves, pre_aug_list, gen, sample_rate)
        if preemph is not None:
            waves = pre_emphasis(waves, preemph)
        if aug_list:
            waves = augment(waves, aug_list, gen, sample_rate)
        model, opt = state.model, state.optimizer
        model.train()
        logits = model(waves, src=dropout.source(k_drop))
        loss = weighted_cross_entropy(logits, labels, ce_weight)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        state.step += 1
        return {"loss": loss.detach(),
                "num_correct": (logits.detach().argmax(-1) == labels).sum()}

    return step


def make_eval_step(model: nn.Module, *,
                   ce_weight: Optional[Sequence[float]] = (0.9, 0.1),
                   preemph: Optional[float] = 0.97
                   ) -> Callable[[torch.Tensor, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """Dev/eval step with pre-emphasis: ``step(waves, labels)`` -> {loss,
    and per row loss_terms, loss_weights, correct, scores} (the per-row
    terms let callers leave the loader's pad rows out of the loss)."""

    def step(waves: torch.Tensor, labels: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        model.eval()
        with torch.inference_mode():
            if preemph is not None:
                waves = pre_emphasis(waves, preemph)
            logits = model(waves)
            nll = _nll(logits, labels)
            w = (_row_weights(ce_weight, labels) if ce_weight is not None
                 else torch.ones_like(nll))
            return {"loss": weighted_cross_entropy(logits, labels, ce_weight),
                    "loss_terms": w * nll, "loss_weights": w,
                    "correct": logits.argmax(-1) == labels,
                    "scores": logits[:, 1]}

    return step


def make_score_step(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """Waves (B, T) on the model's device -> the raw bonafide logit (B,),
    with NO pre-emphasis, as the reference's score files are made."""

    def step(waves: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(waves)[:, 1]

    return step

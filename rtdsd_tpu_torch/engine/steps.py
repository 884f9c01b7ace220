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
leaf, the port's are modules). A frozen parameter gets neither an update
nor weight decay, as optax's ``set_to_zero`` gives it.

Optimizers (``make_optimizer``): AdamW is ``torch.optim.AdamW``;
``adam_mu_dtype`` and ``optimizer: adafactor`` are the port's own
:class:`AdamWLowPrecisionMu` and :class:`Adafactor`, which compute what
optax's ``adamw(mu_dtype=...)`` and ``adafactor`` compute.
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


def _block_of(name: str) -> str:
    """The JAX leaf of a parameter: a transformer layer's parameter stands
    for the stacked leaf of every layer's."""
    return re.sub(r"(^|\.)encoder\.layers\.\d+\.", r"\1encoder.layers.*.",
                  name)


def _in_transform(name: str, freeze_patterns: Sequence[str] = (),
                  unfreeze_patterns: Sequence[str] = ()) -> bool:
    """Whether the JAX optimizer updates the leaf holding ``name`` (its
    ``_freeze_mask``): a transformer layer's parameter frozen only by a
    layer-indexed rule is in it, its slice masked after the update."""
    plain_f, _ = _split_layer_patterns(freeze_patterns or ())
    plain_u, idx_u = _split_layer_patterns(unfreeze_patterns or ())
    if any(p in name for p in plain_u):
        return True
    if _layer_of(name) is not None and any(not r or r in name
                                           for _, r in idx_u):
        return True
    return not any(p in name for p in plain_f)


def make_optimizer(model: nn.Module, lr: float, weight_decay: float,
                   freeze_patterns: Sequence[str] = (),
                   unfreeze_patterns: Sequence[str] = (),
                   optimizer: str = "adamw",
                   mu_dtype: Optional[str] = None) -> torch.optim.Optimizer:
    """The JAX package's ``make_optimizer`` over ``model``'s trainable
    parameters: AdamW with torch's defaults (betas 0.9 / 0.999, eps 1e-8)
    and decay on every trainable parameter, as the reference; with
    ``mu_dtype`` its first moment stored in that dtype
    (:class:`AdamWLowPrecisionMu`); ``optimizer="adafactor"`` optax's
    Adafactor (:class:`Adafactor`). Frozen parameters get
    ``requires_grad = False`` and stay out of it; under Adafactor a
    transformer layer frozen by a layer-indexed rule keeps its gradient,
    which enters the statistics of its stacked JAX leaf, and gets no
    update, as in JAX."""
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r} "
                         "(have: adamw, adafactor)")
    named = list(model.named_parameters())
    train = {n: is_trainable(n, freeze_patterns, unfreeze_patterns)
             for n, _ in named}
    if optimizer == "adafactor":
        blocks: Dict[str, list] = {}
        for n, p in named:
            live = _in_transform(n, freeze_patterns, unfreeze_patterns)
            p.requires_grad_(live)
            if live:
                blocks.setdefault(_block_of(n), []).append((p, train[n]))
        return Adafactor(list(blocks.values()), lr, weight_decay)
    params = []
    for n, p in named:
        p.requires_grad_(train[n])
        if train[n]:
            params.append(p)
    if mu_dtype:
        return AdamWLowPrecisionMu(params, lr, weight_decay,
                                   getattr(torch, mu_dtype))
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


class AdamWLowPrecisionMu(torch.optim.Optimizer):
    """optax's ``adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd,
    mu_dtype=...)``: the first moment stored in ``mu_dtype``; each step
    computes the new first moment in float32 from the stored one, takes the
    update from that float32 value and only then rounds the stored copy.
    The second moment stays float32. ``torch.optim.AdamW`` keeps its
    moments in the parameters' dtype, so it cannot do this."""

    def __init__(self, params, lr: float, weight_decay: float,
                 mu_dtype: torch.dtype, betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      betas=tuple(betas), eps=eps))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            # optax's (1 - b1) g + b1 mu as the jitted step computes it: b1
            # rounded to the stored dtype, the products and the sum float32
            b1_low = float(torch.tensor(b1, dtype=self.mu_dtype))
            by_step: Dict[int, list] = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["mu"] = torch.zeros_like(p, dtype=self.mu_dtype)
                    st["nu"] = torch.zeros_like(p, dtype=torch.float32)
                by_step.setdefault(st["step"], []).append(p)
            for t, ps in by_step.items():
                t += 1
                sts = [self.state[p] for p in ps]
                g = [p.grad.float() for p in ps]
                mu = torch._foreach_mul(g, 1 - b1)
                low = torch._foreach_mul([st["mu"].float() for st in sts],
                                         b1_low)
                torch._foreach_add_(mu, low)
                nu = [st["nu"] for st in sts]
                torch._foreach_mul_(nu, b2)
                torch._foreach_add_(nu, torch._foreach_mul(
                    torch._foreach_mul(g, g), 1 - b2))
                # optax's bias corrections, 1 - b ** count in float32
                c1, c2 = (float(1 - np.float32(b) ** np.float32(t))
                          for b in (b1, b2))
                den = torch._foreach_sqrt(torch._foreach_div(nu, c2))
                torch._foreach_add_(den, eps)
                u = torch._foreach_div(torch._foreach_div(mu, c1), den)
                torch._foreach_add_(u, torch._foreach_mul(ps, wd))
                torch._foreach_mul_(u, lr)
                torch._foreach_sub_(ps, u)
                torch._foreach_copy_([st["mu"] for st in sts], mu)
                for st in sts:
                    st["step"] = t
        return None

    def load_state_dict(self, state_dict) -> None:
        """torch casts restored moments to the parameters' dtype: the
        first moment goes back to ``mu_dtype`` (exact, it was saved in
        it)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            st["mu"] = st["mu"].to(self.mu_dtype)


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the two largest axes, when the smaller
    of them has at least 128 entries."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """optax's ``adafactor(lr, weight_decay_rate=wd or None)``, its chain
    step for step: ``scale_by_factored_rms`` (decay 1 - (t + 1)^-0.8, eps
    1e-30, the second moment factored over a tensor's two largest axes
    when both have at least 128 entries), ``clip_by_block_rms(1.0)``, the
    learning rate, ``scale_by_param_block_rms`` (at least 1e-3),
    ``add_decayed_weights(wd)`` when wd is not 0, and the descent.

    A block is one JAX leaf. The JAX encoder's layers are one stacked
    leaf, so a block here is a list of the port's tensors: a transformer
    layer's parameter with the same parameter of every other layer, each
    other parameter alone. Each member is ``(parameter, applied)``: a
    member not applied (a layer frozen by index) enters the block's
    statistics and is not updated, as JAX masks its slice after the
    update. Factoring stays per tensor, as the stacked leaf's two largest
    axes are a layer's own."""

    def __init__(self, blocks: Sequence[Sequence[Tuple[torch.Tensor, bool]]],
                 lr: float, weight_decay: float = 0.0):
        groups = [{"params": [p for p, _ in b], "applied": [a for _, a in b]}
                  for b in blocks]
        super().__init__(groups, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = group["params"]
            us = [self._scaled(p) for p in ps]
            n = sum(u.numel() for u in us)
            rms = (sum((u * u).sum() for u in us) / n).sqrt()
            clip = torch.clamp(rms / 1.0, min=1.0)
            p_rms = (sum((p * p).sum() for p in ps) / n).sqrt()
            p_rms = torch.where(p_rms <= 1e-3, torch.full_like(p_rms, 1e-3),
                                p_rms)
            wd = group["weight_decay"]
            for p, u, applied in zip(ps, us, group["applied"]):
                u = u / clip * group["lr"] * p_rms
                if wd:
                    u = u + wd * p
                if applied:
                    p.sub_(u)
        return None

    def _scaled(self, p: torch.Tensor) -> torch.Tensor:
        """``scale_by_factored_rms`` of one tensor: moves its statistics and
        returns the gradient over their root."""
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        st = self.state[p]
        dims = _factored_dims(tuple(p.shape))
        if not st:
            st["step"] = 0
            if dims is None:
                st["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                st["v_row"] = torch.zeros_like(p.select(d0, 0))
                st["v_col"] = torch.zeros_like(p.select(d1, 0))
        decay = 1.0 - float(np.float32(st["step"] + 1) ** np.float32(-0.8))
        st["step"] += 1
        g2 = g * g + 1e-30
        if dims is None:
            st["v"] = decay * st["v"] + (1.0 - decay) * g2
            return g * st["v"] ** -0.5
        d1, d0 = dims
        st["v_row"] = decay * st["v_row"] + (1.0 - decay) * g2.mean(dim=d0)
        st["v_col"] = decay * st["v_col"] + (1.0 - decay) * g2.mean(dim=d1)
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_col_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
        row_factor = (st["v_row"] / row_col_mean) ** -0.5
        col_factor = st["v_col"] ** -0.5
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)


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


def preprocess_train(waves: torch.Tensor, aug_seed: int, *,
                     preemph: Optional[float], rawboost_algo: Optional[int],
                     pre_aug_list: Tuple[str, ...], aug_list: Tuple[str, ...],
                     sample_rate: float) -> torch.Tensor:
    """The JAX package's ``_preprocess_train``: RawBoost (or the
    ``pre_aug_list`` chain) on the crop, pre-emphasis, then the
    ``aug_list`` chain, all drawing from one generator seeded by
    ``aug_seed``."""
    gen = torch.Generator(device=waves.device).manual_seed(aug_seed)
    if rawboost_algo is not None and 1 <= rawboost_algo <= 8:
        waves = rawboost(waves, rawboost_algo, gen, RawBoostArgs(),
                         sample_rate)
    elif pre_aug_list:
        waves = augment(waves, pre_aug_list, gen, sample_rate)
    if preemph is not None:
        waves = pre_emphasis(waves, preemph)
    if aug_list:
        waves = augment(waves, aug_list, gen, sample_rate)
    return waves


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
        waves = preprocess_train(waves, k_aug, preemph=preemph,
                                 rawboost_algo=rawboost_algo,
                                 pre_aug_list=pre_aug_list, aug_list=aug_list,
                                 sample_rate=sample_rate)
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

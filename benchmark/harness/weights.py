"""Random weights from a seed, made on the device in one draw.

One ``torch.Generator`` on the device draws every float value the model
holds as a single standard-normal tensor; each parameter is a view of it,
scaled in place by a rule on its name and shape. The same seed gives the
same weights on the same device type.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from benchmark.harness.runner import family

SEED_MASK = (1 << 63) - 1


def _rule(name: str, shape: Tuple[int, ...]):
    """(scale, shift) of a standard normal for a float leaf, or ``None``
    for a constant set afterwards."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("pos_S", "master1", "master2"):
        return 1.0, 0.0
    if leaf.startswith("att_weight"):
        return shape[0] ** -0.5, 0.0
    if leaf in ("bias", "running_mean"):
        return 0.02, 0.0
    if leaf == "running_var":
        return 0.1, 0.0                        # then exp'd: positive
    if len(shape) == 1:                        # norm scales
        return None
    fan_in = 1
    for s in shape[1:]:
        fan_in *= s
    return fan_in ** -0.5, 0.0


@torch.no_grad()
def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``shapes`` (a reference's ``param_shapes``), in
    their order: linear and conv weights N(0, 1/fan_in), biases and
    BatchNorm means N(0, 0.02^2), BatchNorm variances exp(N(0, 0.1^2)),
    norm scales 1, AASIST's edge vectors N(0, 1/Do), its positional and
    master nodes N(0, 1), step counters 0."""
    floats = [(n, s) for n, s in shapes.items()
              if n.rsplit(".", 1)[-1] != "num_batches_tracked"]
    total = sum(_numel(s) for _, s in floats)
    gen = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for name, shape in floats:
        n = _numel(shape)
        t = flat[off:off + n].view(shape)
        off += n
        rule = _rule(name, shape)
        if rule is None:
            t.fill_(1.0)
        else:
            scale, shift = rule
            t.mul_(scale).add_(shift)
            if name.endswith("running_var"):
                t.exp_()
        out[name] = t
    for name, shape in shapes.items():
        if name not in out:
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return out


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def model_weights(cfg: dict, seed: int, device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """The weights of a configuration file's model from ``seed``, drawn
    for the parameters its family's reference names. Where the file's
    ``weights`` block says ``graph_pool_scores: zero``, the scoring
    vectors of AASIST's six graph pools are zero: every node then
    scores the same in any precision, and each pool keeps its first nodes
    by index (a random-weight pool otherwise ranks near-ties that bf16
    rounding reorders)."""
    ref = family(cfg).reference
    w = make_weights(ref.param_shapes(ref.ModelShape(cfg)), seed, device)
    if cfg.get("weights", {}).get("graph_pool_scores") == "zero":
        for name, t in w.items():
            if name.startswith("pool_") and name.endswith(".proj.weight"):
                t.zero_()
    return w

"""Train-mode dropout of the port's models, driven by explicit generators.

Every dropout site of the models calls :func:`drop` with a CPU
``torch.Generator`` (the *seed source*): each call draws one seed from it
and draws its mask from a generator on the tensor's device seeded with it.
A train step seeds the source from (seed, step), so the masks of a step are
a function of those two numbers, as ``fold_in(key, step)`` makes them in
the JAX package (the masks themselves cannot match across frameworks).

A rematerialised layer draws its own seed from the source *outside* the
checkpointed region and seeds a fresh source from it inside
(:func:`source`): ``torch.utils.checkpoint`` restores only the global RNG
state, so a generator advanced by the forward would draw other masks in the
recompute and the gradients would be silently wrong.
"""

from __future__ import annotations

from typing import Optional

import torch

_SEED_HIGH = 2 ** 62


def next_seed(src: Optional[torch.Generator]) -> int:
    """One seed drawn from ``src`` (``None``: torch's global generator)."""
    return int(torch.randint(_SEED_HIGH, (), generator=src))


def source(seed: int) -> torch.Generator:
    """A CPU seed source seeded with ``seed``."""
    return torch.Generator().manual_seed(seed)


def drop(x: torch.Tensor, p: float,
         src: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - p`` and
    scaled by ``1 / (1 - p)``, as flax's ``nn.Dropout``; the identity at
    ``p == 0``."""
    if p <= 0.0:
        return x
    if p >= 1.0:
        return torch.zeros_like(x)
    gen = torch.Generator(device=x.device).manual_seed(next_seed(src))
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))

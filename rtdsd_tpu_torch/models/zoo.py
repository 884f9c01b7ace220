"""Full model compositions: the port of ``rtdsd_tpu/models/zoo.py``.

``XLSR_AASIST`` is the XLSR front-end (under ``ssl_model.model``, as in the
reference) followed by the AASIST back-end, whose modules sit at the top
level of the state dict like the reference's. ``XLSR_Conformer`` (the
reference's ``Model`` / ``ConformerModel``) is the same front-end followed
by the Conformer head, its modules (``LL``, ``first_bn``, ``conformer``) at
the top level too. The pruned students (``My_XLSR_AASIST``,
``My_XLSR_Conformer``) are the same graphs with fewer ``encoder_layers``.

Both train (``model.train()``, a dropout seed source ``src``, ``remat``
for the encoder's layers).
:func:`init_weights` gives a freshly built model the JAX package's
initialisers, for the parts a checkpoint does not fill.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rtdsd_tpu_torch.models.aasist import AASISTBackend
from rtdsd_tpu_torch.models.conformer import ConformerBackend
from rtdsd_tpu_torch.models.taps import record
from rtdsd_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder


class SSLModel(nn.Module):
    """Holder giving the front-end the reference's ``ssl_model.model`` name."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype,
                 remat: bool = False):
        super().__init__()
        self.model = Wav2Vec2Encoder(cfg, dtype, remat)


def _features(model: nn.Module, wave: Optional[torch.Tensor],
              conv_feats: Optional[torch.Tensor], src=None) -> torch.Tensor:
    """The front-end's features of ``wave`` (B, T) or (B, T, 1), or of conv
    features (B, frames, C) computed elsewhere (``wave`` then ``None``)."""
    if wave is not None and wave.dim() == 3:
        wave = wave[..., 0]
    return record("ssl_model",
                  model.ssl_model.model(wave, conv_feats=conv_feats, src=src))


class XLSR_AASIST(AASISTBackend):
    """Wave (B, T) or (B, T, 1), or ``None`` with ``conv_feats`` (B,
    frames, C), -> logits (B, 2). In train mode ``src`` is the dropout seed
    source (:mod:`.dropout`)."""

    def __init__(self, w2v_cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 fix_out_s1_bug: bool = False, fused_gat: bool = False,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__(feat_dim=w2v_cfg.encoder_embed_dim,
                         fix_out_s1_bug=fix_out_s1_bug, fused_gat=fused_gat,
                         dtype=dtype)
        self.w2v_cfg = w2v_cfg
        self.ssl_model = SSLModel(w2v_cfg, dtype, remat)

    def forward(self, wave: Optional[torch.Tensor], *,
                conv_feats: Optional[torch.Tensor] = None,
                src: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(_features(self, wave, conv_feats, src), src)


class XLSR_Conformer(ConformerBackend):
    """Wave (B, T) or (B, T, 1), or ``None`` with ``conv_feats`` (B,
    frames, C), -> logits (B, 2). In train mode ``src`` is the dropout seed
    source (:mod:`.dropout`)."""

    def __init__(self, w2v_cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 emb_size: int = 144, heads: int = 4, kernel_size: int = 31,
                 n_encoders: int = 4, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__(feat_dim=w2v_cfg.encoder_embed_dim,
                         emb_size=emb_size, heads=heads,
                         kernel_size=kernel_size, n_encoders=n_encoders,
                         dtype=dtype)
        self.w2v_cfg = w2v_cfg
        self.ssl_model = SSLModel(w2v_cfg, dtype, remat)

    def forward(self, wave: Optional[torch.Tensor], *,
                conv_feats: Optional[torch.Tensor] = None,
                src: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(_features(self, wave, conv_feats, src), src)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        w.copy_(torch.nn.init.trunc_normal_(torch.empty(w.shape), 0.0, 1.0,
                                            -2.0, 2.0, generator=gen) * std)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> None:
    """The JAX package's initialisers on a freshly built model, drawn on the
    CPU from ``seed``: linear and conv weights lecun-normal and biases zero
    (flax ``Dense`` / ``Conv``), norms at identity with running statistics
    0 / 1, ``pos_S`` and the master nodes standard normal, edge vectors
    xavier-normal."""
    gen = torch.Generator().manual_seed(seed)
    for name, mod in model.named_modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm,
                              nn.modules.batchnorm._BatchNorm)):
            mod.reset_parameters()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("pos_S", "master1", "master2"):
            p.copy_(torch.randn(p.shape, generator=gen))
        elif leaf.startswith("att_weight"):
            p.copy_(torch.nn.init.xavier_normal_(torch.empty(p.shape),
                                                 generator=gen))

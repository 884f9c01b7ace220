"""Full model compositions: the port of ``rtdsd_tpu/models/zoo.py``.

``XLSR_AASIST`` is the XLSR front-end (under ``ssl_model.model``, as in the
reference) followed by the AASIST back-end, whose modules sit at the top
level of the state dict like the reference's. ``XLSR_Conformer`` (the
reference's ``Model`` / ``ConformerModel``) is the same front-end followed
by the Conformer head, its modules (``LL``, ``first_bn``, ``conformer``) at
the top level too. The pruned students (``My_XLSR_AASIST``,
``My_XLSR_Conformer``) are the same graphs with fewer ``encoder_layers``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rtdsd_tpu_torch.models.aasist import AASISTBackend
from rtdsd_tpu_torch.models.conformer import ConformerBackend, eval_only
from rtdsd_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder


class SSLModel(nn.Module):
    """Holder giving the front-end the reference's ``ssl_model.model`` name."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.model = Wav2Vec2Encoder(cfg, dtype)


def _features(model: nn.Module, wave: Optional[torch.Tensor],
              conv_feats: Optional[torch.Tensor]) -> torch.Tensor:
    """The front-end's features of ``wave`` (B, T) or (B, T, 1), or of conv
    features (B, frames, C) computed elsewhere (``wave`` then ``None``)."""
    if wave is not None and wave.dim() == 3:
        wave = wave[..., 0]
    return model.ssl_model.model(wave, conv_feats=conv_feats)


class XLSR_AASIST(AASISTBackend):
    """Wave (B, T) or (B, T, 1), or ``None`` with ``conv_feats`` (B,
    frames, C), -> logits (B, 2). Eval mode only."""

    def __init__(self, w2v_cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 fix_out_s1_bug: bool = False, fused_gat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(feat_dim=w2v_cfg.encoder_embed_dim,
                         fix_out_s1_bug=fix_out_s1_bug, fused_gat=fused_gat,
                         dtype=dtype)
        self.w2v_cfg = w2v_cfg
        self.ssl_model = SSLModel(w2v_cfg, dtype)

    def forward(self, wave: Optional[torch.Tensor], *,
                conv_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        eval_only(self)
        return super().forward(_features(self, wave, conv_feats))


class XLSR_Conformer(ConformerBackend):
    """Wave (B, T) or (B, T, 1), or ``None`` with ``conv_feats`` (B,
    frames, C), -> logits (B, 2). Eval mode only."""

    def __init__(self, w2v_cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 emb_size: int = 144, heads: int = 4, kernel_size: int = 31,
                 n_encoders: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__(feat_dim=w2v_cfg.encoder_embed_dim,
                         emb_size=emb_size, heads=heads,
                         kernel_size=kernel_size, n_encoders=n_encoders,
                         dtype=dtype)
        self.w2v_cfg = w2v_cfg
        self.ssl_model = SSLModel(w2v_cfg, dtype)

    def forward(self, wave: Optional[torch.Tensor], *,
                conv_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        eval_only(self)
        return super().forward(_features(self, wave, conv_feats))

"""Conformer classifier head in PyTorch: the port of
``rtdsd_tpu/models/conformer.py``.

    XLSR features (B, T, F) -> LL -> BatchNorm2d(1) -> SELU
    -> class token prepended -> n_encoders Conformer blocks -> fc5(row 0)

A block is 0.5 * FF -> MHA with Shaw relative positions -> conv module ->
0.5 * FF -> LayerNorm, each of the first four pre-normed and added to its
input; the conv module is LayerNorm -> pointwise -> GLU -> depthwise ->
BatchNorm -> SiLU -> pointwise.

Module names are the reference's lucidrains names (the keys
``rtdsd_tpu/models/export_reference.py::export_conformer_backend``
writes): ``conformer.encoder_blocks.{i}.ff1.fn.norm``,
``ff1.fn.fn.net.{0,3}``, ``attn.norm``, ``attn.fn.{to_q,to_kv,to_out,
rel_pos_emb}``, ``conv.net.{0,2,4.conv,5,7}``, ``ff2.*``, ``post_norm``,
plus ``LL``, ``first_bn``, ``conformer.class_token`` and
``conformer.fc5``. The pointwise convs ``conv.net.2`` and ``conv.net.7``
are 1x1 ``Conv1d`` weights (out, in, 1), applied as linear layers over the
(B, T, C) layout the JAX package keeps.

As in the JAX package, parameters stay float32, matmuls and convolutions
run in the compute dtype, and LayerNorm and BatchNorm compute in float32.
The head's parts are plain PyTorch, as they are XLA ops (not Pallas) in
JAX: the relative-position term is not part of ``mha_small_t``'s function.

Train mode (``module.train()``) follows the JAX module's ``train=True``:
batch-statistics BatchNorm in ``first_bn`` and the conv module, with
flax's biased running-variance update (``aasist.batch_norm``), and dropout
at the JAX sites (after the feed-forward's SiLU and its second linear, the
attention's output projection, the conv module's output) at the JAX
modules' rate, ``DROPOUT``, which the zoo never sets: 0, so no mask is
drawn. ``src`` is the dropout seed source of a train forward
(:mod:`.dropout`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rtdsd_tpu_torch.models import dropout
from rtdsd_tpu_torch.models.aasist import batch_norm
from rtdsd_tpu_torch.models.taps import record
from rtdsd_tpu_torch.models.wav2vec2 import LN_EPS, _HALF, layer_norm, linear

BN_EPS = 1e-5
MAX_POS_EMB = 512
DROPOUT = 0.0       # the JAX modules' default rate, which the zoo keeps


def _drop(module: nn.Module, x: torch.Tensor, src) -> torch.Tensor:
    return dropout.drop(x, DROPOUT, src) if module.training else x


def pointwise(x: torch.Tensor, conv: nn.Conv1d, dtype: torch.dtype
              ) -> torch.Tensor:
    """A 1x1 ``Conv1d`` (out, in, 1) applied over (B, T, in) as a linear
    layer in the compute dtype."""
    return F.linear(x.to(dtype), conv.weight[..., 0].to(dtype),
                    conv.bias.to(dtype))


class FeedForward(nn.Module):
    """``net.0`` Linear -> SiLU -> dropout -> ``net.3`` Linear -> dropout
    (slots 2 and 4 hold no parameters)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult), nn.SiLU(),
                                 nn.Identity(), nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor, src=None) -> torch.Tensor:
        dt = x.dtype
        h = _drop(self, F.silu(linear(x, self.net[0], dt)), src)
        return _drop(self, linear(h, self.net[3], dt), src)


class PreNorm(nn.Module):
    """lucidrains' ``PreNorm``: ``fn(norm(x))``, the norm in float32."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn

    def forward(self, x: torch.Tensor, src=None) -> torch.Tensor:
        return self.fn(layer_norm(x, self.norm, x.dtype), src)


class Scale(nn.Module):
    """lucidrains' ``Scale``: ``scale * fn(x)``. Records ``fn(x)``, the JAX
    sub-module's output, as the distillation tap ``tap_name``."""

    def __init__(self, scale: float, fn: nn.Module):
        super().__init__()
        self.scale, self.fn = scale, fn
        self.tap_name = "ff"        # its JAX path, set by ConformerBlock

    def forward(self, x: torch.Tensor, src=None) -> torch.Tensor:
        return self.scale * record(self.tap_name, self.fn(x, src))


class ConformerAttention(nn.Module):
    """MHA with Shaw relative position embeddings: the score of query i
    and key j gains ``q_i . E[clip(i - j, -512, 512) + 512] * scale``."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 max_pos_emb: int = MAX_POS_EMB):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.max_pos_emb = heads, dim_head, max_pos_emb
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim)
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, dim_head)

    def forward(self, x: torch.Tensor, src=None) -> torch.Tensor:
        dt = x.dtype
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        scale = dh ** -0.5
        q = linear(x, self.to_q, dt)
        k, v = linear(x, self.to_kv, dt).chunk(2, dim=-1)
        q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2) for t in (q, k, v))
        dots = torch.einsum("bhid,bhjd->bhij", q, k) * scale
        seq = torch.arange(n, device=x.device)
        dist = (seq[:, None] - seq[None, :]).clamp(
            -self.max_pos_emb, self.max_pos_emb) + self.max_pos_emb
        rel = self.rel_pos_emb.weight.to(dt)[dist]                  # (n, n, dh)
        dots = dots + torch.einsum("bhid,ijd->bhij", q, rel) * scale
        out = torch.einsum("bhij,bhjd->bhid", torch.softmax(dots, dim=-1), v)
        out = linear(out.transpose(1, 2).reshape(b, n, h * dh), self.to_out, dt)
        return _drop(self, out, src)


class DepthWiseConv1d(nn.Module):
    """Holder giving the depthwise conv the reference's ``net.4.conv`` name."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, kernel_size, groups=channels)


class ConformerConvModule(nn.Module):
    """``net``: 0 LayerNorm, 2 pointwise (dim -> 2 inner), GLU, 4 depthwise
    with lucidrains' same padding ``(k // 2, k // 2 - (k + 1) % 2)``,
    5 BatchNorm1d, SiLU, 7 pointwise (inner -> dim). Slots 1, 3 and 6 hold
    no parameters."""

    def __init__(self, dim: int, expansion_factor: int = 2,
                 kernel_size: int = 31):
        super().__init__()
        inner = dim * expansion_factor
        self.kernel_size = kernel_size
        self.net = nn.Sequential(
            nn.LayerNorm(dim, eps=LN_EPS), nn.Identity(),
            nn.Conv1d(dim, inner * 2, 1), nn.Identity(),
            DepthWiseConv1d(inner, kernel_size),
            nn.BatchNorm1d(inner, eps=BN_EPS), nn.Identity(),
            nn.Conv1d(inner, dim, 1))

    def depthwise(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) -> (B, T, C), the depthwise conv in the compute dtype."""
        dt, conv, k = x.dtype, self.net[4].conv, self.kernel_size
        xt, w, b = x.transpose(1, 2), conv.weight.to(dt), conv.bias.to(dt)
        if x.device.type == "cpu" and dt in _HALF and k % 2 == 0:
            # the oneDNN fault of the positional conv (wav2vec2.py) makes a
            # grouped bf16 conv1d with an even kernel wrong on the CPU; a
            # depthwise one measured right (torch 2.13), and is kept off
            # that path all the same: the bf16 operands convolved in
            # float32 give a bf16 conv's result
            xt, w, b = xt.float(), w.float(), b.float()
        xt = F.pad(xt, (k // 2, k // 2 - (k + 1) % 2))
        return F.conv1d(xt, w, b, groups=conv.groups).to(dt).transpose(1, 2)

    def forward(self, x: torch.Tensor, src=None) -> torch.Tensor:
        dt, net = x.dtype, self.net
        x = pointwise(layer_norm(x, net[0], dt), net[2], dt)
        a, g = x.chunk(2, dim=-1)
        x = self.depthwise(a * torch.sigmoid(g))                     # GLU
        x = F.silu(batch_norm(x, net[5], dt, channel_dim=-1))
        return _drop(self, pointwise(x, net[7], dt), src)


class ConformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 64,
                 ff_mult: int = 4, conv_expansion_factor: int = 2,
                 conv_kernel_size: int = 31):
        super().__init__()
        self.ff1 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult)))
        self.attn = PreNorm(dim, ConformerAttention(dim, heads, dim_head))
        self.conv = ConformerConvModule(dim, conv_expansion_factor,
                                        conv_kernel_size)
        self.ff2 = Scale(0.5, PreNorm(dim, FeedForward(dim, ff_mult)))
        self.post_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.name_taps("block")

    def name_taps(self, path: str) -> None:
        """Names the block's distillation taps after its JAX path."""
        self.tap_name = path
        self.ff1.tap_name, self.ff2.tap_name = f"{path}/ff1", f"{path}/ff2"

    def forward(self, x: torch.Tensor, src=None) -> torch.Tensor:
        """Records the JAX sub-modules' outputs as distillation taps."""
        tap = self.tap_name
        x = x + self.ff1(x, src)
        x = x + record(f"{tap}/attn", self.attn(x, src))
        x = x + record(f"{tap}/conv", self.conv(x, src))
        x = x + self.ff2(x, src)
        return record(f"{tap}/post_norm", layer_norm(x, self.post_norm, x.dtype))


class MyConformer(nn.Module):
    """Class-token Conformer classifier: (B, T, E) -> (logits, embedding)."""

    def __init__(self, emb_size: int = 144, heads: int = 4, ffmult: int = 4,
                 exp_fac: int = 2, kernel_size: int = 31, n_encoders: int = 4,
                 num_classes: int = 2):
        super().__init__()
        self.encoder_blocks = nn.ModuleList(
            ConformerBlock(emb_size, heads, emb_size // heads, ffmult, exp_fac,
                           kernel_size) for _ in range(n_encoders))
        for i, block in enumerate(self.encoder_blocks):
            block.name_taps(f"backend/conformer/block_{i}")
        self.class_token = nn.Parameter(torch.rand(1, emb_size))
        self.fc5 = nn.Linear(emb_size, num_classes)

    def forward(self, x: torch.Tensor, src=None):
        dt = x.dtype
        token = self.class_token.to(dt)[None].expand(x.shape[0], -1, -1)
        x = torch.cat([token, x], dim=1)
        for block in self.encoder_blocks:
            x = record(block.tap_name, block(x, src))
        embedding = x[:, 0, :]
        return record("backend/conformer",
                      linear(embedding, self.fc5, dt)), embedding


class ConformerBackend(nn.Module):
    """SSL features (B, T, feat_dim) -> LL -> BatchNorm2d(1) over
    (B, 1, T, E) -> SELU -> MyConformer -> logits (B, 2), computed in
    ``dtype``."""

    def __init__(self, feat_dim: int = 1024, emb_size: int = 144,
                 heads: int = 4, kernel_size: int = 31, n_encoders: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.LL = nn.Linear(feat_dim, emb_size)
        self.first_bn = nn.BatchNorm2d(1, eps=BN_EPS)
        self.conformer = MyConformer(emb_size, heads, kernel_size=kernel_size,
                                     n_encoders=n_encoders)

    def forward(self, feats: torch.Tensor, src=None) -> torch.Tensor:
        """``src``: the dropout seed source of a train forward."""
        dt = self.dtype
        x = record("backend/LL", linear(feats, self.LL, dt))
        x = record("backend/first_bn", batch_norm(x[:, None], self.first_bn, dt),
                   True)
        return self.conformer(F.selu(x[:, 0]), src)[0]

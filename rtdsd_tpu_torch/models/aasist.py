"""AASIST spectro-temporal graph-attention back-end in PyTorch: the port
of ``rtdsd_tpu/models/aasist.py``.

Attribute names are the reference's (``LL``, ``first_bn``,
``encoder.{i}.0.conv1``, ``attention.0``, ``GAT_layer_S.att_proj``,
``HtrgGAT_layer_ST11.att_weight11``, ``pool_S.proj``, ``out_layer`` ...), so
reference checkpoints load with ``strict=True`` once the dead
``encoder.{i}.0.bn1`` keys are dropped (see :mod:`.convert`). Layouts are
PyTorch's (NCHW for the 2-D convs); the graph layers take (B, N, D) nodes as
in JAX. Parameters are float32; layers compute in the model's dtype and
BatchNorm (running statistics) normalises in float32, as flax does.

Reference quirks kept, as in the JAX package: ``out_S1 + 1`` instead of
``+ out_S_aug`` unless ``fix_out_s1_bug``; ``Residual_block``'s conv1 reads
the raw input (its bn1 output is dead in the reference).

``fused_gat`` routes the eval-mode graph attention through
:mod:`rtdsd_tpu_torch.ops.gat` (the CUDA kernels on the card); in training,
and without it, the pairwise einsum path runs in plain PyTorch, as the JAX
package gates its kernels (``fused and not train``).

Train mode (``module.train()``) adds the JAX package's dropout (fixed
rates: 0.2 on the graph layers' inputs, 0.3 on the pooling scores' input,
0.2 on the two branches' outputs, 0.5 on the last hidden), drawn from the
seed source ``src`` (:mod:`.dropout`), and BatchNorm with batch statistics
in float32. The running statistics move by ``0.9 * old + 0.1 * batch``
with the *biased* batch variance, as flax's ``BatchNorm(momentum=0.9)``
does (``F.batch_norm`` would use the unbiased one).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rtdsd_tpu_torch.models import dropout
from rtdsd_tpu_torch.models.taps import record
from rtdsd_tpu_torch.models.wav2vec2 import linear
from rtdsd_tpu_torch.ops.gat import fused_gat_aggregate, fused_htrg_gat_aggregate

BN_MOMENTUM = 0.9       # flax's: running = 0.9 * running + 0.1 * batch


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
               dtype: torch.dtype, channel_dim: int = 1) -> torch.Tensor:
    """BatchNorm computed in float32: with the running statistics in eval,
    with the batch's (biased variance) in training, which also moves the
    running statistics as flax does."""
    xf = x.float().movedim(channel_dim, 1)
    if bn.training:
        with torch.no_grad():
            dims = [d for d in range(xf.dim()) if d != 1]
            var, mean = torch.var_mean(xf, dim=dims, correction=0)
            bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
            bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
            bn.num_batches_tracked.add_(1)
        y = F.batch_norm(xf, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)
    else:
        y = F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
    return y.movedim(1, channel_dim).to(dtype)


def _drop(module: nn.Module, x: torch.Tensor, p: float, src) -> torch.Tensor:
    return dropout.drop(x, p, src) if module.training else x


def _edge_weight(out_dim: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(out_dim, 1))


class GraphAttentionLayer(nn.Module):
    """Pairwise-multiplicative node attention (homogeneous graph)."""

    def __init__(self, in_dim: int, out_dim: int, temperature: float = 1.0,
                 dtype: torch.dtype = torch.float32, fused: bool = False):
        super().__init__()
        self.temperature, self.dtype, self.fused = temperature, dtype, fused
        self.att_proj = nn.Linear(in_dim, out_dim)
        self.att_weight = _edge_weight(out_dim)
        self.proj_with_att = nn.Linear(in_dim, out_dim)
        self.proj_without_att = nn.Linear(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim)

    def forward(self, x: torch.Tensor, src=None) -> torch.Tensor:
        x = _drop(self, x, 0.2, src)
        dt = x.dtype
        att_k, att_b = self.att_proj.weight.t(), self.att_proj.bias
        if self.fused and not self.training:
            agg = fused_gat_aggregate(x, att_k, att_b, self.att_weight,
                                      self.temperature).to(dt)
        else:
            att = x[:, :, None, :] * x[:, None, :, :]            # (B, N, N, D)
            att = torch.tanh(att @ att_k.to(dt) + att_b.to(dt))
            att = (att @ self.att_weight.to(dt)) / self.temperature
            att = torch.softmax(att, dim=-2)                           # over j
            agg = torch.einsum("bij,bjd->bid", att[..., 0], x)
        x = (linear(agg, self.proj_with_att, self.dtype)
             + linear(x, self.proj_without_att, self.dtype))
        return F.selu(batch_norm(x, self.bn, self.dtype, channel_dim=-1))


class HtrgGraphAttentionLayer(nn.Module):
    """Heterogeneous S/T graph attention with a master node."""

    def __init__(self, in_dim: int, out_dim: int, temperature: float = 1.0,
                 dtype: torch.dtype = torch.float32, fused: bool = False):
        super().__init__()
        self.temperature, self.dtype, self.fused = temperature, dtype, fused
        self.proj_type1 = nn.Linear(in_dim, in_dim)
        self.proj_type2 = nn.Linear(in_dim, in_dim)
        self.att_proj = nn.Linear(in_dim, out_dim)
        self.att_projM = nn.Linear(in_dim, out_dim)
        self.att_weight11 = _edge_weight(out_dim)
        self.att_weight22 = _edge_weight(out_dim)
        self.att_weight12 = _edge_weight(out_dim)
        self.att_weightM = _edge_weight(out_dim)
        self.proj_with_att = nn.Linear(in_dim, out_dim)
        self.proj_without_att = nn.Linear(in_dim, out_dim)
        self.proj_with_attM = nn.Linear(in_dim, out_dim)
        self.proj_without_attM = nn.Linear(in_dim, out_dim)
        self.bn = nn.BatchNorm1d(out_dim)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                master: Optional[torch.Tensor] = None, src=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        dt = self.dtype
        n1 = x1.shape[1]
        x = torch.cat([linear(x1, self.proj_type1, dt),
                       linear(x2, self.proj_type2, dt)], dim=1)
        if master is None:
            master = x.mean(dim=1, keepdim=True)
        x = _drop(self, x, 0.2, src)
        att_k, att_b = self.att_proj.weight.t(), self.att_proj.bias
        w11, w22, w12 = self.att_weight11, self.att_weight22, self.att_weight12
        if self.fused and not self.training:
            agg = fused_htrg_gat_aggregate(x, att_k, att_b, w11, w22, w12, n1,
                                           self.temperature).to(x.dtype)
        else:
            att_map = self._derive_att_map(x, att_k, att_b, w11, w22, w12, n1)
            agg = torch.einsum("bij,bjd->bid", att_map[..., 0], x)
        master = self._update_master(x, master)
        x = (linear(agg, self.proj_with_att, dt)
             + linear(x, self.proj_without_att, dt))
        x = F.selu(batch_norm(x, self.bn, dt, channel_dim=-1))
        return x[:, :n1], x[:, n1:], master

    def _derive_att_map(self, x, att_k, att_b, w11, w22, w12, n1):
        dt = x.dtype
        att = x[:, :, None, :] * x[:, None, :, :]
        att = torch.tanh(att @ att_k.to(dt) + att_b.to(dt))
        w11, w22, w12 = w11.to(dt), w22.to(dt), w12.to(dt)
        top = torch.cat([att[:, :n1, :n1] @ w11, att[:, :n1, n1:] @ w12], dim=2)
        bot = torch.cat([att[:, n1:, :n1] @ w12, att[:, n1:, n1:] @ w22], dim=2)
        att = torch.cat([top, bot], dim=1) / self.temperature  # (B, N, N, 1)
        return torch.softmax(att, dim=-2)

    def _update_master(self, x, master):
        dt = self.dtype
        att = torch.tanh(linear(x * master, self.att_projM, dt))
        att = (att @ self.att_weightM.to(att.dtype)) / self.temperature
        att = torch.softmax(att, dim=-2)                               # over nodes
        pooled = torch.einsum("bn,bnd->bd", att[..., 0], x)[:, None, :]
        return (linear(pooled, self.proj_with_attM, dt)
                + linear(master, self.proj_without_attM, dt))


class GraphPool(nn.Module):
    """Sigmoid-scored top-k node pooling; kept nodes in descending score
    order, ties broken by the lower node index (as ``lax.top_k``)."""

    def __init__(self, k: float, in_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.k, self.dtype = k, dtype
        self.proj = nn.Linear(in_dim, 1)

    def forward(self, h: torch.Tensor, src=None) -> torch.Tensor:
        z = _drop(self, h, 0.3, src)
        scores = torch.sigmoid(linear(z, self.proj, self.dtype))   # (B, N, 1)
        n_keep = max(int(h.shape[1] * self.k), 1)
        idx = torch.sort(scores[..., 0], dim=1, descending=True,
                         stable=True).indices[:, :n_keep]
        h = h * scores
        return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))


class ResidualBlock(nn.Module):
    """RawNet2-style 2-D conv residual pair (NCHW); conv1 reads the raw
    input, as the reference's forward does."""

    def __init__(self, in_ch: int, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(in_ch, out_ch, (2, 3), padding=(1, 1))
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, (2, 3), padding=(0, 1))
        self.conv_downsample = (nn.Conv2d(in_ch, out_ch, (1, 3), padding=(0, 1))
                                if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.selu(batch_norm(conv2d(x, self.conv1, self.dtype), self.bn2,
                                self.dtype))
        out = conv2d(out, self.conv2, self.dtype)
        identity = x if self.conv_downsample is None \
            else conv2d(x, self.conv_downsample, self.dtype)
        return out + identity


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
                    padding=conv.padding)


class AASISTBackend(nn.Module):
    """Everything downstream of the SSL features: (B, frames, feat_dim) ->
    logits (B, 2)."""

    def __init__(self, feat_dim: int = 1024,
                 filts: Sequence = (128, (1, 32), (32, 32), (32, 64), (64, 64)),
                 gat_dims: Tuple[int, int] = (64, 32),
                 pool_ratios: Tuple[float, ...] = (0.5, 0.5, 0.5, 0.5),
                 temperatures: Tuple[float, ...] = (2.0, 2.0, 100.0, 100.0),
                 num_classes: int = 2, fix_out_s1_bug: bool = False,
                 fused_gat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.fix_out_s1_bug = dtype, fix_out_s1_bug
        g0, g1 = gat_dims
        ch = filts[-1][-1]
        freq = filts[0] // 3                                  # nodes of pos_S
        self.LL = nn.Linear(feat_dim, filts[0])
        self.first_bn = nn.BatchNorm2d(1)
        specs = list(filts[1:])
        specs += [specs[-1]] * (6 - len(specs))
        self.encoder = nn.Sequential(*(nn.Sequential(ResidualBlock(cin, cout, dtype))
                                       for cin, cout in specs))
        self.first_bn1 = nn.BatchNorm2d(ch)
        self.attention = nn.Sequential(
            nn.Conv2d(ch, 128, (1, 1)), nn.SELU(), nn.BatchNorm2d(128),
            nn.Conv2d(128, ch, (1, 1)))
        self.pos_S = nn.Parameter(torch.empty(1, freq, ch))
        self.master1 = nn.Parameter(torch.empty(1, 1, g0))
        self.master2 = nn.Parameter(torch.empty(1, 1, g0))
        gat = lambda t: GraphAttentionLayer(ch, g0, t, dtype, fused_gat)
        self.GAT_layer_S = gat(temperatures[0])
        self.GAT_layer_T = gat(temperatures[1])
        htrg = lambda i, o: HtrgGraphAttentionLayer(i, o, temperatures[2], dtype,
                                                    fused_gat)
        self.HtrgGAT_layer_ST11 = htrg(g0, g1)
        self.HtrgGAT_layer_ST12 = htrg(g1, g1)
        self.HtrgGAT_layer_ST21 = htrg(g0, g1)
        self.HtrgGAT_layer_ST22 = htrg(g1, g1)
        self.pool_S = GraphPool(pool_ratios[0], g0, dtype)
        self.pool_T = GraphPool(pool_ratios[1], g0, dtype)
        # the reference builds pool_hS2 / pool_hT2 with pool_ratios[2] too
        self.pool_hS1 = GraphPool(pool_ratios[2], g1, dtype)
        self.pool_hT1 = GraphPool(pool_ratios[2], g1, dtype)
        self.pool_hS2 = GraphPool(pool_ratios[2], g1, dtype)
        self.pool_hT2 = GraphPool(pool_ratios[2], g1, dtype)
        self.out_layer = nn.Linear(5 * g1, num_classes)

    def forward(self, feats: torch.Tensor, src=None) -> torch.Tensor:
        """``src``: the dropout seed source of a train forward. The JAX
        modules' outputs are recorded as distillation taps
        (:mod:`.taps`)."""
        dt = self.dtype
        x = record("backend/LL", linear(feats, self.LL, dt))    # (B, T, 128)
        x = x.transpose(1, 2)[:, None]                         # (B, 1, 128, T)
        x = F.max_pool2d(x, (3, 3))                            # (B, 1, 42, T//3)
        x = F.selu(record("backend/first_bn",
                          batch_norm(x, self.first_bn, dt), True))
        for i, blk in enumerate(self.encoder):
            x = record(f"backend/encoder_{i}", blk[0](x), True)
        x = F.selu(record("backend/first_bn1",                 # (B, 64, 42, W)
                          batch_norm(x, self.first_bn1, dt), True))

        att = self.attention
        w = F.selu(conv2d(x, att[0], dt))
        w = record("backend/att_conv2",
                   conv2d(batch_norm(w, att[2], dt), att[3], dt), True)

        # spectral branch: softmax over time -> one node per frequency bin
        e_s = (x * torch.softmax(w, dim=3)).sum(dim=3).transpose(1, 2)   # (B, 42, C)
        e_s = e_s + self.pos_S.to(e_s.dtype)
        out_s = self._tapped("pool_S", self._tapped("GAT_layer_S", e_s, src),
                             src)
        # temporal branch: softmax over frequency -> one node per frame
        e_t = (x * torch.softmax(w, dim=2)).sum(dim=2).transpose(1, 2)   # (B, W, C)
        out_t = self._tapped("pool_T", self._tapped("GAT_layer_T", e_t, src),
                             src)

        master1 = self.master1.to(out_t.dtype)
        master2 = self.master2.to(out_t.dtype)

        out_t1, out_s1, m1 = self._tapped("HtrgGAT_layer_ST11", out_t, out_s,
                                          master1, src)
        out_s1 = self._tapped("pool_hS1", out_s1, src)
        out_t1 = self._tapped("pool_hT1", out_t1, src)
        out_t_aug, out_s_aug, m_aug = self._tapped("HtrgGAT_layer_ST12",
                                                   out_t1, out_s1, m1, src)
        out_t1 = out_t1 + out_t_aug
        out_s1 = out_s1 + out_s_aug if self.fix_out_s1_bug else out_s1 + 1
        m1 = m1 + m_aug

        out_t2, out_s2, m2 = self._tapped("HtrgGAT_layer_ST21", out_t, out_s,
                                          master2, src)
        out_s2 = self._tapped("pool_hS2", out_s2, src)
        out_t2 = self._tapped("pool_hT2", out_t2, src)
        out_t_aug, out_s_aug, m_aug = self._tapped("HtrgGAT_layer_ST22",
                                                   out_t2, out_s2, m2, src)
        out_t2 = out_t2 + out_t_aug
        out_s2 = out_s2 + out_s_aug
        m2 = m2 + m_aug

        out_t1, out_t2, out_s1, out_s2, m1, m2 = (
            _drop(self, y, 0.2, src)
            for y in (out_t1, out_t2, out_s1, out_s2, m1, m2))
        out_t = torch.maximum(out_t1, out_t2)
        out_s = torch.maximum(out_s1, out_s2)
        master = torch.maximum(m1, m2)
        last_hidden = torch.cat(
            [out_t.abs().amax(dim=1), out_t.mean(dim=1),
             out_s.abs().amax(dim=1), out_s.mean(dim=1), master[:, 0, :]],
            dim=1)
        last_hidden = _drop(self, last_hidden, 0.5, src)
        return linear(last_hidden, self.out_layer, dt)

    def _tapped(self, name: str, *args):
        """Call the graph module ``name`` and record its output (a typed
        layer's first one, as the JAX taps take a tuple's)."""
        out = getattr(self, name)(*args)
        record(f"backend/{name}", out[0] if isinstance(out, tuple) else out)
        return out

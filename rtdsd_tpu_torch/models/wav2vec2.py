"""wav2vec2-XLSR front-end in PyTorch: the port of
``rtdsd_tpu/models/wav2vec2.py``.

    raw wave (B, T)
    -> strided conv feature extractor (layer_norm or group_norm mode)
    -> layer_norm -> Linear 512 -> 1024
    -> grouped-conv positional embedding (SamePad trim) + GELU, added
    -> N pre-LN transformer layers -> final layer_norm   -> (B, frames, 1024)

Module and attribute names are fairseq's (the state-dict keys of the
reference's ``ssl_model.model``), so a reference checkpoint loads with
``strict=True``. As in the JAX package, parameters stay float32 and every
matmul and convolution runs in the compute dtype, while LayerNorm and
GroupNorm compute their statistics and normalisation in float32.

The attention follows the JAX branch structure: in training with
``attention_dropout > 0`` the probabilities are explicit (the dropout needs
them); with a (b)f16 compute dtype and ``fast_softmax`` on (in training
only with ``fast_softmax_train`` too), the bf16 softmax stays plain PyTorch
(plain einsums in JAX too); every other case goes through
:func:`rtdsd_tpu_torch.ops.attention.mha_small_t`, the port of the Pallas
kernel, which is the CUDA kernel on the card (in training with its float32
backward).

Train mode (``module.train()``) adds dropout at the JAX sites (the encoder
input, attention probabilities, the attention output, the feed-forward
hidden and output), drawn from the seed source passed as ``src``
(:mod:`.dropout`). An encoder built with ``remat=True`` recomputes each
transformer layer in the backward pass (``torch.utils.checkpoint``), as the
JAX package's ``remat_policy: "full"`` does.

With ``w8`` the six transformer matmuls are :class:`W8Linear` (int8
weights) and with ``w8`` and ``a8`` :class:`W8A8Linear` (int8 weights and
per-token int8 activations), the ports of ``W8Dense`` and ``W8A8Dense``;
``models/quantize.py`` makes their weights from a float state dict.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rtdsd_tpu_torch.models import dropout, taps
from rtdsd_tpu_torch.ops import fastgelu
from rtdsd_tpu_torch.ops.attention import mha_small_t

LN_EPS = 1e-5
_HALF = (torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """Same fields and defaults as the JAX package's config, so one config
    file drives both. Fields that only shape the TPU program
    (``scan_unroll``, ``conv_impl``) have nothing to do in the port; of the
    remat fields only ``remat_policy: "full"`` with ``remat_save_every`` 0
    or 1 is ported (ROADMAP Queue 1, item 7). ``conv_segments > 1``
    runs the conv front-end over that many stride-aligned overlapping
    segments batched along B (layer_norm extractor only). As in JAX, ``a8``
    takes effect only together with ``w8``."""

    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2), (512, 3, 2),
        (512, 2, 2), (512, 2, 2))
    extractor_mode: str = "layer_norm"
    conv_bias: bool = True
    encoder_embed_dim: int = 1024
    encoder_ffn_dim: int = 4096
    encoder_heads: int = 16
    encoder_layers: int = 24
    conv_pos: int = 128
    conv_pos_groups: int = 16
    dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    layer_norm_first: bool = True
    scan_unroll: int = 1
    conv_impl: str = "conv"
    remat_policy: str = "full"
    remat_save_every: int = 0
    w8: bool = False
    a8: bool = False
    fast_gelu: bool = True
    fast_softmax: bool = True
    fast_softmax_train: bool = True
    conv_segments: int = 0

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_heads

    @property
    def total_stride(self) -> int:
        s = 1
        for _, _, stride in self.conv_layers:
            s *= stride
        return s

    @property
    def conv_receptive_field(self) -> int:
        """The conv stack's receptive field in samples (XLSR: 400)."""
        rf = 1
        for _, k, s in reversed(self.conv_layers):
            rf = (rf - 1) * s + k
        return rf

    def num_frames(self, num_samples: int) -> int:
        t = num_samples
        for _, k, s in self.conv_layers:
            t = (t - k) // s + 1
        return t


def conv_segment_geometry(cfg: Wav2Vec2Config, seg_frames: int, n_segs: int
                          ) -> Tuple[int, int, int]:
    """(seg_samples, seg_hop, padded_total_samples) of ``n_segs``
    stride-aligned overlapping conv segments of ``seg_frames`` frames each."""
    stride = cfg.total_stride
    seg_samples = cfg.conv_receptive_field + (seg_frames - 1) * stride
    seg_hop = seg_frames * stride
    return seg_samples, seg_hop, (n_segs - 1) * seg_hop + seg_samples


def make_w2v_cfg(num_layers: int = 24, **overrides) -> Wav2Vec2Config:
    """Config with ``encoder_layers = num_layers``; unknown keys are
    ignored, as the JAX package does."""
    fields = {f.name for f in dataclasses.fields(Wav2Vec2Config)}
    kw = {k: v for k, v in overrides.items() if k in fields}
    if "conv_layers" in kw:
        kw["conv_layers"] = tuple(tuple(int(x) for x in l)
                                  for l in kw["conv_layers"])
    cfg = Wav2Vec2Config(encoder_layers=num_layers, **kw)
    if cfg.extractor_mode not in ("layer_norm", "group_norm"):
        raise ValueError(f"unknown extractor_mode {cfg.extractor_mode!r}")
    return cfg


def middle_indices(array_length: int, n: int) -> List[int]:
    start = (array_length - n) // 2
    return list(range(start, start + n))


def resolve_layer_indices(total: int, num_layers: int, order: str = "first",
                          custom_order: Optional[Sequence[int]] = None
                          ) -> List[int]:
    """Layer-subset selection of the pruned students (first / last /
    middle / custom order), as in the JAX package."""
    if num_layers < 1 or num_layers > total:
        raise ValueError(f"num_layers must be in [1, {total}]")
    if order == "first":
        return list(range(num_layers))
    if order == "last":
        return list(range(total - num_layers, total))
    if order == "middle":
        return middle_indices(total, num_layers)
    if custom_order is None:
        raise ValueError("custom order requires custom_order list of ints")
    if not isinstance(custom_order, (list, tuple)):
        raise ValueError("custom_order must be a list of integers")
    bad = [i for i in custom_order if not (0 <= int(i) < total)]
    if bad:
        raise ValueError(f"custom_order indices {bad} out of range "
                         f"[0, {total})")
    return list(custom_order)


def select_layers(state_dict: dict, indices: Sequence[int],
                  prefix: str = "ssl_model.model.") -> dict:
    """State dict of a pruned front-end from a full one: transformer layer
    ``indices[k]`` becomes layer ``k``; every other key is kept."""
    layer = f"{prefix}encoder.layers."
    n_have = 1 + max((int(k[len(layer):].split(".")[0]) for k in state_dict
                      if k.startswith(layer)), default=-1)
    bad = [i for i in indices if not 0 <= int(i) < n_have]
    if bad:
        raise ValueError(f"layer indices {bad} out of range for a front-end "
                         f"of {n_have} layers")
    out = {k: v for k, v in state_dict.items() if not k.startswith(layer)}
    for new, old in enumerate(indices):
        src = f"{layer}{int(old)}."
        for k, v in state_dict.items():
            if k.startswith(src):
                out[f"{layer}{new}.{k[len(src):]}"] = v
    return out


# ------------------------------------------------------------------ int8

def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32, exact.

    ``torch._int_mm`` on both devices (the JAX package leaves this product
    to XLA, outside any kernel). On CUDA it takes more than 16 rows and K,
    N multiples of 8, so the rows are padded with zeros to a multiple of 8,
    at least 24, and sliced off again."""
    k, n = b.shape
    if a.is_cuda and (k % 8 or n % 8):
        raise ValueError(f"int8 matmul on CUDA needs K and N multiples of 8, "
                         f"got K={k}, N={n}")
    lead = a.shape[:-1]
    a2 = a.reshape(-1, k)
    m = a2.shape[0]
    pad = max(24, -(-m // 8) * 8) - m
    if pad:
        a2 = F.pad(a2, (0, 0, 0, pad))
    return torch._int_mm(a2, b)[:m].reshape(*lead, n)


class W8Linear(nn.Module):
    """Linear with int8 weight storage, the port of ``W8Dense``:
    ``y = (x @ vals) * scales + bias`` with ``vals`` (in, out) int8,
    ``scales`` (1, out) float32 and ``bias`` (out,) float32 in the JAX
    layout. As in JAX the product, the scales and the bias are all in the
    compute dtype (each rounded to it before the epilogue)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.register_buffer("vals", torch.zeros((in_features, out_features),
                                                 dtype=torch.int8))
        self.register_buffer("scales", torch.ones((1, out_features)))
        self.register_buffer("bias", torch.zeros(out_features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = x.to(dtype) @ self.vals.to(dtype)
        return y * self.scales[0].to(dtype) + self.bias.to(dtype)


class W8A8Linear(W8Linear):
    """int8 weights and dynamically int8-quantized activations, the port of
    ``W8A8Dense`` (same buffers as :class:`W8Linear`). Each token is scaled
    by 127 / max(max|x|, 1e-6) and rounded half to even; the int8 product
    accumulates in int32; both scales and the bias apply in float32, cast
    to the compute dtype at the end."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        amax = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
        xq = torch.round(xf * (127.0 / amax)).to(torch.int8)
        y = int8_matmul(xq, self.vals).float() * (amax * (1.0 / 127.0))
        return (y * self.scales[0] + self.bias).to(dtype)


def dense(cfg: Wav2Vec2Config, in_features: int, out_features: int
          ) -> nn.Module:
    """A transformer matmul of the type ``cfg`` selects, as the JAX layer's
    ``dense``: W8A8 when w8 and a8, W8 when w8, else a float Linear."""
    if cfg.w8 and cfg.a8:
        return W8A8Linear(in_features, out_features)
    if cfg.w8:
        return W8Linear(in_features, out_features)
    return nn.Linear(in_features, out_features)


# ------------------------------------------------------------------ helpers

def linear(x: torch.Tensor, lin: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """A Linear in the compute dtype (inputs, weight and bias cast to it);
    an int8 layer computes as its JAX counterpart does."""
    if isinstance(lin, W8Linear):
        return lin(x, dtype)
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype
               ) -> torch.Tensor:
    """LayerNorm computed in float32, returned in the compute dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(dtype)


def use_fast_gelu(cfg: Wav2Vec2Config, dtype: torch.dtype) -> bool:
    """Rational-erf GELU only for (b)f16, as the JAX package gates it."""
    return cfg.fast_gelu and dtype in _HALF


# ------------------------------------------------------------------ modules

class ConvFeatureExtractor(nn.Module):
    """fairseq ConvFeatureExtractionModel. Per layer ``i``:
    ``conv_layers.{i}.0`` is the conv; in layer_norm mode
    ``conv_layers.{i}.2.1`` is the per-frame LayerNorm; in group_norm mode
    ``conv_layers.0.2`` is the per-channel GroupNorm of layer 0 only."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        blocks, cin = [], 1
        for i, (dim, k, stride) in enumerate(cfg.conv_layers):
            conv = nn.Conv1d(cin, dim, k, stride=stride, bias=cfg.conv_bias)
            if cfg.extractor_mode == "layer_norm":
                norm = nn.Sequential(nn.Identity(), nn.LayerNorm(dim, eps=LN_EPS))
            elif i == 0:
                norm = nn.GroupNorm(dim, dim, eps=LN_EPS)
            else:
                norm = nn.Identity()
            blocks.append(nn.Sequential(conv, nn.Identity(), norm))
            cin = dim
        self.conv_layers = nn.ModuleList(blocks)

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        fast = use_fast_gelu(self.cfg, dt)
        x = wave[:, None, :].to(dt)                          # (B, 1, T)
        for block in self.conv_layers:
            conv, norm = block[0], block[2]
            bias = None if conv.bias is None else conv.bias.to(dt)
            x = F.conv1d(x, conv.weight.to(dt), bias, stride=conv.stride)
            if isinstance(norm, nn.GroupNorm):
                x = F.group_norm(x.float(), norm.num_groups, norm.weight,
                                 norm.bias, norm.eps).to(dt)
            elif isinstance(norm, nn.Sequential):
                x = layer_norm(x.transpose(1, 2), norm[1], dt).transpose(1, 2)
            x = fastgelu.gelu(x, fast=fast)
        return x.transpose(1, 2)                             # (B, frames, C)


class SelfAttention(nn.Module):
    def __init__(self, cfg: Wav2Vec2Config):
        super().__init__()
        d = cfg.encoder_embed_dim
        self.q_proj = dense(cfg, d, d)
        self.k_proj = dense(cfg, d, d)
        self.v_proj = dense(cfg, d, d)
        self.out_proj = dense(cfg, d, d)


class TransformerLayer(nn.Module):
    """Pre-LN fairseq TransformerSentenceEncoderLayer."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.encoder_embed_dim
        self.self_attn = SelfAttention(cfg)
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = dense(cfg, d, cfg.encoder_ffn_dim)
        self.fc2 = dense(cfg, cfg.encoder_ffn_dim, d)
        self.final_layer_norm = nn.LayerNorm(d, eps=LN_EPS)

    def attention(self, q, k, v, src: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        if self.training and cfg.attention_dropout > 0:
            # explicit probabilities: the dropout applies to them
            s = torch.einsum("bqhd,bkhd->bhqk", q * cfg.head_dim ** -0.5, k)
            probs = torch.softmax(s.float(), dim=-1).to(dt)
            probs = dropout.drop(probs, cfg.attention_dropout, src)
            return torch.einsum("bhqk,bkhd->bqhd", probs, v)
        if (cfg.fast_softmax and dt in _HALF
                and (not self.training or cfg.fast_softmax_train)):
            # bf16 softmax: max-subtract in bf16, exp in f32, normalise in bf16
            s = torch.einsum("bqhd,bkhd->bhqk", q * cfg.head_dim ** -0.5, k)
            e = torch.exp((s - s.amax(-1, keepdim=True)).float()).to(dt)
            probs = e / e.sum(-1, keepdim=True).to(dt)
            return torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return mha_small_t(q, k, v)

    def forward(self, x: torch.Tensor, seed: Optional[int] = None
                ) -> torch.Tensor:
        """In training, ``seed`` seeds the layer's dropout source (drawn
        from torch's global generator when ``None``)."""
        cfg, dt = self.cfg, self.dtype
        src = None
        if self.training:
            src = dropout.source(dropout.next_seed(None) if seed is None
                                 else seed)
        at = self.self_attn
        b, t, d = x.shape
        h = layer_norm(x, self.self_attn_layer_norm, dt)
        shape = (b, t, cfg.encoder_heads, cfg.head_dim)
        q = linear(h, at.q_proj, dt).view(shape)
        k = linear(h, at.k_proj, dt).view(shape)
        v = linear(h, at.v_proj, dt).view(shape)
        attn = self.attention(q, k, v, src).reshape(b, t, d)
        x = x + self._drop(linear(attn, at.out_proj, dt), cfg.dropout, src)
        h = layer_norm(x, self.final_layer_norm, dt)
        h = fastgelu.gelu(linear(h, self.fc1, dt), fast=use_fast_gelu(cfg, dt))
        h = self._drop(h, cfg.activation_dropout, src)
        return x + self._drop(linear(h, self.fc2, dt), cfg.dropout, src)

    def _drop(self, x, p, src):
        return dropout.drop(x, p, src) if self.training else x


class TransformerEncoder(nn.Module):
    """fairseq ``encoder``: ``pos_conv.0`` (grouped conv, weight norm folded
    into a plain weight), ``layers.{i}``, ``layer_norm``. With ``remat``
    each layer is recomputed in the backward pass of a train forward."""

    def __init__(self, cfg: Wav2Vec2Config, dtype: torch.dtype,
                 remat: bool = False):
        super().__init__()
        if remat and (cfg.remat_policy != "full" or cfg.remat_save_every > 1):
            if cfg.remat_policy not in ("full", "hidden", "dots"):
                raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                                 "(have: full, hidden, dots)")
            raise NotImplementedError(
                f"remat_policy {cfg.remat_policy!r} with remat_save_every "
                f"{cfg.remat_save_every} is not yet ported (ROADMAP Queue 1, "
                "item 7); use remat_policy 'full' and remat_save_every 0")
        self.cfg, self.dtype, self.remat = cfg, dtype, remat
        d = cfg.encoder_embed_dim
        self.pos_conv = nn.Sequential(nn.Conv1d(
            d, d, cfg.conv_pos, padding=cfg.conv_pos // 2,
            groups=cfg.conv_pos_groups))
        self.layers = nn.ModuleList(TransformerLayer(cfg, dtype)
                                    for _ in range(cfg.encoder_layers))
        self.layer_norm = nn.LayerNorm(d, eps=LN_EPS)

    def positional(self, x: torch.Tensor) -> torch.Tensor:
        dt, conv = self.dtype, self.pos_conv[0]
        xt, w, b = x.transpose(1, 2), conv.weight.to(dt), conv.bias.to(dt)
        if x.device.type == "cpu" and dt in _HALF:
            # PyTorch's oneDNN CPU kernel returns wrong values for a grouped
            # bf16 conv1d with an even kernel (seen in torch 2.13); the same
            # bf16 operands convolved in float32 give a bf16 conv's result
            xt, w, b = xt.float(), w.float(), b.float()
        pos = F.conv1d(xt, w, b, padding=conv.padding,
                       groups=conv.groups).to(dt)
        if self.cfg.conv_pos % 2 == 0:
            pos = pos[:, :, :-1]      # fairseq SamePad trims one step for even k
        return fastgelu.gelu(pos.transpose(1, 2),
                             fast=use_fast_gelu(self.cfg, dt))

    def forward(self, x: torch.Tensor, return_hiddens: bool = False,
                src: Optional[torch.Generator] = None):
        """(B, T, D) -> (B, T, D); with ``return_hiddens`` also the output
        of every layer stacked (L, B, T, D), taken before the final
        LayerNorm, as the JAX scan's ``y`` (recorded as the taps
        ``ssl_hidden:{i}`` too, outside the recomputed region). In training
        each layer's dropout seed is drawn from ``src`` here, outside the
        recomputed region."""
        x = x + self.positional(x)
        if not self.cfg.layer_norm_first:
            x = layer_norm(x, self.layer_norm, self.dtype)
        hiddens = []
        tapped = taps.active()
        for i, layer in enumerate(self.layers):
            if not self.training:
                x = layer(x)
            elif self.remat:
                x = checkpoint(layer, x, dropout.next_seed(src),
                               use_reentrant=False)
            else:
                x = layer(x, dropout.next_seed(src))
            if return_hiddens:
                hiddens.append(x)
            if tapped:
                taps.record(f"ssl_hidden:{i}", x)
        if self.cfg.layer_norm_first:
            x = layer_norm(x, self.layer_norm, self.dtype)
        if return_hiddens:
            return x, torch.stack(hiddens)
        return x


class Wav2Vec2Encoder(nn.Module):
    """Full XLSR front-end: wave (B, T) -> features (B, frames, D)."""

    def __init__(self, cfg: Wav2Vec2Config = Wav2Vec2Config(),
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        c = cfg.conv_layers[-1][0]
        self.feature_extractor = ConvFeatureExtractor(cfg, dtype)
        self.layer_norm = nn.LayerNorm(c, eps=LN_EPS)
        self.post_extract_proj = nn.Linear(c, cfg.encoder_embed_dim)
        self.encoder = TransformerEncoder(cfg, dtype, remat)

    def segmented_features(self, wave: torch.Tensor) -> torch.Tensor:
        """The conv front-end over ``cfg.conv_segments`` stride-aligned
        overlapping segments batched along B. Exact for the layer_norm
        extractor: frames are stride-aligned and normalised per frame."""
        cfg = self.cfg
        if cfg.extractor_mode != "layer_norm":
            raise ValueError("conv_segments requires the layer_norm extractor "
                             "(group_norm normalizes across the whole window)")
        b, t = wave.shape
        total, nseg = cfg.num_frames(t), cfg.conv_segments
        seg_frames = -(-total // nseg)
        seg_samples, seg_hop, pad_to = conv_segment_geometry(cfg, seg_frames,
                                                             nseg)
        wp = F.pad(wave, (0, max(0, pad_to - t)))
        segs = wp.unfold(1, seg_samples, seg_hop)[:, :nseg]  # (B, nseg, samples)
        f = self.feature_extractor(segs.reshape(b * nseg, seg_samples))
        return f.reshape(b, nseg * seg_frames, f.shape[-1])[:, :total]

    def forward(self, wave: Optional[torch.Tensor], *,
                return_hiddens: bool = False,
                conv_feats: Optional[torch.Tensor] = None,
                src: Optional[torch.Generator] = None):
        """``conv_feats`` (B, frames, C) bypasses the conv front-end (and
        ``conv_segments``), so ``wave`` may be ``None``: the incremental
        streaming scorer (engine/streaming.py) computes conv features once
        over long audio and re-enters here per window. ``return_hiddens``
        returns ``(x, hiddens)``, hiddens (L, B, T, D) as
        :meth:`TransformerEncoder.forward` gives them. ``src`` is the
        dropout seed source of a train forward."""
        if conv_feats is not None:
            feats = conv_feats
        elif self.cfg.conv_segments > 1:
            feats = self.segmented_features(wave)
        else:
            feats = self.feature_extractor(wave)
        x = layer_norm(feats, self.layer_norm, self.dtype)
        x = linear(x, self.post_extract_proj, self.dtype)
        if self.training:
            x = dropout.drop(x, self.cfg.dropout, src)
        return self.encoder(x, return_hiddens=return_hiddens, src=src)

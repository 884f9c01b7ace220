"""Plain PyTorch reference of XLSR-Conformer at any depth.

The wav2vec2 XLS-R front-end and encoder are ``xlsr_aasist.py``'s
(``conv_features`` and ``encoder``, imported). The classifier head is the
reference repo's Conformer ``Model``, written from its description:

    encoder output (B, T, D) -> LL -> BatchNorm2d(1) over (B, 1, T, E)
    -> SELU -> class token prepended -> ``n_encoders`` blocks -> fc5 of
    the class token's row -> logits (B, 2)

A block is x + 0.5 FF(LN x), x + MHA(LN x), x + conv(x), x + 0.5 FF(LN x),
then a LayerNorm (post-norm). FF is Linear (E -> ff_mult E), SiLU, Linear
back. MHA has no bias on q, k or v and Shaw relative positions: query i's
score on key j gains q_i . emb[clip(i - j, -m, m) + m] (m = max_pos_emb),
both terms scaled by 1/sqrt(head dim). The conv module is LayerNorm,
pointwise conv to 2 x inner channels, GLU, a depthwise conv of
``kernel_size`` with lucidrains' same padding (k // 2, k // 2 - (k + 1) %
2), BatchNorm, SiLU and a pointwise conv back to E. Every operation is a
plain ``torch`` call in float32 under the state-dict names of the
reference repo (lucidrains' module names). It imports nothing of the
program under test.

Departures from the published description, each also the program's:
BatchNorm uses its running statistics (an evaluation forward), and
dropout, whose rate the shipped configuration leaves at 0, is left out.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import xlsr_aasist as xa
from benchmark.reference.xlsr_aasist import Params

HEAD = "conformer."


class ModelShape(xa.EncoderShape):
    """The encoder's sizes and the Conformer head's, from the file's
    ``backend``."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        be = cfg["backend"]
        self.emb = int(be["emb_size"])
        self.head_count = int(be["heads"])
        self.kernel = int(be["kernel_size"])
        self.blocks = int(be["n_encoders"])
        self.ff_mult = int(be["ff_mult"])
        self.inner = self.emb * int(be["conv_expansion_factor"])
        self.max_pos = int(be["max_pos_emb"])


def param_shapes(shape: ModelShape) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of the model, name -> shape, in the
    reference repo's names."""
    out = xa.encoder_shapes(shape)
    e, inner = shape.emb, shape.inner
    xa._lin(out, "LL", shape.dim, e)
    xa._bn(out, "first_bn", 1)
    for i in range(shape.blocks):
        b = f"{HEAD}encoder_blocks.{i}."
        for ff in ("ff1", "ff2"):
            _norm(out, f"{b}{ff}.fn.norm", e)
            xa._lin(out, f"{b}{ff}.fn.fn.net.0", e, shape.ff_mult * e)
            xa._lin(out, f"{b}{ff}.fn.fn.net.3", shape.ff_mult * e, e)
        _norm(out, b + "attn.norm", e)
        a = b + "attn.fn."
        out[a + "to_q.weight"] = (e, e)
        out[a + "to_kv.weight"] = (2 * e, e)
        xa._lin(out, a + "to_out", e, e)
        out[a + "rel_pos_emb.weight"] = (2 * shape.max_pos + 1,
                                         e // shape.head_count)
        c = b + "conv.net."
        _norm(out, c + "0", e)
        out[c + "2.weight"] = (2 * inner, e, 1)
        out[c + "2.bias"] = (2 * inner,)
        out[c + "4.conv.weight"] = (inner, 1, shape.kernel)
        out[c + "4.conv.bias"] = (inner,)
        xa._bn(out, c + "5", inner)
        out[c + "7.weight"] = (e, inner, 1)
        out[c + "7.bias"] = (e,)
        _norm(out, b + "post_norm", e)
    out[HEAD + "class_token"] = (1, e)
    xa._lin(out, HEAD + "fc5", e, 2)
    return out


def _norm(out, name: str, c: int) -> None:
    out[name + ".weight"] = (c,)
    out[name + ".bias"] = (c,)


# ------------------------------------------------------------ head

def _feed_forward(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return xa._linear(F.silu(xa._linear(x, p, name + ".net.0")), p,
                      name + ".net.3")


def _rel_attention(x: torch.Tensor, p: Params, name: str,
                   shape: ModelShape) -> torch.Tensor:
    b, n, e = x.shape
    h = shape.head_count
    dh = e // h
    r = p.round
    q = r(x) @ r(p[name + ".to_q.weight"]).t()
    k, v = (r(x) @ r(p[name + ".to_kv.weight"]).t()).chunk(2, dim=-1)
    q, k, v = (t.reshape(b, n, h, dh).transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(n, device=x.device)
    dist = (pos[:, None] - pos[None, :]).clamp(-shape.max_pos,
                                               shape.max_pos) + shape.max_pos
    rel = p[name + ".rel_pos_emb.weight"][dist]            # (n, n, dh)
    s = (r(q) @ r(k).transpose(-1, -2)
         + torch.einsum("bhid,ijd->bhij", r(q), r(rel))) * dh ** -0.5
    o = r(torch.softmax(s, dim=-1)) @ r(v)                 # (B, H, n, dh)
    return xa._linear(o.transpose(1, 2).reshape(b, n, e), p, name + ".to_out")


def _pointwise(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """A 1x1 conv (out, in, 1) over (B, T, in)."""
    return (p.round(x) @ p.round(p[name + ".weight"][..., 0]).t()
            + p[name + ".bias"])


def _conv_module(x: torch.Tensor, p: Params, name: str, shape: ModelShape
                 ) -> torch.Tensor:
    k = shape.kernel
    x = _pointwise(xa._ln(x, p, name + ".0"), p, name + ".2")
    a, g = x.chunk(2, dim=-1)
    x = F.pad((a * torch.sigmoid(g)).transpose(1, 2),
              (k // 2, k // 2 - (k + 1) % 2))
    x = F.conv1d(p.round(x), p.round(p[name + ".4.conv.weight"]),
                 p[name + ".4.conv.bias"], groups=shape.inner)
    x = F.silu(xa._bnorm(x, p, name + ".5")).transpose(1, 2)
    return _pointwise(x, p, name + ".7")


def _block(x: torch.Tensor, p: Params, b: str, shape: ModelShape
           ) -> torch.Tensor:
    x = x + 0.5 * _feed_forward(xa._ln(x, p, b + "ff1.fn.norm"), p,
                                b + "ff1.fn.fn")
    x = x + _rel_attention(xa._ln(x, p, b + "attn.norm"), p, b + "attn.fn",
                           shape)
    x = x + _conv_module(x, p, b + "conv.net", shape)
    x = x + 0.5 * _feed_forward(xa._ln(x, p, b + "ff2.fn.norm"), p,
                                b + "ff2.fn.fn")
    return xa._ln(x, p, b + "post_norm")


def head(p: Params, shape: ModelShape, feats: torch.Tensor) -> torch.Tensor:
    """Encoder output (B, frames, D) -> logits (B, 2)."""
    x = xa._linear(feats, p, "LL")[:, None]               # (B, 1, T, E)
    x = F.selu(xa._bnorm(x, p, "first_bn"))[:, 0]
    token = p[HEAD + "class_token"][None].expand(x.shape[0], -1, -1)
    x = torch.cat([token, x], dim=1)
    for i in range(shape.blocks):
        x = _block(x, p, f"{HEAD}encoder_blocks.{i}.", shape)
    return xa._linear(x[:, 0], p, HEAD + "fc5")


# ------------------------------------------------------------ entry points

def logits(p: Params, shape: ModelShape, wave: torch.Tensor) -> torch.Tensor:
    """(B, samples) float32 waves -> (B, 2) logits."""
    if not isinstance(p, Params):
        p = Params(p)
    feats = xa.encoder(p, shape, xa.conv_features(p, shape, wave))
    return head(p, shape, feats)


def bonafide_scores(p: Dict[str, torch.Tensor], shape: ModelShape,
                    waves: torch.Tensor, block: int = 40,
                    precision: str = "float32") -> torch.Tensor:
    """The bonafide logit of each row of ``waves``: ``xlsr_aasist``'s
    ``bonafide_scores`` of this model."""
    return xa.bonafide_of(logits, p, shape, waves, block, precision)

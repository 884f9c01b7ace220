"""Plain PyTorch reference of XLSR-AASIST at any depth.

The wav2vec2 XLS-R front-end (a 7-layer strided conv stack with per-frame
LayerNorm, a projection, a grouped positional conv, pre-LN transformer
layers and a final LayerNorm) followed by the AASIST spectro-temporal graph
back-end, computed from a dict of parameters under the reference repo's
state-dict names. Every operation is a plain ``torch`` call in float32:
no kernel, no cache, no batching trick. It imports nothing of the program
under test and is held to it on the CPU by the benchmark's tests.

Departures from the published description, each also the program's:
the AASIST ``out_S1 + 1`` quirk of the reference repo (its
``fix_out_s1_bug`` off), and ``Residual_block``'s conv1 reading the raw
input (the reference's ``bn1`` output is dead).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F


class Params(dict):
    """Parameters by name, and ``round``, applied to both operands of every
    matmul and convolution: the identity (float32), or a lower precision
    for the control."""

    def __init__(self, tensors: Dict[str, torch.Tensor], rounding=None):
        super().__init__(tensors)
        self.round = rounding or (lambda x: x)


def fp8_rounding(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude to 448, e4m3's largest finite value), in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDINGS = {"float32": None, "fp8": fp8_rounding}

LN_EPS = 1e-5
BN_EPS = 1e-5
SSL = "ssl_model.model."


# ------------------------------------------------------------ configuration

class EncoderShape:
    """Sizes of the front-end and the encoder, read from a configuration
    file's HF config names; ``conv`` is the conv stack's (channels,
    kernel, stride) a layer."""

    def __init__(self, cfg: dict):
        self.layers = int(cfg["num_hidden_layers"])
        self.dim = int(cfg["hidden_size"])
        self.heads = int(cfg["num_attention_heads"])
        self.ffn = int(cfg["intermediate_size"])
        self.conv = [(int(c), int(k), int(s)) for c, k, s in zip(
            cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"])]
        self.pos_k = int(cfg["num_conv_pos_embeddings"])
        self.pos_groups = int(cfg["num_conv_pos_embedding_groups"])

    def num_frames(self, samples: int) -> int:
        t = samples
        for _, k, s in self.conv:
            t = (t - k) // s + 1
        return t


class ModelShape(EncoderShape):
    """The encoder's sizes and AASIST's, from the file's ``backend``."""

    def __init__(self, cfg: dict):
        super().__init__(cfg)
        be = cfg["backend"]
        self.filts = [int(be["filts"][0])] + [tuple(int(x) for x in f)
                                              for f in be["filts"][1:]]
        self.gat_dims = tuple(int(x) for x in be["gat_dims"])
        self.pool_ratios = tuple(float(x) for x in be["pool_ratios"])
        self.temperatures = tuple(float(x) for x in be["temperatures"])


def param_shapes(shape: ModelShape) -> Dict[str, Tuple[int, ...]]:
    """Every parameter and buffer of the model, name -> shape, in the
    reference repo's names."""
    out = encoder_shapes(shape)
    out.update(_backend_shapes(shape))
    return out


def encoder_shapes(shape: EncoderShape) -> Dict[str, Tuple[int, ...]]:
    """The front-end's and the encoder's parameters, name -> shape."""
    out: Dict[str, Tuple[int, ...]] = {}
    fe = SSL + "feature_extractor.conv_layers."
    cin = 1
    for i, (c, k, _s) in enumerate(shape.conv):
        out[f"{fe}{i}.0.weight"] = (c, cin, k)
        out[f"{fe}{i}.0.bias"] = (c,)
        out[f"{fe}{i}.2.1.weight"] = (c,)
        out[f"{fe}{i}.2.1.bias"] = (c,)
        cin = c
    d = shape.dim
    out[SSL + "layer_norm.weight"] = (cin,)
    out[SSL + "layer_norm.bias"] = (cin,)
    out[SSL + "post_extract_proj.weight"] = (d, cin)
    out[SSL + "post_extract_proj.bias"] = (d,)
    enc = SSL + "encoder."
    out[enc + "pos_conv.0.weight"] = (d, d // shape.pos_groups, shape.pos_k)
    out[enc + "pos_conv.0.bias"] = (d,)
    for i in range(shape.layers):
        lp = f"{enc}layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out[f"{lp}self_attn.{proj}.weight"] = (d, d)
            out[f"{lp}self_attn.{proj}.bias"] = (d,)
        out[lp + "self_attn_layer_norm.weight"] = (d,)
        out[lp + "self_attn_layer_norm.bias"] = (d,)
        out[lp + "fc1.weight"] = (shape.ffn, d)
        out[lp + "fc1.bias"] = (shape.ffn,)
        out[lp + "fc2.weight"] = (d, shape.ffn)
        out[lp + "fc2.bias"] = (d,)
        out[lp + "final_layer_norm.weight"] = (d,)
        out[lp + "final_layer_norm.bias"] = (d,)
    out[enc + "layer_norm.weight"] = (d,)
    out[enc + "layer_norm.bias"] = (d,)
    return out


def _bn(out, name: str, c: int) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{name}.{leaf}"] = (c,)
    out[f"{name}.num_batches_tracked"] = ()


def _lin(out, name: str, cin: int, cout: int) -> None:
    out[f"{name}.weight"] = (cout, cin)
    out[f"{name}.bias"] = (cout,)


def _backend_shapes(shape: ModelShape) -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    f0 = shape.filts[0]
    g0, g1 = shape.gat_dims
    blocks = list(shape.filts[1:])
    blocks += [blocks[-1]] * (6 - len(blocks))
    ch = blocks[-1][-1]
    out["pos_S"] = (1, f0 // 3, ch)
    out["master1"] = (1, 1, g0)
    out["master2"] = (1, 1, g0)
    _lin(out, "LL", shape.dim, f0)
    _bn(out, "first_bn", 1)
    for i, (cin, cout) in enumerate(blocks):
        b = f"encoder.{i}.0."
        out[b + "conv1.weight"] = (cout, cin, 2, 3)
        out[b + "conv1.bias"] = (cout,)
        _bn(out, b + "bn2", cout)
        out[b + "conv2.weight"] = (cout, cout, 2, 3)
        out[b + "conv2.bias"] = (cout,)
        if cin != cout:
            out[b + "conv_downsample.weight"] = (cout, cin, 1, 3)
            out[b + "conv_downsample.bias"] = (cout,)
    _bn(out, "first_bn1", ch)
    out["attention.0.weight"] = (128, ch, 1, 1)
    out["attention.0.bias"] = (128,)
    _bn(out, "attention.2", 128)
    out["attention.3.weight"] = (ch, 128, 1, 1)
    out["attention.3.bias"] = (ch,)
    for name in ("GAT_layer_S", "GAT_layer_T"):
        out[f"{name}.att_weight"] = (g0, 1)
        for lin in ("att_proj", "proj_with_att", "proj_without_att"):
            _lin(out, f"{name}.{lin}", ch, g0)
        _bn(out, f"{name}.bn", g0)
    for name, cin in (("HtrgGAT_layer_ST11", g0), ("HtrgGAT_layer_ST12", g1),
                      ("HtrgGAT_layer_ST21", g0), ("HtrgGAT_layer_ST22", g1)):
        for w in ("att_weight11", "att_weight22", "att_weight12",
                  "att_weightM"):
            out[f"{name}.{w}"] = (g1, 1)
        _lin(out, f"{name}.proj_type1", cin, cin)
        _lin(out, f"{name}.proj_type2", cin, cin)
        for lin in ("att_proj", "att_projM", "proj_with_att",
                    "proj_without_att", "proj_with_attM",
                    "proj_without_attM"):
            _lin(out, f"{name}.{lin}", cin, g1)
        _bn(out, f"{name}.bn", g1)
    for name, dim in (("pool_S", g0), ("pool_T", g0), ("pool_hS1", g1),
                      ("pool_hT1", g1), ("pool_hS2", g1), ("pool_hT2", g1)):
        _lin(out, f"{name}.proj", dim, 1)
    _lin(out, "out_layer", 5 * g1, 2)
    return out


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


# ------------------------------------------------------------ front-end

def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))


def _ln(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return ((x - mean) / torch.sqrt(var + LN_EPS) * p[name + ".weight"]
            + p[name + ".bias"])


def _linear(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return p.round(x) @ p.round(p[name + ".weight"]).t() + p[name + ".bias"]


def conv_features(p: Params, shape: ModelShape, wave: torch.Tensor
                  ) -> torch.Tensor:
    """(B, samples) -> (B, frames, C): conv, LayerNorm over channels, GELU
    per layer."""
    x = wave[:, None, :]
    fe = SSL + "feature_extractor.conv_layers."
    for i, (_c, _k, s) in enumerate(shape.conv):
        x = F.conv1d(p.round(x), p.round(p[f"{fe}{i}.0.weight"]),
                     p[f"{fe}{i}.0.bias"], stride=s)
        x = _gelu(_ln(x.transpose(1, 2), p, f"{fe}{i}.2.1").transpose(1, 2))
    return x.transpose(1, 2)


def _attention(x: torch.Tensor, p: Params, lp: str, heads: int
               ) -> torch.Tensor:
    b, t, d = x.shape
    hd = d // heads
    q, k, v = (_linear(x, p, f"{lp}self_attn.{n}").view(b, t, heads, hd)
               .transpose(1, 2) for n in ("q_proj", "k_proj", "v_proj"))
    r = p.round
    s = (r(q) @ r(k).transpose(-1, -2)) * hd ** -0.5
    o = r(torch.softmax(s, dim=-1)) @ r(v)                 # (B, H, T, hd)
    return _linear(o.transpose(1, 2).reshape(b, t, d), p,
                   f"{lp}self_attn.out_proj")


def encoder(p: Params, shape: ModelShape, feats: torch.Tensor
            ) -> torch.Tensor:
    """Conv features (B, frames, C) -> encoder output (B, frames, D)."""
    x = _linear(_ln(feats, p, SSL + "layer_norm"), p,
                SSL + "post_extract_proj")
    enc = SSL + "encoder."
    pos = F.conv1d(p.round(x.transpose(1, 2)),
                   p.round(p[enc + "pos_conv.0.weight"]),
                   p[enc + "pos_conv.0.bias"], padding=shape.pos_k // 2,
                   groups=shape.pos_groups)
    if shape.pos_k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + _gelu(pos.transpose(1, 2))
    for i in range(shape.layers):
        lp = f"{enc}layers.{i}."
        x = x + _attention(_ln(x, p, lp + "self_attn_layer_norm"), p, lp,
                           shape.heads)
        h = _gelu(_linear(_ln(x, p, lp + "final_layer_norm"), p,
                          lp + "fc1"))
        x = x + _linear(h, p, lp + "fc2")
    return _ln(x, p, enc + "layer_norm")


# ------------------------------------------------------------ back-end

def _bnorm(x: torch.Tensor, p: Params, name: str, dim: int = 1
           ) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[dim] = -1
    mean = p[name + ".running_mean"].view(shape)
    var = p[name + ".running_var"].view(shape)
    return ((x - mean) / torch.sqrt(var + BN_EPS)
            * p[name + ".weight"].view(shape) + p[name + ".bias"].view(shape))


def _conv2d(x: torch.Tensor, p: Params, name: str, padding) -> torch.Tensor:
    return F.conv2d(p.round(x), p.round(p[name + ".weight"]),
                    p[name + ".bias"], padding=padding)


def _residual(x: torch.Tensor, p: Params, b: str) -> torch.Tensor:
    out = F.selu(_bnorm(_conv2d(x, p, b + "conv1", (1, 1)), p, b + "bn2"))
    out = _conv2d(out, p, b + "conv2", (0, 1))
    if b + "conv_downsample.weight" in p:
        x = _conv2d(x, p, b + "conv_downsample", (0, 1))
    return out + x


def _pair_scores(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    """tanh((x_i * x_j) W + b): (B, N, N, Do)."""
    return torch.tanh(_linear(x[:, :, None, :] * x[:, None, :, :], p,
                              name + ".att_proj"))


def _gat(x: torch.Tensor, p: Params, name: str, temp: float) -> torch.Tensor:
    att = (_pair_scores(x, p, name) @ p[name + ".att_weight"])[..., 0] / temp
    att = torch.softmax(att, dim=2)                        # over j
    agg = att @ x
    y = _linear(agg, p, name + ".proj_with_att") + _linear(
        x, p, name + ".proj_without_att")
    return F.selu(_bnorm(y, p, name + ".bn", dim=2))


def _htrg(x1: torch.Tensor, x2: torch.Tensor, master: torch.Tensor,
          p: Params, name: str, temp: float):
    n1 = x1.shape[1]
    x = torch.cat([_linear(x1, p, name + ".proj_type1"),
                   _linear(x2, p, name + ".proj_type2")], dim=1)
    pair = _pair_scores(x, p, name)                        # (B, N, N, Do)
    w = {k: p[f"{name}.att_weight{k}"][:, 0] for k in ("11", "22", "12")}
    att = torch.empty(pair.shape[:3], dtype=x.dtype, device=x.device)
    att[:, :n1, :n1] = pair[:, :n1, :n1] @ w["11"]
    att[:, :n1, n1:] = pair[:, :n1, n1:] @ w["12"]
    att[:, n1:, :n1] = pair[:, n1:, :n1] @ w["12"]
    att[:, n1:, n1:] = pair[:, n1:, n1:] @ w["22"]
    att = torch.softmax(att / temp, dim=2)
    agg = att @ x
    am = torch.tanh(_linear(x * master, p, name + ".att_projM"))
    am = torch.softmax((am @ p[name + ".att_weightM"])[..., 0] / temp, dim=1)
    pooled = (am[:, :, None] * x).sum(1, keepdim=True)
    master = _linear(pooled, p, name + ".proj_with_attM") + _linear(
        master, p, name + ".proj_without_attM")
    y = _linear(agg, p, name + ".proj_with_att") + _linear(
        x, p, name + ".proj_without_att")
    y = F.selu(_bnorm(y, p, name + ".bn", dim=2))
    return y[:, :n1], y[:, n1:], master


def _pool(h: torch.Tensor, p: Params, name: str, ratio: float
          ) -> torch.Tensor:
    """Keep the top ``ratio`` of nodes by sigmoid score, in descending
    score order (ties to the lower index), scaled by their scores."""
    scores = torch.sigmoid(_linear(h, p, name + ".proj"))  # (B, N, 1)
    keep = max(int(h.shape[1] * ratio), 1)
    idx = torch.sort(scores[..., 0], dim=1, descending=True,
                     stable=True).indices[:, :keep]
    h = h * scores
    return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))


def backend(p: Params, shape: ModelShape, feats: torch.Tensor
            ) -> torch.Tensor:
    """Encoder output (B, frames, D) -> logits (B, 2)."""
    t_s, t_t, t_h, _ = shape.temperatures
    r_s, r_t, r_h, _ = shape.pool_ratios
    x = _linear(feats, p, "LL").transpose(1, 2)[:, None]   # (B, 1, F0, T)
    x = F.selu(_bnorm(F.max_pool2d(x, (3, 3)), p, "first_bn"))
    i = 0
    while f"encoder.{i}.0.conv1.weight" in p:
        x = _residual(x, p, f"encoder.{i}.0.")
        i += 1
    x = F.selu(_bnorm(x, p, "first_bn1"))
    w = F.selu(_conv2d(x, p, "attention.0", 0))
    w = _conv2d(_bnorm(w, p, "attention.2"), p, "attention.3", 0)
    e_s = (x * torch.softmax(w, dim=3)).sum(3).transpose(1, 2) + p["pos_S"]
    out_s = _pool(_gat(e_s, p, "GAT_layer_S", t_s), p, "pool_S", r_s)
    e_t = (x * torch.softmax(w, dim=2)).sum(2).transpose(1, 2)
    out_t = _pool(_gat(e_t, p, "GAT_layer_T", t_t), p, "pool_T", r_t)

    def branch(first: str, second: str, ps: str, pt: str, master, fix):
        t1, s1, m1 = _htrg(out_t, out_s, master, p, first, t_h)
        s1 = _pool(s1, p, ps, r_h)
        t1 = _pool(t1, p, pt, r_h)
        t_aug, s_aug, m_aug = _htrg(t1, s1, m1, p, second, t_h)
        return t1 + t_aug, (s1 + s_aug if fix else s1 + 1), m1 + m_aug

    t1, s1, m1 = branch("HtrgGAT_layer_ST11", "HtrgGAT_layer_ST12",
                        "pool_hS1", "pool_hT1", p["master1"], False)
    t2, s2, m2 = branch("HtrgGAT_layer_ST21", "HtrgGAT_layer_ST22",
                        "pool_hS2", "pool_hT2", p["master2"], True)
    out_t, out_s = torch.maximum(t1, t2), torch.maximum(s1, s2)
    master = torch.maximum(m1, m2)
    hidden = torch.cat([out_t.abs().amax(1), out_t.mean(1),
                        out_s.abs().amax(1), out_s.mean(1), master[:, 0]],
                       dim=1)
    return _linear(hidden, p, "out_layer")


# ------------------------------------------------------------ entry points

def logits(p: Params, shape: ModelShape, wave: torch.Tensor) -> torch.Tensor:
    """(B, samples) float32 waves -> (B, 2) logits."""
    if not isinstance(p, Params):
        p = Params(p)
    return backend(p, shape, encoder(p, shape, conv_features(p, shape, wave)))


def bonafide_scores(p: Dict[str, torch.Tensor], shape: ModelShape,
                    waves: torch.Tensor, block: int = 40,
                    precision: str = "float32") -> torch.Tensor:
    """The bonafide logit of each row of ``waves``, in float32 with TF32
    off (``precision="fp8"``: every matmul and convolution operand rounded
    to float8 e4m3 first), ``block`` rows at a time, on the parameters'
    device."""
    return bonafide_of(logits, p, shape, waves, block, precision)


@torch.no_grad()
def bonafide_of(forward: Callable, p: Dict[str, torch.Tensor], shape,
                waves: torch.Tensor, block: int, precision: str
                ) -> torch.Tensor:
    """``bonafide_scores`` of a model whose ``forward(p, shape, waves)``
    gives (B, 2) logits."""
    dev = next(iter(p.values())).device
    p = Params(p, ROUNDINGS[precision])
    out: List[torch.Tensor] = []
    with exact_float32():
        for i in range(0, waves.shape[0], block):
            w = waves[i:i + block].to(dev, torch.float32)
            out.append(forward(p, shape, w)[:, 1].cpu())
    return torch.cat(out) if out else torch.zeros(0)

"""Fused conv + LayerNorm + GELU front-end layers: the port of
``rtdsd_tpu/ops/pallas/convstack.py``.

- :func:`ln_gelu`: per-row LayerNorm (eps 1e-5, two-pass variance) and
  rational-erf GELU, in float32, over (B, F, C); returns x's dtype.
- :func:`conv_ln_gelu_grouped`: one front-end layer, conv1d(k, stride s) +
  bias, then the same LayerNorm and GELU; x (B, T, Cin), w (k, Cin, Cout)
  in the JAX package's layout.
- :func:`fused_conv_frontend`: the whole feature extractor on these two,
  gated by :func:`supports_fused` with the JAX package's answers.

On CUDA tensors both kernel functions launch ``csrc/convstack.cu`` (design
note at its top); on CPU tensors they run the plain PyTorch versions beside
them. :func:`conv_body` is the rule that picks the conv layer's body: the
bf16 tensor-core body where it applies, the CUDA-core FFMA body elsewhere.
Unlike the JAX kernels, which emit frame counts rounded up to their block
with garbage tails, these return exactly the valid frames.

As in the JAX package this is an op, not wired into the encoder:
``models/wav2vec2.py::ConvFeatureExtractor`` stays the scoring path.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Sequence

import torch
import torch.nn.functional as F

from rtdsd_tpu_torch.ops import build
from rtdsd_tpu_torch.ops.fastgelu import erf_rational, _INV_SQRT2

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "ln_gelu": [_P, _P, _P, _P, _L, _I, _F, _I, _P],
    "conv_ln_gelu": [_P] * 6 + [_I] * 7 + [_F, _I, _I, _P],
}
LN_GELU_WIDTHS = (128, 256, 384, 512, 768, 1024)
CONV_COUT = (128, 256, 512, 1024)
CONV_BODIES = ("ffma", "mma")
MMA_COUT = (128, 256, 512)
SMEM_LIMIT = 232448
_THREADS = 256


def _ln_gelu_f32(acc: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float) -> torch.Tensor:
    mean = acc.mean(dim=-1, keepdim=True)
    var = (acc - mean).square().mean(dim=-1, keepdim=True)
    h = (acc - mean) * torch.rsqrt(var + eps)
    h = h * gamma.float() + beta.float()
    return 0.5 * h * (1.0 + erf_rational(h * _INV_SQRT2))


def ln_gelu_reference(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _ln_gelu_f32(x.float(), gamma, beta, eps).to(x.dtype)


def conv_ln_gelu_grouped_reference(x: torch.Tensor, w: torch.Tensor,
                                   b: torch.Tensor, gamma: torch.Tensor,
                                   beta: torch.Tensor, *, k: int, s: int,
                                   t_valid: Optional[int] = None,
                                   eps: float = 1e-5) -> torch.Tensor:
    """Plain version: the weight rounded to x's dtype, products and sums in
    float32 (a float32 conv of the rounded operands), then LN + GELU."""
    t_valid = x.shape[1] if t_valid is None else t_valid
    xf = x[:, :t_valid].float().transpose(1, 2)               # (B, Cin, T)
    wf = w.to(x.dtype).float().permute(2, 1, 0)               # (Cout, Cin, k)
    y = F.conv1d(xf, wf, stride=s).transpose(1, 2) + b.float()
    return _ln_gelu_f32(y, gamma, beta, eps).to(x.dtype)


def _kernel_dtype(x: torch.Tensor) -> int:
    if not x.is_cuda:
        raise ValueError(f"expected a CUDA tensor, got one on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the convstack kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    return int(x.dtype == torch.bfloat16)


def _dense(t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """Contiguous, of ``dtype`` on ``device``, 16-byte aligned for the
    kernel's vector loads."""
    t = t.detach().to(device=device, dtype=dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ln_gelu(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """Fused per-row LayerNorm + GELU: x (B, F, C) -> same shape and dtype."""
    if x.device.type == "cpu":
        return ln_gelu_reference(x, gamma, beta, eps)
    bf16 = _kernel_dtype(x)
    c = x.shape[-1]
    if c not in LN_GELU_WIDTHS or gamma.numel() != c or beta.numel() != c:
        raise ValueError(f"ln_gelu takes C in {LN_GELU_WIDTHS} with (C,) "
                         f"gamma and beta; got x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    xc = _dense(x, x.dtype, x.device)
    g, bt = (_dense(t, torch.float32, x.device) for t in (gamma, beta))
    out = torch.empty_like(xc)
    lib = build.library("convstack", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ln_gelu(xc.data_ptr(), g.data_ptr(), bt.data_ptr(),
                         out.data_ptr(), xc.numel() // c, c, float(eps), bf16,
                         stream)
    build.check(rc, "ln_gelu")
    ln_gelu.launches += 1
    return out


def _conv_smem_bytes(cin: int, cout: int) -> int:
    """Dynamic shared memory of one conv block: its frame tile (16 frames
    per thread row) by max(Cin, Cout) floats."""
    frames = 16 * (_THREADS // (cout // 4))
    return 4 * frames * max(cin, cout)


def conv_supported(cin: int, cout: int) -> bool:
    """Whether the wrapper takes a layer of this Cin and Cout on a CUDA
    tensor (the FFMA body takes every such shape, in both dtypes)."""
    return (cout in CONV_COUT and cin % 4 == 0
            and _conv_smem_bytes(cin, cout) <= SMEM_LIMIT)


def conv_body(dtype: torch.dtype, cin: int, cout: int) -> str:
    """The body of ``csrc/convstack.cu`` that a layer with this dtype, Cin
    and Cout takes: bf16 with Cin a multiple of 64 and Cout in
    ``MMA_COUT`` runs on the tensor cores ("mma"; at Cout 512 as a cluster
    of two blocks that split Cout); float32 and every other shape the
    wrapper takes run on the FFMA body ("ffma")."""
    if dtype == torch.bfloat16 and cin % 64 == 0 and cout in MMA_COUT:
        return "mma"
    return "ffma"


def conv_ln_gelu_grouped(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor, *, k: int,
                         s: int, t_valid: Optional[int] = None,
                         eps: float = 1e-5,
                         body: Optional[str] = None) -> torch.Tensor:
    """One fused layer y = GELU(LN(conv1d(x, w, b))), stride ``s``.

    x: (B, T, Cin); w: (k, Cin, Cout); ``t_valid`` (<= T) is the valid
    prefix of x. Returns (B, (t_valid - k) // s + 1, Cout) in x's dtype:
    the valid frames only. ``body`` (None: :func:`conv_body`'s choice)
    names the kernel body on a CUDA tensor, to compare bodies: "ffma",
    or "mma" for a shape the rule sends to the tensor cores."""
    if x.device.type == "cpu":
        return conv_ln_gelu_grouped_reference(x, w, b, gamma, beta, k=k, s=s,
                                              t_valid=t_valid, eps=eps)
    bf16 = _kernel_dtype(x)
    bsz, t, cin = x.shape
    t_valid = t if t_valid is None else t_valid
    cout = w.shape[-1]
    if w.shape != (k, cin, cout) or any(v.numel() != cout
                                        for v in (b, gamma, beta)):
        raise ValueError(f"conv weights do not fit x {tuple(x.shape)}: w "
                         f"{tuple(w.shape)}, k={k}, bias/gamma/beta "
                         f"{[tuple(v.shape) for v in (b, gamma, beta)]}")
    if not (1 <= s and k <= t_valid <= t):
        raise ValueError(f"need s >= 1 and k <= t_valid <= T; got s={s}, "
                         f"k={k}, t_valid={t_valid}, T={t}")
    if not conv_supported(cin, cout):
        raise ValueError(f"conv_ln_gelu_grouped takes Cout in {CONV_COUT} "
                         f"and Cin a multiple of 4 whose frame tile fits "
                         f"in shared memory; got Cin={cin}, Cout={cout}")
    rule = conv_body(x.dtype, cin, cout)
    body = rule if body is None else body
    if body not in CONV_BODIES or (body == "mma" and rule == "ffma"):
        raise ValueError(f"conv body {body!r} does not take {x.dtype}, "
                         f"Cin={cin}, Cout={cout} (the rule gives {rule!r})")
    f_out = (t_valid - k) // s + 1
    xc = _dense(x, x.dtype, x.device)
    wc = _dense(w, x.dtype, x.device)
    bias, g, bt = (_dense(v, torch.float32, x.device) for v in (b, gamma, beta))
    out = torch.empty((bsz, f_out, cout), dtype=x.dtype, device=x.device)
    lib = build.library("convstack", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv_ln_gelu(xc.data_ptr(), wc.data_ptr(), bias.data_ptr(),
                              g.data_ptr(), bt.data_ptr(), out.data_ptr(),
                              bsz, t, cin, cout, f_out, k, s, float(eps),
                              bf16, int(body == "mma"), stream)
    build.check(rc, "conv_ln_gelu_grouped")
    conv_ln_gelu_grouped.launches += 1
    return out


ln_gelu.launches = 0
conv_ln_gelu_grouped.launches = 0


def supports_fused(conv_layers: Sequence[Sequence[int]],
                   extractor_mode: str) -> bool:
    """The JAX package's gate, with its answers: layer_norm mode, and for
    every layer after the first s <= k <= 2 s, Cin a multiple of 128 and a
    stride that divides 8 (its kernels chain frame counts rounded to 8)."""
    if extractor_mode != "layer_norm":
        return False
    for i, (_, k, s) in enumerate(conv_layers):
        if i == 0:
            continue
        cin = conv_layers[i - 1][0]
        if not (s <= k <= 2 * s and cin % 128 == 0 and 8 % s == 0):
            return False
    return True


def fused_conv_frontend(wave: torch.Tensor, layer_params: Sequence[Mapping],
                        conv_layers: Sequence[Sequence[int]],
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The whole conv front-end on the fused kernels.

    wave (B, T) raw audio; ``layer_params[i]`` is ``{"conv": {"kernel": (k,
    Cin, Cout), "bias": (Cout,) or absent}, "ln": {"scale", "bias"}}``, the
    JAX package's ConvFeatureExtractor tree as tensors. Layer 0's conv is a
    library convolution (the JAX package leaves it to XLA) followed by
    :func:`ln_gelu`. Returns (B, num_frames, C_last), the frame count of
    the unfused front-end."""
    x = wave[:, None, :].to(dtype)                            # (B, 1, T)
    for i, (_, k, s) in enumerate(conv_layers):
        p = layer_params[i]
        kern = p["conv"]["kernel"].to(device=wave.device, dtype=dtype)
        bias = p["conv"].get("bias")
        if bias is None:             # conv_bias=False: zeros, as in JAX
            bias = torch.zeros(kern.shape[-1], device=wave.device)
        gamma, beta = p["ln"]["scale"], p["ln"]["bias"]
        if i == 0:
            y = F.conv1d(x, kern.permute(2, 1, 0), stride=s).transpose(1, 2)
            x = ln_gelu(y + bias.to(dtype), gamma, beta)
        else:
            x = conv_ln_gelu_grouped(x, kern, bias, gamma, beta, k=k, s=s)
    return x

"""AASIST graph-attention aggregation: the port of
``rtdsd_tpu/ops/pallas/gat.py`` (``fused_gat_aggregate`` and
``fused_htrg_gat_aggregate``).

Both take (B, N, D) node features and return the attention-aggregated
(B, N, D) nodes in float32, with the JAX functions' signatures and layouts:
``att_proj_kernel`` is (D, Do), the bias (Do,), edge vectors (Do, 1). On
CUDA tensors they launch ``csrc/gat.cu`` (design note at its top); on CPU
tensors they run the plain PyTorch versions beside them.
"""

from __future__ import annotations

import ctypes

import torch

from rtdsd_tpu_torch.ops import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "gat_aggregate_f32": [_P] * 5 + [_I] * 4 + [_F, _P],
    "htrg_gat_aggregate_f32": [_P] * 7 + [_I] * 5 + [_F, _P],
}
NODE_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232448
_QUERIES = 8


def _scores(x32: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """tanh((x_i * x_j) W + b): the (B, N, N, Do) pairwise projection."""
    pair = x32[:, :, None, :] * x32[:, None, :, :]
    return torch.tanh(pair @ w.float() + b.float())


def _aggregate(s: torch.Tensor, x32: torch.Tensor) -> torch.Tensor:
    return torch.softmax(s, dim=-1) @ x32          # softmax over j


def fused_gat_aggregate_reference(x, att_proj_kernel, att_proj_bias,
                                  att_weight, temperature: float = 1.0):
    x32 = x.float()
    proj = _scores(x32, att_proj_kernel, att_proj_bias)
    s = (proj @ att_weight.float().reshape(-1, 1))[..., 0] / temperature
    return _aggregate(s, x32)


def fused_htrg_gat_aggregate_reference(x, att_proj_kernel, att_proj_bias,
                                       w11, w22, w12, n1: int,
                                       temperature: float = 1.0):
    x32 = x.float()
    proj = _scores(x32, att_proj_kernel, att_proj_bias)
    s11, s22, s12 = ((proj @ w.float().reshape(-1, 1))[..., 0]
                     for w in (w11, w22, w12))
    is1 = torch.arange(x.shape[1], device=x.device) < n1
    same1 = is1[:, None] & is1[None, :]
    same2 = ~is1[:, None] & ~is1[None, :]
    s = torch.where(same1, s11, torch.where(same2, s22, s12)) / temperature
    return _aggregate(s, x32)


def _check(x: torch.Tensor, w: torch.Tensor, *vectors: torch.Tensor):
    b, n, d = x.shape
    do = w.shape[1]
    if w.shape != (d, do) or any(v.numel() != do for v in vectors):
        raise ValueError(f"GAT weights do not fit x {tuple(x.shape)}: W "
                         f"{tuple(w.shape)}, vectors "
                         f"{[tuple(v.shape) for v in vectors]}")
    if d not in NODE_DIMS:
        raise ValueError(f"node dim {d} not supported (have {NODE_DIMS})")
    if any(t.device != x.device for t in (w, *vectors)):
        raise ValueError("GAT inputs must lie on one CUDA device")
    smem = 4 * (n * (d + 1) + d * do + 4 * do + _QUERIES * n)
    if smem > SMEM_LIMIT:
        raise ValueError(f"N={n}, D={d}, Do={do} exceed the GAT kernel's "
                         f"shared memory")
    f32 = lambda t: t.detach().float().contiguous()
    return b, n, d, do, f32(x), f32(w), [f32(v).reshape(-1) for v in vectors]


def _launch(name: str, x32: torch.Tensor, args, dims) -> torch.Tensor:
    out = torch.empty_like(x32)
    lib = build.library("gat", _SIGNATURES)
    with torch.cuda.device(x32.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(x32.data_ptr(), *(t.data_ptr() for t in args),
                                out.data_ptr(), *dims, stream)
    build.check(rc, name)
    return out


def fused_gat_aggregate(x: torch.Tensor, att_proj_kernel: torch.Tensor,
                        att_proj_bias: torch.Tensor, att_weight: torch.Tensor,
                        temperature: float = 1.0) -> torch.Tensor:
    """(B, N, D) nodes -> (B, N, D) float32 attention-aggregated nodes."""
    if x.device.type == "cpu":
        return fused_gat_aggregate_reference(x, att_proj_kernel, att_proj_bias,
                                             att_weight, temperature)
    b, n, d, do, x32, w, (bias, a) = _check(x, att_proj_kernel, att_proj_bias,
                                            att_weight)
    out = _launch("gat_aggregate_f32", x32, (w, bias, a),
                  (b, n, d, do, float(temperature)))
    fused_gat_aggregate.launches += 1
    return out


def fused_htrg_gat_aggregate(x: torch.Tensor, att_proj_kernel: torch.Tensor,
                             att_proj_bias: torch.Tensor, w11: torch.Tensor,
                             w22: torch.Tensor, w12: torch.Tensor, n1: int,
                             temperature: float = 1.0) -> torch.Tensor:
    """Typed-edge aggregation: x is the concat of n1 type-1 and N - n1
    type-2 nodes; the edge vector is w11, w22 or w12 by the pair's types."""
    if x.device.type == "cpu":
        return fused_htrg_gat_aggregate_reference(
            x, att_proj_kernel, att_proj_bias, w11, w22, w12, n1, temperature)
    b, n, d, do, x32, w, (bias, a11, a22, a12) = _check(
        x, att_proj_kernel, att_proj_bias, w11, w22, w12)
    out = _launch("htrg_gat_aggregate_f32", x32, (w, bias, a11, a22, a12),
                  (b, n, d, do, int(n1), float(temperature)))
    fused_htrg_gat_aggregate.launches += 1
    return out


fused_gat_aggregate.launches = 0
fused_htrg_gat_aggregate.launches = 0

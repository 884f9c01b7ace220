"""AASIST graph-attention aggregation: the port of
``rtdsd_tpu/ops/pallas/gat.py`` (``fused_gat_aggregate`` and
``fused_htrg_gat_aggregate``).

Both take (B, N, D) node features and return the attention-aggregated
(B, N, D) nodes in float32, with the JAX functions' signatures and layouts:
``att_proj_kernel`` is (D, Do), the bias (Do,), edge vectors (Do, 1). They
are the custom operators ``torch.ops.rtdsd.fused_gat_aggregate`` and
``torch.ops.rtdsd.fused_htrg_gat_aggregate`` (``torch.library``, so
``torch.export`` records each as one node): on CUDA tensors they launch
``csrc/gat.cu`` (design note at its top) through :func:`launch_gat` and
:func:`launch_htrg`, on CPU tensors they run the plain PyTorch versions
beside them. They have no backward: the models call them in eval only.

Shape rule (:func:`tiled`): the register-tiled body takes Do in {8, 16, ...,
256} where its shared memory fits, reading ``x`` in float32, bfloat16 or
float16 and ``x`` and the kernel in any strides (the model passes
``att_proj.weight.t()``), so the wrapper launches no cast or copy kernel.
Other shapes go to the rows body, which takes contiguous float32 copies.
"""

from __future__ import annotations

import ctypes

import torch

from rtdsd_tpu_torch.ops import build

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "gat_aggregate_f32": [_P] * 5 + [_I] * 4 + [_F, _P],
    "htrg_gat_aggregate_f32": [_P] * 7 + [_I] * 5 + [_F, _P],
    "gat_tiled_aggregate": [_P, _I, _L, _L, _L, _P, _L, _L] + [_P] * 5
                           + [_I] * 5 + [_F, _P],
    "gat_rows_aggregate_f32": [_P] * 7 + [_I] * 5 + [_F, _P],
    "gat_tanh_check": [_P] * 3 + [_I, _P],
}
NODE_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232448
_QUERIES = 8                     # query rows per block of the rows body
_TILED_QUERIES = 8               # at most, in the tiled body
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def tiled_smem_bytes(n: int, d: int, do: int) -> int:
    """Shared memory of the tiled body at its most queries per block
    (``csrc/gat.cu::tiled_smem_bytes``)."""
    np_ = -(-n // 4) * 4
    return 4 * ((np_ + do) * (d + 4) + 4 * do + _TILED_QUERIES * np_)


def rows_smem_bytes(n: int, d: int, do: int) -> int:
    return 4 * (n * (d + 1) + d * do + 4 * do + _QUERIES * n)


def tiled(n: int, d: int, do: int) -> bool:
    """Whether the register-tiled body takes (N, D, Do)
    (``csrc/gat.cu::tiled_fits``)."""
    return (8 <= do <= 256 and do & (do - 1) == 0 and n >= 1
            and tiled_smem_bytes(n, d, do) <= SMEM_LIMIT)


def max_nodes(d: int, do: int, body: str) -> int:
    """The largest N the ``"tiled"`` or ``"rows"`` body takes at (D, Do)."""
    fits = ((lambda n: tiled(n, d, do)) if body == "tiled"
            else (lambda n: rows_smem_bytes(n, d, do) <= SMEM_LIMIT))
    n = 0
    while fits(n + 1):
        n += 1
    return n


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


def _check(x: torch.Tensor, w: torch.Tensor, *vectors: torch.Tensor) -> None:
    _, n, d = x.shape
    do = w.shape[1]
    if w.shape != (d, do) or any(v.numel() != do for v in vectors):
        raise ValueError(f"GAT weights do not fit x {tuple(x.shape)}: W "
                         f"{tuple(w.shape)}, vectors "
                         f"{[tuple(v.shape) for v in vectors]}")
    if d not in NODE_DIMS:
        raise ValueError(f"node dim {d} not supported (have {NODE_DIMS})")
    if any(t.device != x.device for t in (w, *vectors)):
        raise ValueError("GAT inputs must lie on one CUDA device")
    if not tiled(n, d, do) and rows_smem_bytes(n, d, do) > SMEM_LIMIT:
        raise ValueError(f"N={n}, D={d}, Do={do} exceed the GAT kernel's "
                         f"shared memory")


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, vectors, n1: int,
            temperature: float) -> torch.Tensor:
    """Launch the tiled body on ``x`` and ``w`` as they are where it takes
    their shape (a cast only for an ``x`` of another dtype), else the rows
    body through the f32 entry point ``name`` on contiguous float32 copies.
    ``vectors`` are the bias and the edge vector(s)."""
    b, n, d = x.shape
    do = w.shape[1]
    f32 = lambda t: t.detach().float()
    bias, *edges = [f32(v).reshape(-1) for v in vectors]
    out = torch.empty((b, n, d), device=x.device, dtype=torch.float32)
    lib = build.library("gat", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tiled(n, d, do):
            x = x.detach() if x.dtype in _X_TYPES else f32(x)
            w = f32(w)
            a11, a22, a12 = edges * 3 if len(edges) == 1 else edges
            rc = lib.gat_tiled_aggregate(
                x.data_ptr(), _X_TYPES[x.dtype], *x.stride(), w.data_ptr(),
                *w.stride(), bias.data_ptr(), a11.data_ptr(), a22.data_ptr(),
                a12.data_ptr(), out.data_ptr(), b, n, d, do, n1,
                float(temperature), stream)
            name = "gat_tiled_aggregate"
        else:
            args = [f32(x).contiguous(), f32(w).contiguous(), bias, *edges]
            n1_arg = [] if len(edges) == 1 else [n1]
            rc = getattr(lib, name)(*(t.data_ptr() for t in args),
                                    out.data_ptr(), b, n, d, do, *n1_arg,
                                    float(temperature), stream)
    build.check(rc, name)
    return out


def fused_gat_aggregate(x: torch.Tensor, att_proj_kernel: torch.Tensor,
                        att_proj_bias: torch.Tensor, att_weight: torch.Tensor,
                        temperature: float = 1.0) -> torch.Tensor:
    """(B, N, D) nodes -> (B, N, D) float32 attention-aggregated nodes."""
    return torch.ops.rtdsd.fused_gat_aggregate(
        x, att_proj_kernel, att_proj_bias, att_weight, float(temperature))


def fused_htrg_gat_aggregate(x: torch.Tensor, att_proj_kernel: torch.Tensor,
                             att_proj_bias: torch.Tensor, w11: torch.Tensor,
                             w22: torch.Tensor, w12: torch.Tensor, n1: int,
                             temperature: float = 1.0) -> torch.Tensor:
    """Typed-edge aggregation: x is the concat of n1 type-1 and N - n1
    type-2 nodes; the edge vector is w11, w22 or w12 by the pair's types."""
    return torch.ops.rtdsd.fused_htrg_gat_aggregate(
        x, att_proj_kernel, att_proj_bias, w11, w22, w12, int(n1),
        float(temperature))


def launch_gat(x: torch.Tensor, att_proj_kernel: torch.Tensor,
               att_proj_bias: torch.Tensor, att_weight: torch.Tensor,
               temperature: float) -> torch.Tensor:
    """The ``ctypes`` launch of :func:`fused_gat_aggregate` on CUDA tensors,
    the operator's CUDA implementation (callable without the dispatcher)."""
    _check(x, att_proj_kernel, att_proj_bias, att_weight)
    out = _launch("gat_aggregate_f32", x, att_proj_kernel,
                  (att_proj_bias, att_weight), x.shape[1], temperature)
    fused_gat_aggregate.launches += 1
    return out


def launch_htrg(x: torch.Tensor, att_proj_kernel: torch.Tensor,
                att_proj_bias: torch.Tensor, w11: torch.Tensor,
                w22: torch.Tensor, w12: torch.Tensor, n1: int,
                temperature: float) -> torch.Tensor:
    """The ``ctypes`` launch of :func:`fused_htrg_gat_aggregate` on CUDA
    tensors, the operator's CUDA implementation."""
    _check(x, att_proj_kernel, att_proj_bias, w11, w22, w12)
    out = _launch("htrg_gat_aggregate_f32", x, att_proj_kernel,
                  (att_proj_bias, w11, w22, w12), int(n1), temperature)
    fused_htrg_gat_aggregate.launches += 1
    return out


def _fake(x, *args):
    return x.new_empty(x.shape, dtype=torch.float32)


def _register(name: str, launcher, plain) -> None:
    """``torch.ops.rtdsd.<name>``: the CUDA launch, the plain version on
    the CPU, output shapes for tracing."""
    op = torch.library.custom_op(f"rtdsd::{name}", launcher, mutates_args=(),
                                 device_types="cuda")
    op.register_kernel("cpu")(plain)
    op.register_fake(_fake)


_register("fused_gat_aggregate", launch_gat, fused_gat_aggregate_reference)
_register("fused_htrg_gat_aggregate", launch_htrg,
          fused_htrg_gat_aggregate_reference)

fused_gat_aggregate.launches = 0
fused_htrg_gat_aggregate.launches = 0

"""Small-T multi-head self-attention: the port of
``rtdsd_tpu/ops/pallas/attention.py::mha_small_t``.

:func:`mha_small_t` takes (B, T, H, D) query, key and value (the BTHD layout
of ``jax.nn.dot_product_attention``) and returns the attention output in the
same layout and dtype. On a CUDA tensor it launches the hand-written kernel
in ``csrc/mha_small_t.cu`` (see the note at its top for the design: bf16 on
the tensor cores, float32 on the CUDA cores); on a CPU tensor it runs
:func:`mha_small_t_reference`, the plain PyTorch version of the same
arithmetic.

float32 has two kernels, chosen by a rule on the shape (:func:`f32_tiled`):
the register-tiled one for T up to 512 / 384 / 256 / 128 at D = 16 / 32 /
64 / 128, where its shared memory fits, and the one-warp-per-row one for
longer T.

The function is the custom operator ``torch.ops.rtdsd.mha_small_t``
(``torch.library``), so ``torch.export`` records it as one node of a
program and the selective checkpointing of a train step sees it as one
operator. Its CUDA implementation is :func:`launch` (the ``ctypes`` launch
of the kernel, which counts it), its CPU implementation the plain version,
and its fake implementation gives the output's shape and dtype for tracing.
Its backward (:func:`mha_small_t_backward`) is plain PyTorch in float32
that recomputes the probabilities. The JAX package's kernel has no backward
of its own either: its train step differentiates the XLA attention.

:func:`checkpoint_name` is the operator ``torch.ops.rtdsd.checkpoint_name``,
the counterpart of ``jax.ad_checkpoint.checkpoint_name``: an identity (a
copy, since an operator's output may not alias its input) whose output a
checkpointing policy can ask to keep by its name.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from rtdsd_tpu_torch.ops import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {name: [_P, _P, _P, _P, _I, _I, _I, _I, _P, _F, _P]
               for name in ("mha_small_t_f32", "mha_small_t_bf16")}
HEAD_DIMS = (16, 32, 64, 128)
SMEM_LIMIT = 232448   # bytes of shared memory one block may use on Hopper
_WARPS = 8            # warps of the float32 one-warp-per-row kernel's block
_TILE_ROWS = 64       # query rows of the float32 tiled kernel's score buffer
_KEY_STRIP = 32       # keys of one of its score tasks


def mha_small_t_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: f32 scores and softmax, p rounded to V's dtype
    after normalising, f32 accumulation of p V, output in the input dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def f32_tiled_smem_bytes(t: int, d: int) -> int:
    """Dynamic shared memory of the float32 tiled kernel's block: K and V of
    the head (T rounded up to 32 keys) and a 64-row Q tile, rows padded to
    D + 4 floats, the tile's 64 rows of scores, padded to T_32 + 4, and a
    float a row for 1 / its sum."""
    tk = -(-t // _KEY_STRIP) * _KEY_STRIP
    return 4 * ((2 * tk + _TILE_ROWS) * (d + 4) + _TILE_ROWS * (tk + 5))


def f32_tiled(t: int, d: int) -> bool:
    """The shape rule of the float32 path: the register-tiled kernel runs
    where its shared memory fits a block (T <= 512 / 384 / 256 / 128 at
    D = 16 / 32 / 64 / 128), the one-warp-per-row kernel past that.
    ``csrc/mha_small_t.cu::launch_f32`` applies the same rule."""
    return f32_tiled_smem_bytes(t, d) <= SMEM_LIMIT


def smem_bytes(t: int, d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block. bf16: K and V of the head, T
    rounded up to rows of D values: to 16 rows, or to 64 at D=64, where
    the kernel takes keys in 64-key groups. float32: the tiled kernel's
    (:func:`f32_tiled_smem_bytes`) where it runs, else the one-warp-per-row
    kernel's: K and V rows padded by a 32-bit word, plus one f32 score row
    per warp."""
    if dtype == torch.bfloat16:
        unit = 64 if d == 64 else 16
        return 2 * -(-t // unit) * unit * d * 2
    if f32_tiled(t, d):
        return f32_tiled_smem_bytes(t, d)
    return 2 * t * (d + 1) * 4 + _WARPS * t * 4


def supports(t: int, d: int, dtype: torch.dtype) -> bool:
    """Whether the CUDA kernel takes sequence length ``t`` at head dim ``d``
    in ``dtype``."""
    return (dtype in (torch.float32, torch.bfloat16) and d in HEAD_DIMS
            and t >= 1 and smem_bytes(t, d, dtype) <= SMEM_LIMIT)


def max_seq(d: int, dtype: torch.dtype) -> int:
    """The longest T the CUDA kernel takes at head dim ``d``."""
    t = SMEM_LIMIT // (2 * d * torch.empty((), dtype=dtype).element_size())
    while not supports(t, d, dtype):
        t -= 1
    return t


def f32_tiled_max_seq(d: int) -> int:
    """The longest T the float32 register-tiled kernel takes at head dim
    ``d`` (:func:`f32_tiled`)."""
    t = max_seq(d, torch.float32)
    while not f32_tiled(t, d):
        t -= 1
    return t


def _rows_aligned(x: torch.Tensor) -> bool:
    """Every (b, t, h) row of ``x`` starts on a 16-byte boundary."""
    size = x.element_size()
    return x.data_ptr() % 16 == 0 and all(
        s * size % 16 == 0 for s, n in zip(x.stride()[:3], x.shape[:3]) if n > 1)


def mha_small_t_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dout: torch.Tensor, scale: float):
    """(dQ, dK, dV) of softmax(s Q K^T) V for the output gradient ``dout``,
    in float32, cast back to the inputs' dtype: P recomputed, dV = P^T dO,
    dP = dO V^T, dS = P (dP - rowsum(dP P)), dQ = s dS K, dK = s dS^T Q."""
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, df)
    dp = torch.einsum("bqhd,bkhd->bhqk", df, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def mha_small_t(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention over (B, T, H, D) inputs with small T; default scale
    ``D ** -0.5``. Launches the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors; differentiable through the float32 backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return torch.ops.rtdsd.mha_small_t(q, k, v, float(scale))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float) -> torch.Tensor:
    """The kernel's ``ctypes`` launch on CUDA tensors, the operator's CUDA
    implementation (callable without the dispatcher, as the port bound the
    kernel before it was an operator): checks what the kernel takes,
    raises on the rest."""
    b, t, h, d = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32,
                                                             torch.bfloat16):
        raise TypeError(f"mha_small_t takes float32 or bfloat16 q, k, v of one "
                        f"dtype; got {q.dtype} {k.dtype} {v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported (have {HEAD_DIMS})")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("the head dimension of q, k, v must be contiguous")
    if not supports(t, d, q.dtype):
        raise ValueError(f"T={t} is too long for mha_small_t's shared memory")
    if q.dtype == torch.bfloat16 and not all(map(_rows_aligned, (q, k, v))):
        raise ValueError("the bf16 kernel copies q, k, v rows in 16-byte "
                         "pieces: each row must start on a 16-byte boundary")
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 9)(*(s for x in (q, k, v)
                                     for s in x.stride()[:3]))
    lib = build.library("mha_small_t", _SIGNATURES)
    fn = lib.mha_small_t_bf16 if q.dtype == torch.bfloat16 \
        else lib.mha_small_t_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, t, h, d, ctypes.cast(strides, ctypes.c_void_p),
                float(scale), stream)
    build.check(rc, "mha_small_t")
    mha_small_t.launches += 1
    return out


_op = torch.library.custom_op("rtdsd::mha_small_t", launch, mutates_args=(),
                              device_types="cuda")


@_op.register_kernel("cpu")
def _plain(q, k, v, scale):
    return mha_small_t_reference(q, k, v, scale)


@_op.register_fake
def _fake(q, k, v, scale):
    return q.new_empty(q.shape)


def _save(ctx, inputs, output):
    q, k, v, scale = inputs
    ctx.save_for_backward(q, k, v)
    ctx.scale = scale


def _backward(ctx, dout):
    return (*mha_small_t_backward(*ctx.saved_tensors, dout, ctx.scale), None)


_op.register_autograd(_backward, setup_context=_save)
mha_small_t.launches = 0


@torch.library.custom_op("rtdsd::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under ``name`` for a checkpointing policy; its value is
    ``x``'s."""
    return x.clone()


@checkpoint_name.register_fake
def _fake_name(x, name):
    return torch.empty_like(x)


checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None),
    setup_context=lambda ctx, inputs, output: None)

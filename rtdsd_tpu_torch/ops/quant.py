"""Per-column int8 quantization: the port of
``rtdsd_tpu/ops/pallas/quant.py``.

:func:`quantize_int8` turns an (R, C) float matrix into (R, C) int8 values
and (1, C) float32 scales, ``scale = max(max|x|, 1e-12) * float32(1/127)``
per column. On a CUDA tensor it launches ``csrc/quant.cu`` (design note at
its top), one kernel and nothing else when x is a float32 matrix either
row-major or the transposed view of a row-major one (a model's
``weight.t()``: see :func:`kernel_operand`), and rounds stochastically by
default, as the TPU kernel does;
``stochastic=False`` asks the kernel for round-to-nearest. On a CPU tensor
it runs
:func:`quantize_int8_reference` and rounds to nearest by default, which is
what the JAX package computes off the TPU (f32 divide, round half to even,
clip), bit for bit.

The random bits of stochastic rounding are a hash of (seed, row, column):
the kernel cannot give the TPU's generator's bits, but the plain version
reproduces the kernel's with int64 tensor arithmetic masked to 32 bits, so
the two agree bit for bit in both modes.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from rtdsd_tpu_torch.ops import build

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {"quantize_int8_f32": [_P, _P, _P, _I, _I, _U, _I, _I, _P]}
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2^32 for int64 x in [0, 2^32) (a tensor or a Python int):
    the constant is split into 16-bit halves so that no product reaches
    2^63."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """The kernel's ``mix32`` (lowbias32) on int64 tensors holding uint32,
    or on a Python int."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def random_bits(seed: int, rows: int, cols: int,
                device=None) -> torch.Tensor:
    """The kernel's 32-bit random bits for every (row, column), as int64:
    ``mix32(mix32(mix32(seed) + row) + column)`` mod 2^32."""
    key = _mix32(seed & _M32)
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    return _mix32((_mix32((key + r) & _M32) + c) & _M32)


def quantize_int8_reference(x: torch.Tensor, seed: int = 0,
                            stochastic: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on x's device."""
    x = x.float()
    # times the float32 reciprocal of 127: XLA compiles the JAX package's
    # division by the constant so, and the scales match it bit for bit
    scale = x.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    scaled = x / scale
    if stochastic:
        bits = random_bits(seed, *x.shape, device=x.device)
        u = (bits >> 8).float() * (1.0 / (1 << 24))
        q = torch.floor(scaled + u)
    else:
        q = torch.round(scaled)
    return q.clamp(-128, 127).to(torch.int8), scale


def kernel_operand(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """The float32 matrix the kernel reads for x, and whether it is the
    transposed view of a row-major matrix (strides (1, R)). Both layouts
    are read in place; any other layout or dtype is copied to a row-major
    float32 matrix first."""
    x = x.detach()
    if x.dtype == torch.float32:
        if x.is_contiguous():
            return x, False
        if x.t().is_contiguous():
            return x, True
    return x.float().contiguous(), False


def quantize_int8(x: torch.Tensor, seed: int = 0,
                  stochastic: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, C) float -> ((R, C) int8 values, (1, C) float32 scales).

    ``stochastic=None`` rounds stochastically on a CUDA tensor (the kernel)
    and to nearest on a CPU tensor (the plain version)."""
    if x.dim() != 2:
        raise ValueError(f"quantize_int8 takes a 2-D matrix, got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_int8_reference(x, seed, bool(stochastic))
    if not x.is_cuda or not x.is_floating_point():
        raise TypeError(f"quantize_int8 takes a float CUDA or CPU tensor, got "
                        f"{x.dtype} on {x.device}")
    r, c = x.shape
    x32, transposed = kernel_operand(x)
    vals = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scales = torch.empty((1, c), dtype=torch.float32, device=x.device)
    lib = build.library("quant", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.quantize_int8_f32(x32.data_ptr(), vals.data_ptr(),
                                   scales.data_ptr(), r, c, seed & _M32,
                                   int(stochastic is None or stochastic),
                                   int(transposed), stream)
    build.check(rc, "quantize_int8")
    quantize_int8.launches += 1
    return vals, scales


quantize_int8.launches = 0


def dequantize_int8(vals: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (vals.float() * scales).to(dtype)


def quantized_matmul(x: torch.Tensor, w_vals: torch.Tensor,
                     w_scales: torch.Tensor) -> torch.Tensor:
    """x @ dequant(w) in x's dtype: the int8 weight is cast to it, and the
    per-column scale applied after the product."""
    return (x @ w_vals.to(x.dtype)) * w_scales.to(x.dtype)

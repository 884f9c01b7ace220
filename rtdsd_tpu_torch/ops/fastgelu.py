"""Rational-minimax erf GELU, the port of ``rtdsd_tpu/ops/fastgelu.py``.

erf(z) ~= z * P(z^2) / Q(z^2) for |z| <= 2.92 (clamped beyond), max
absolute error 1.3e-6 in float32. The encoder uses it only when it computes
in (b)f16, where that error sits far below the dtype's resolution; float32
keeps the exact erf.

:func:`gelu_fast` is the custom operator ``torch.ops.rtdsd.gelu_fast``
(``torch.library``, so ``torch.export`` records it as one node). On a CUDA
tensor it launches ``csrc/fastgelu.cu`` (design note at its top), which
reads x once and writes the result once and gives the plain version's
output bit for bit; on a CPU tensor it runs :func:`gelu_fast_reference`,
the plain PyTorch chain. Its output has ``torch.empty_like(x)``'s layout,
the plain chain's. Its backward is the plain chain's gradient, recomputed
from the saved input.
"""

import ctypes

import torch

from rtdsd_tpu_torch.ops import build

_P = (1.128387124150406, 0.15306343552001833,
      0.04342919271314016, 0.0007634787181375913)
_Q = (1.0, 0.46905443006720976, 0.09462941533472911, 0.009403159294456582)
_ZMAX = 2.92
_INV_SQRT2 = 0.7071067811865476

_SIGNATURES = {"gelu_fast": [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def erf_rational(z: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(z, -_ZMAX, _ZMAX)
    u = z * z
    p = ((_P[3] * u + _P[2]) * u + _P[1]) * u + _P[0]
    q = ((_Q[3] * u + _Q[2]) * u + _Q[1]) * u + _Q[0]
    return z * p / q


def gelu_fast_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: the rational-erf GELU in float32, returned in x's
    dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + erf_rational(xf * _INV_SQRT2))).to(x.dtype)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """GELU with the rational erf, computed in float32, returned in x's
    dtype: the kernel on a CUDA tensor, the plain version on a CPU one."""
    return torch.ops.rtdsd.gelu_fast(x)


def gelu(x: torch.Tensor, *, fast: bool = True) -> torch.Tensor:
    if fast:
        return gelu_fast(x)
    return torch.nn.functional.gelu(x, approximate="none")


def launch(x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``ctypes`` launch on a CUDA tensor of float32, bfloat16
    or float16, the operator's CUDA implementation. A dense input of any
    strides is read in place; any other is first copied once into
    ``torch.empty_like``'s layout. Any storage offset is taken (a view that
    does not start on a 16-byte boundary is read one element a thread)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"gelu_fast takes float32, bfloat16 or float16; "
                        f"got {x.dtype}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    if out.stride() != x.stride():      # not dense: the plain chain's layout
        x = torch.empty_like(x).copy_(x)
    lib = build.library("fastgelu", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gelu_fast(x.data_ptr(), out.data_ptr(), x.numel(),
                           _DTYPES[x.dtype], stream)
    build.check(rc, "gelu_fast")
    _counted.launches += 1
    return out


_op = torch.library.custom_op("rtdsd::gelu_fast", launch, mutates_args=(),
                              device_types="cuda")
_op.register_kernel("cpu")(gelu_fast_reference)


@_op.register_fake
def _fake(x):
    return torch.empty_like(x)


def _save(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _backward(ctx, grad):
    x, = ctx.saved_tensors
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        return torch.autograd.grad(gelu_fast_reference(x), x, grad)[0]


_op.register_autograd(_backward, setup_context=_save)
gelu_fast.launches = 0
# the function that holds the count, also while a caller has swapped the
# module's ``gelu_fast`` for a wrapper of it or for ``launch``
_counted = gelu_fast

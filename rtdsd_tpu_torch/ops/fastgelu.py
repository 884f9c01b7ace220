"""Rational-minimax erf GELU, the port of ``rtdsd_tpu/ops/fastgelu.py``.

erf(z) ~= z * P(z^2) / Q(z^2) for |z| <= 2.92 (clamped beyond), max
absolute error 1.3e-6 in float32. The encoder uses it only when it computes
in (b)f16, where that error sits far below the dtype's resolution; float32
keeps the exact erf.
"""

import torch

_P = (1.128387124150406, 0.15306343552001833,
      0.04342919271314016, 0.0007634787181375913)
_Q = (1.0, 0.46905443006720976, 0.09462941533472911, 0.009403159294456582)
_ZMAX = 2.92
_INV_SQRT2 = 0.7071067811865476


def erf_rational(z: torch.Tensor) -> torch.Tensor:
    z = torch.clamp(z, -_ZMAX, _ZMAX)
    u = z * z
    p = ((_P[3] * u + _P[2]) * u + _P[1]) * u + _P[0]
    q = ((_Q[3] * u + _Q[2]) * u + _Q[1]) * u + _Q[0]
    return z * p / q


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """GELU with the rational erf, computed in float32, returned in x's dtype."""
    xf = x.float()
    return (0.5 * xf * (1.0 + erf_rational(xf * _INV_SQRT2))).to(x.dtype)


def gelu(x: torch.Tensor, *, fast: bool = True) -> torch.Tensor:
    if fast:
        return gelu_fast(x)
    return torch.nn.functional.gelu(x, approximate="none")

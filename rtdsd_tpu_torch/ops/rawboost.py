"""RawBoost data boosting, batched on the device: the port of
``rtdsd_tpu/ops/rawboost.py``.

The reference runs RawBoost per utterance with numpy/scipy on the host:
LnL convolutive noise (random multi-notch FIR banks over signal powers),
ISD impulsive signal-dependent noise, SSI stationary coloured additive
noise, composed into algorithms 1-8. Here every function takes a batch
(..., T) and draws from an explicit ``torch.Generator`` on the batch's
device, so a train step's augmentation is a function of its seed. The JAX
package's structure is kept: random tap counts live in fixed buffers
(128 taps a band, 512 a chain) masked past their length, filters apply as
rFFT convolutions with the reference's centred slice, and ISD picks exactly
``floor(T * beta / 100)`` uniform positions by ranking uniform draws.

The deterministic cores (:func:`notch_chain_from_params`,
:func:`lnl_from_chains`, :func:`isd_from_params`, :func:`ssi_from_params`,
:func:`filter_fir`, :func:`norm_wav`) take the random draws as arguments;
they are what the tests hold against the JAX package's (random draws cannot
match across frameworks).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RawBoostArgs:
    """The reference's parameter block (its train_set.py defaults)."""

    nBands: int = 5
    minF: float = 20.0
    maxF: float = 8000.0
    minBW: float = 100.0
    maxBW: float = 1000.0
    minCoeff: int = 10
    maxCoeff: int = 100
    minG: float = 0.0
    maxG: float = 0.0
    minBiasLinNonLin: float = 5.0
    maxBiasLinNonLin: float = 20.0
    N_f: int = 5
    P: float = 10.0
    g_sd: float = 2.0
    SNRmin: float = 10.0
    SNRmax: float = 40.0


MAX_BAND_TAPS = 128      # maxCoeff 100, odd-ified to 101 taps a band
MAX_CHAIN_TAPS = 512     # 5 chained bands: 5 * (101 - 1) + 1 = 501 taps
_FREQZ_N = 512           # scipy.signal.freqz's default worN

Chain = Tuple[torch.Tensor, torch.Tensor]   # (taps (..., 512), length (...))


def firwin_bandstop(c: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                    fs: float, max_taps: int = MAX_BAND_TAPS) -> torch.Tensor:
    """``scipy.signal.firwin(c, [f1, f2], window='hamming', fs=fs)``
    band-stop for each element of ``c`` (odd tap counts, float), ``f1``,
    ``f2`` (...): (..., max_taps), entries at and past ``c`` zero, unit
    gain at DC."""
    n = torch.arange(max_taps, dtype=torch.float32, device=c.device)
    c, f1, f2 = c[..., None], f1[..., None], f2[..., None]
    m = n - (c - 1.0) / 2.0
    w1, w2 = f1 / (fs / 2.0), f2 / (fs / 2.0)
    h = w1 * torch.sinc(w1 * m) + torch.sinc(m) - w2 * torch.sinc(w2 * m)
    h = h * (0.54 - 0.46 * torch.cos(2.0 * math.pi * n / (c - 1.0)))
    h = torch.where(n < c, h, torch.zeros((), device=c.device))
    return h / h.sum(dim=-1, keepdim=True)


def _conv_full_fixed(a: torch.Tensor, b: torch.Tensor, out_len: int
                     ) -> torch.Tensor:
    """Full convolution of two fixed-size buffers along the last axis,
    truncated to ``out_len``."""
    nfft = 1 << (out_len + b.shape[-1] - 1).bit_length()
    fa = torch.fft.rfft(a, nfft)
    fb = torch.fft.rfft(b, nfft)
    return torch.fft.irfft(fa * fb, nfft)[..., :out_len]


def notch_chain_from_params(fcs: torch.Tensor, bws: torch.Tensor,
                            cs: torch.Tensor, g: torch.Tensor, fs: float
                            ) -> Chain:
    """The multi-notch FIR chain from its random draws: per band (last axis
    of ``fcs``, ``bws``, ``cs``, as the reference's ``randRange`` returns
    them, tap counts before odd-ification) and the gain ``g`` (...).
    Returns (taps (..., 512), length (...))."""
    shape = fcs.shape[:-1]
    b = torch.zeros(shape + (MAX_CHAIN_TAPS,), device=fcs.device)
    b[..., 0] = 1.0
    length = torch.ones(shape, dtype=torch.int64, device=fcs.device)
    for i in range(fcs.shape[-1]):
        c = cs[..., i].to(torch.int64)
        c = c + (c % 2 == 0).to(torch.int64)          # odd-ify
        f1 = torch.clamp(fcs[..., i] - bws[..., i] / 2.0, min=1.0 / 1000.0)
        f2 = torch.clamp(fcs[..., i] + bws[..., i] / 2.0,
                         max=fs / 2.0 - 1.0 / 1000.0)
        h = firwin_bandstop(c.to(torch.float32), f1, f2, fs)
        b = _conv_full_fixed(h, b, MAX_CHAIN_TAPS)
        length = length + c - 1
    # freqz(b, 1) over 512 points of [0, pi): an rFFT on a 1024-point grid
    peak = torch.fft.rfft(b, 2 * _FREQZ_N)[..., :_FREQZ_N].abs().amax(dim=-1)
    return (10.0 ** (g / 20.0))[..., None] * b / peak[..., None], length


def filter_fir(x: torch.Tensor, b: torch.Tensor, length: torch.Tensor
               ) -> torch.Tensor:
    """Centred FIR filtering: the full convolution, sliced T samples from
    ``(length + 1) // 2`` on (the reference pads, filters and slices)."""
    t = x.shape[-1]
    y = _conv_full_fixed(x, b, t + MAX_CHAIN_TAPS)
    start = torch.div(length + 1, 2, rounding_mode="floor")
    idx = start[..., None] + torch.arange(t, device=x.device)
    return torch.gather(y, -1, idx.expand(y.shape[:-1] + (t,)))


def norm_wav(x: torch.Tensor, always: bool) -> torch.Tensor:
    """Divide each row by its peak: always, or only where the peak is
    above 1."""
    peak = x.abs().amax(dim=-1, keepdim=True)
    if always:
        return x / peak
    return torch.where(peak > 1.0, x / peak, x)


def lnl_from_chains(x: torch.Tensor, chains: Sequence[Chain]) -> torch.Tensor:
    """LnL convolutive noise from its notch chains: stage i filters
    ``x ** (i + 1)``; the sum is mean-removed and peak-normalised."""
    y = torch.zeros_like(x)
    for i, (b, length) in enumerate(chains):
        y = y + filter_fir(torch.pow(x, i + 1), b, length)
    return norm_wav(y - y.mean(dim=-1, keepdim=True), always=False)


def isd_from_params(x: torch.Tensor, selected: torch.Tensor,
                    f_r: torch.Tensor, g_sd: float) -> torch.Tensor:
    """ISD noise from the selection mask and the per-sample factors:
    ``x + g_sd * x * f_r`` at the selected samples, peak-normalised."""
    return norm_wav(torch.where(selected, x + g_sd * x * f_r, x),
                    always=False)


def ssi_from_params(x: torch.Tensor, noise: torch.Tensor, b: torch.Tensor,
                    length: torch.Tensor, snr: torch.Tensor) -> torch.Tensor:
    """SSI noise from the raw noise, its notch chain and the SNR draw (dB,
    (...)): the coloured noise scaled to the SNR against ``x``, added."""
    noise = norm_wav(filter_fir(noise, b, length), always=True)
    scale = (torch.linalg.vector_norm(x, dim=-1)
             / torch.linalg.vector_norm(noise, dim=-1)
             / 10.0 ** (0.05 * snr))
    return x + noise * scale[..., None]


# ----------------------------------------------------------- random draws

def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def gen_notch_coeffs(gen: torch.Generator, shape: Tuple[int, ...],
                     args: RawBoostArgs, fs: float, min_g: float,
                     max_g: float, device) -> Chain:
    """Random multi-notch chains, one for each element of ``shape``."""
    nb = (args.nBands,)
    fcs = _uniform(gen, shape + nb, args.minF, args.maxF, device)
    bws = _uniform(gen, shape + nb, args.minBW, args.maxBW, device)
    cs = torch.floor(_uniform(gen, shape + nb, float(args.minCoeff),
                              float(args.maxCoeff), device))
    g = _uniform(gen, shape, min_g, max_g, device)
    return notch_chain_from_params(fcs, bws, cs, g, fs)


def lnl_convolutive_noise(gen: torch.Generator, x: torch.Tensor,
                          args: RawBoostArgs, fs: float) -> torch.Tensor:
    """Linear and non-linear convolutive noise; stages from the second on
    take the gain bias."""
    chains = []
    min_g, max_g = float(args.minG), float(args.maxG)
    for i in range(args.N_f):
        if i == 1:
            min_g -= args.minBiasLinNonLin
            max_g -= args.maxBiasLinNonLin
        chains.append(gen_notch_coeffs(gen, x.shape[:-1], args, fs, min_g,
                                       max_g, x.device))
    return lnl_from_chains(x, chains)


def isd_additive_noise(gen: torch.Generator, x: torch.Tensor,
                       args: RawBoostArgs) -> torch.Tensor:
    """Impulsive signal-dependent noise at ``floor(T * beta / 100)``
    uniformly chosen samples of each row, beta ~ U(0, P)."""
    t = x.shape[-1]
    beta = _uniform(gen, x.shape[:-1], 0.0, args.P, x.device)
    n = torch.floor(t * beta / 100.0)
    rank = torch.rand(x.shape, generator=gen, device=x.device).argsort(
        dim=-1).argsort(dim=-1)
    f_r = ((2.0 * torch.rand(x.shape, generator=gen, device=x.device) - 1.0)
           * (2.0 * torch.rand(x.shape, generator=gen, device=x.device) - 1.0))
    return isd_from_params(x, rank < n[..., None], f_r, args.g_sd)


def ssi_additive_noise(gen: torch.Generator, x: torch.Tensor,
                       args: RawBoostArgs, fs: float) -> torch.Tensor:
    """Stationary coloured additive noise at an SNR ~ U(SNRmin, SNRmax)."""
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    b, length = gen_notch_coeffs(gen, x.shape[:-1], args, fs,
                                 float(args.minG), float(args.maxG), x.device)
    snr = _uniform(gen, x.shape[:-1], args.SNRmin, args.SNRmax, x.device)
    return ssi_from_params(x, noise, b, length, snr)


def rawboost(x: torch.Tensor, algo: Optional[int], gen: torch.Generator,
             args: RawBoostArgs = RawBoostArgs(),
             fs: float = 16000.0) -> torch.Tensor:
    """RawBoost algorithm ``algo`` on a batch (B, T) of float32 waves, with
    the reference's dispatch: 1 LnL, 2 ISD, 3 SSI, 4 = 1+2+3 in series,
    5 = 1+2, 6 = 1+3, 7 = 2+3, 8 = 1 and 2 in parallel, summed and
    normalised; any other value is the identity."""
    if algo in (1, 4, 5, 6, 8):
        lnl = lnl_convolutive_noise(gen, x, args, fs)
    if algo == 8:
        return norm_wav(lnl + isd_additive_noise(gen, x, args), always=False)
    if algo in (1, 4, 5, 6):
        x = lnl
    if algo in (2, 4, 5, 7):
        x = isd_additive_noise(gen, x, args)
    if algo in (3, 4, 6, 7):
        x = ssi_additive_noise(gen, x, args, fs)
    return x

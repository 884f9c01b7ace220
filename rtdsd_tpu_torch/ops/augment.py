"""Batched waveform augmentation on the device: the port of
``rtdsd_tpu/ops/augment.py``.

The reference's two chains, with the JAX package's parameters
(``DEFAULT_PARAMS``) and codes:

- the trainer-side chain after pre-emphasis: ACN coloured noise at a
  sampled SNR (white noise shaped by ``linspace(1, sqrt(nyquist)) **
  -f_decay``), HPF / LPF 127-tap windowed-sinc FIRs at a sampled cutoff
  applied as a centred FFT convolution, GAN gain, TMK time mask;
- the math half of the dataset-side ``mul_augment`` chain: TST time
  stretch (a length-preserving phase vocoder over the JAX package's own
  STFT framing), GAN, AIR air absorption, TMK (the corpus and codec half
  runs on the host, :mod:`rtdsd_tpu_torch.data.host_augment`).

Every function takes a batch (B, T). Each code is applied to every row and
kept where a Bernoulli draw says so (``torch.where``), so every example
costs the same. The draws of a batch come from one ``torch.Generator`` on
the batch's device, shape (B,) a draw, as RawBoost's do
(:mod:`.rawboost`); the codes apply in ``aug_list`` order. The
deterministic cores (:func:`colored_noise`, :func:`add_colored_noise`,
:func:`sinc_fir`, :func:`fir_same`, :func:`gain`, :func:`time_mask`,
:func:`time_stretch`, :func:`air_absorption`) take the draws as
arguments: random draws cannot match across frameworks, the cores can.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

DEFAULT_PARAMS: Dict[str, Dict[str, float]] = {
    "sr": 16000,
    "ACN": {"min_snr_in_db": 10, "max_snr_in_db": 40,
            "min_f_decay": -2.0, "max_f_decay": 2.0, "p": 0.5},
    "HPF": {"min_cutoff_freq": 20.0, "max_cutoff_freq": 2400.0, "p": 0.5},
    "LPF": {"min_cutoff_freq": 150.0, "max_cutoff_freq": 7500.0, "p": 0.5},
    "GAN": {"min_gain_in_db": -12.0, "max_gain_in_db": 12.0, "p": 0.75},
    "TMK": {"min_band_part": 0.1, "max_band_part": 0.15, "p": 0.5},
    "TST": {"min_rate": 0.8, "max_rate": 1.2, "p": 0.75},
    "AIR": {"min_distance": 1.0, "max_distance": 20.0, "p": 0.75},
}

FIR_TAPS = 127
TST_NFFT = 1024
TST_HOP = 256


def _col(v: torch.Tensor) -> torch.Tensor:
    """A per-row draw (B,) as a column (B, 1)."""
    return v.reshape(-1, 1)


# ----------------------------------------------------------------- cores

def colored_noise(white: torch.Tensor, f_decay: torch.Tensor, sr: float
                  ) -> torch.Tensor:
    """White noise (B, n) shaped to amplitude ``linspace(1, sqrt(sr / 2))
    ** -f_decay`` over the rFFT bins (``f_decay`` 0: white)."""
    n = white.shape[-1]
    spec = torch.fft.rfft(white)
    ramp = torch.linspace(1.0, (sr / 2.0) ** 0.5, spec.shape[-1],
                          device=white.device)
    return torch.fft.irfft(spec * ramp ** -_col(f_decay), n)


def add_colored_noise(x: torch.Tensor, apply: torch.Tensor,
                      snr_db: torch.Tensor, noise: torch.Tensor
                      ) -> torch.Tensor:
    """``x`` plus ``noise`` scaled to ``snr_db`` below the row's RMS, where
    ``apply``."""
    sig = torch.sqrt((x ** 2).mean(-1, keepdim=True) + 1e-12)
    nrm = torch.sqrt((noise ** 2).mean(-1, keepdim=True) + 1e-12)
    noise = noise * (sig / nrm) / 10.0 ** (_col(snr_db) / 20.0)
    return torch.where(_col(apply), x + noise, x)


def sinc_fir(cutoff_hz: torch.Tensor, sr: float, highpass: bool,
             taps: int = FIR_TAPS) -> torch.Tensor:
    """Hamming-windowed sinc low- or high-pass FIRs (B, taps), one for each
    cutoff, unit gain at DC (high-pass: the delta minus the low-pass)."""
    dev = cutoff_hz.device
    n = torch.arange(taps, dtype=torch.float32, device=dev)
    wc = _col(cutoff_hz) / (sr / 2.0)
    h = wc * torch.sinc(wc * (n - (taps - 1) / 2.0))
    h = h * (0.54 - 0.46 * torch.cos(2 * math.pi * n / (taps - 1)))
    h = h / h.sum(-1, keepdim=True)
    if highpass:
        delta = torch.zeros(taps, device=dev)
        delta[(taps - 1) // 2] = 1.0
        h = delta - h
    return h


def fir_same(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Each row of ``x`` (B, T) convolved with its FIR ``h`` (B, k), the
    centred 'same' part, by FFT."""
    t, k = x.shape[-1], h.shape[-1]
    nfft = 1 << (t + k - 1).bit_length()
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h, nfft), nfft)
    return y[..., (k - 1) // 2:(k - 1) // 2 + t]


def gain(x: torch.Tensor, apply: torch.Tensor, gain_db: torch.Tensor
         ) -> torch.Tensor:
    return torch.where(_col(apply), x * 10.0 ** (_col(gain_db) / 20.0), x)


def time_mask(x: torch.Tensor, apply: torch.Tensor, frac: torch.Tensor,
              start: torch.Tensor) -> torch.Tensor:
    """Zero ``int(frac * T)`` samples from ``start`` with a linear fade over
    a tenth of the mask at each edge, where ``apply``."""
    t = x.shape[-1]
    length = _col((frac * t).to(torch.int32))
    start = _col(start.to(torch.int32))
    idx = torch.arange(t, device=x.device)[None]
    inside = (idx >= start) & (idx < start + length)
    fade = torch.clamp(length // 10, min=1)
    ramp_in = torch.clamp((idx - start) / fade, 0.0, 1.0)
    ramp_out = torch.clamp((start + length - 1 - idx) / fade, 0.0, 1.0)
    g = torch.where(inside, 1.0 - torch.minimum(ramp_in, ramp_out), 1.0)
    return torch.where(_col(apply), x * g, x)


def _hanning(n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.hanning(n).astype(np.float32)).to(device)


def stft_frames(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) -> complex (B, frames, n_fft // 2 + 1): reflect-padded by
    n_fft // 2 at both ends, symmetric Hann window (the JAX package's
    ``_stft_frames``, not ``torch.stft``'s defaults)."""
    pad = n_fft // 2
    xp = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, n_fft, hop)
    return torch.fft.rfft(frames * _hanning(n_fft, x.device), dim=-1)


def istft_frames(frames: torch.Tensor, n_fft: int, hop: int, length: int
                 ) -> torch.Tensor:
    """Overlap-add inverse of :func:`stft_frames` with window-square
    normalisation -> (B, length)."""
    win = _hanning(n_fft, frames.device)
    y = torch.fft.irfft(frames, n_fft, dim=-1) * win
    n = y.shape[1]
    total = n_fft + hop * (n - 1)

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.fold(
            cols.transpose(1, 2), (1, total), (1, n_fft),
            stride=(1, hop))[:, 0, 0]

    norm = overlap_add((win ** 2).expand(1, n, n_fft))
    y = overlap_add(y) / torch.clamp(norm, min=1e-8)
    pad = n_fft // 2
    return y[:, pad:pad + length]


def time_stretch(x: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Length-preserving, pitch-preserving time stretch by ``rate`` (B,): a
    phase vocoder in which output frame t reads input position t * rate
    (magnitudes interpolated, phase advanced by the measured per-bin
    increment); past the input's end the frames are zero. The phase is
    accumulated frame by frame in float32, in the order of the JAX
    package's scan."""
    t = x.shape[-1]
    spec = stft_frames(x.float(), TST_NFFT, TST_HOP)
    n_in, n_bins = spec.shape[1], spec.shape[2]
    dev = x.device
    omega = (2.0 * math.pi * torch.arange(n_bins, device=dev) / TST_NFFT
             ) * TST_HOP
    mag, phase = spec.abs(), torch.angle(spec)
    dphi = torch.diff(phase, dim=1) - omega
    dphi = dphi - 2.0 * math.pi * torch.round(dphi / (2.0 * math.pi)) + omega

    pos = torch.arange(n_in, dtype=torch.float32, device=dev) * _col(rate)
    p0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n_in - 1)
    frac = torch.clamp(pos - p0, 0.0, 1.0)[..., None]

    def take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return torch.gather(a, 1, i[..., None].expand(-1, -1, a.shape[2]))

    mags = ((1.0 - frac) * take(mag, p0)
            + frac * take(mag, torch.clamp(p0 + 1, 0, n_in - 1)))
    mags = torch.where((pos <= n_in - 1)[..., None], mags, 0.0)
    steps = take(dphi, torch.clamp(p0, 0, n_in - 2))
    acc = torch.empty_like(mags)
    acc[:, 0] = phase[:, 0]
    for i in range(1, n_in):
        torch.add(acc[:, i - 1], steps[:, i - 1], out=acc[:, i])
    out = torch.polar(mags, acc)
    return istft_frames(out, TST_NFFT, TST_HOP, t).to(x.dtype)


def air_absorption(x: torch.Tensor, distance: torch.Tensor, sr: float
                   ) -> torch.Tensor:
    """High-frequency attenuation over ``distance`` metres (B,): spectral
    gain 10 ** (-0.006 (f / 1 kHz) ** 1.8 d / 20)."""
    t = x.shape[-1]
    spec = torch.fft.rfft(x)
    freqs = torch.fft.rfftfreq(t, 1.0 / sr, device=x.device)
    atten_db = 0.006 * (freqs / 1000.0) ** 1.8 * _col(distance)
    return torch.fft.irfft(spec * 10.0 ** (-atten_db / 20.0), t)


# ------------------------------------------------------------- the chains

def _uniform(gen: torch.Generator, n: int, lo: float, hi: float, device
             ) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def augment(x: torch.Tensor, aug_list: Sequence[str], gen: torch.Generator,
            sr: float = 16000.0) -> torch.Tensor:
    """The codes of ``aug_list`` applied in order to a batch (B, T) of
    float32 waves, each row kept or augmented by its own Bernoulli draw
    (``DEFAULT_PARAMS``' p), the draws from ``gen`` on ``x``'s device."""
    b, t = x.shape
    dev = x.device
    for name in aug_list:
        if name not in DEFAULT_PARAMS or name == "sr":
            raise ValueError(f"unknown augmentation code {name!r}")
        a = DEFAULT_PARAMS[name]
        apply = torch.rand(b, generator=gen, device=dev) < a["p"]
        if name == "ACN":
            snr = _uniform(gen, b, a["min_snr_in_db"], a["max_snr_in_db"], dev)
            fd = _uniform(gen, b, a["min_f_decay"], a["max_f_decay"], dev)
            white = torch.randn((b, t), generator=gen, device=dev)
            x = add_colored_noise(x, apply, snr, colored_noise(white, fd, sr))
        elif name in ("HPF", "LPF"):
            cut = _uniform(gen, b, a["min_cutoff_freq"], a["max_cutoff_freq"],
                           dev)
            y = fir_same(x, sinc_fir(cut, sr, highpass=name == "HPF"))
            x = torch.where(_col(apply), y, x)
        elif name == "GAN":
            x = gain(x, apply, _uniform(gen, b, a["min_gain_in_db"],
                                        a["max_gain_in_db"], dev))
        elif name == "TMK":
            frac = _uniform(gen, b, a["min_band_part"], a["max_band_part"], dev)
            length = (frac * t).to(torch.int32)
            span = torch.clamp(t - length, min=1)
            start = torch.floor(torch.rand(b, generator=gen, device=dev)
                                * span).to(torch.int32)
            x = time_mask(x, apply, frac, torch.minimum(start, span - 1))
        elif name == "TST":
            rate = _uniform(gen, b, a["min_rate"], a["max_rate"], dev)
            x = torch.where(_col(apply), time_stretch(x, rate), x)
        else:                                                     # AIR
            d = _uniform(gen, b, a["min_distance"], a["max_distance"], dev)
            x = torch.where(_col(apply), air_absorption(x, d, sr), x)
    return x

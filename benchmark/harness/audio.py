"""Seeded test audio: slowly modulated tones in noise, with no silence;
WAV files of it, and a clip fitted to a duration as the reference scores
it.

The sizes are fixed by the caller; the seed draws the content (tone,
modulation, levels), so every seed makes the same amount of work. The
waves are computed on the device in a few large calls, the noise drawn by
a ``torch.Generator`` there.
"""

from __future__ import annotations

import os
import wave
from typing import List, Sequence

import numpy as np
import torch

SR = 16000
CHUNK = 64


def tones(rng: np.random.Generator, lengths: Sequence[int],
          device: torch.device) -> List[np.ndarray]:
    """One float32 wave in [-1, 1) a length: a tone of 90-1800 Hz, its
    amplitude modulated at 0.2-3 Hz, in white noise. ``rng`` draws each
    wave's frequencies, levels and phase, and the seed of the noise."""
    lengths = [int(n) for n in lengths]
    params = rng.uniform([90.0, 0.2, 0.05, 0.005, 0.0],
                         [1800.0, 3.0, 0.4, 0.1, 2 * np.pi],
                         size=(len(lengths), 5))
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))
    out: List[np.ndarray] = []
    for c in range(0, len(lengths), CHUNK):
        ns = lengths[c:c + CHUNK]
        f0, rate, amp, noise, phase = torch.as_tensor(
            params[c:c + CHUNK].T[..., None], dtype=torch.float32,
            device=device)
        t = torch.arange(max(ns), dtype=torch.float32, device=device) / SR
        x = (amp * torch.sin(2 * np.pi * f0 * t + phase)
             * (1.5 + torch.sin(2 * np.pi * rate * t)) / 2.5
             + noise * torch.randn((len(ns), t.numel()), generator=gen,
                                   device=device))
        x = x.clamp_(-1.0, 32767 / 32768).cpu().numpy()
        out.extend(x[i, :n].copy() for i, n in enumerate(ns))
    return out


def write_wav(path: str, x: np.ndarray) -> None:
    """16 kHz mono 16-bit PCM."""
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes(pcm.tobytes())


def read_wav(path: str) -> np.ndarray:
    """A 16-bit PCM WAV as float32 samples / 32768."""
    with wave.open(path, "rb") as f:
        if f.getsampwidth() != 2 or f.getnchannels() != 1:
            raise ValueError(f"{path}: not mono 16-bit PCM")
        raw = f.readframes(f.getnframes())
    return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0


def fit_duration(clip: Sequence[float], duration: int) -> torch.Tensor:
    """A clip repeat-tiled to ``duration`` samples and cut to its first
    ``duration`` (the reference repo's ``pad`` for evaluation), in plain
    PyTorch: what the reference scores in place of the loader's batch."""
    x = torch.as_tensor(clip, dtype=torch.float32).reshape(-1)
    reps = -(-duration // x.numel())
    return x.repeat(reps)[:duration]


def write_track(root: str, rng: np.random.Generator,
                lengths: Sequence[int], device: torch.device) -> List[str]:
    """One WAV file a length, named in order; returns their paths."""
    paths = []
    for i, x in enumerate(tones(rng, lengths, device)):
        path = os.path.join(root, f"trial_{i:05d}.wav")
        write_wav(path, x)
        paths.append(path)
    return paths

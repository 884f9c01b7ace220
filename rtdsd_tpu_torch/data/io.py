"""Host-side audio decode: the port's own copy of ``rtdsd_tpu/data/io.py``.

The container is sniffed by its magic bytes (ASVspoof protocols name every
file ``.flac`` whatever it holds):

- WAV: a numpy RIFF reader (PCM 8/16/24/32 and float32/64), int samples
  scaled as torchaudio does (int16 / 32768 etc.);
- FLAC: the port's native decoder (:mod:`rtdsd_tpu_torch.native.flac`,
  built with g++ at first use), as the JAX package decodes FLAC when its
  native library is built.

Decoders return (float32 (C, T) waveform, sample rate); :func:`load_audio`
keeps channel 0.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, fmt_body, raw = 12, None, b"", None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt, fmt_body = struct.unpack("<HHIIHH", body[:16]), body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, sr, _, _, bits = fmt
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: SubFormat GUID's code
        audio_fmt = (struct.unpack("<H", fmt_body[24:26])[0]
                     if len(fmt_body) >= 26 else 1)
    if audio_fmt == 3:
        x = np.frombuffer(raw, dtype=np.float32 if bits == 32 else np.float64
                          ).astype(np.float32)
    elif audio_fmt == 1:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                 - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
            x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) \
                / 8388608.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_fmt}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), sr


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    from rtdsd_tpu_torch.native import flac

    return flac.decode(path)


def load_audio(path: str) -> Tuple[np.ndarray, int]:
    """Decode -> (float32 (T,) channel-0 waveform, sample rate)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    x, sr = read_flac(path) if magic == b"fLaC" else read_wav(path)
    return np.ascontiguousarray(x[0]), sr


def write_wav(path: str, wave: np.ndarray, sr: int) -> None:
    """PCM16 WAV writer (for tests and tools)."""
    wave = np.asarray(wave)
    if wave.ndim == 1:
        wave = wave[None]
    pcm = np.clip(wave.T * 32768.0, -32768, 32767).astype("<i2")
    c, n = wave.shape[0], pcm.size
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + 2 * n) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, c, sr,
                                      sr * c * 2, c * 2, 16))
        f.write(b"data" + struct.pack("<I", 2 * n))
        f.write(pcm.tobytes())

"""Host-side corpus and codec augmentation: the port's numpy copy of
``rtdsd_tpu/data/host_augment.py``.

The host half of the ``mul_augment`` chain, applied per item after the
duration fit on both loader paths (the math half runs on the device,
:mod:`rtdsd_tpu_torch.ops.augment`):

- :class:`BackgroundNoiseCorpus`: a random window of a random file of a
  local noise corpus (``SysConfig.noise_path``, WAV or FLAC), wrap-tiled if
  short, mixed at an SNR ~ U(3, 30) dB with p = 0.75
  (``audiomentations.AddBackgroundNoise``'s semantics);
- :class:`Mp3Compression`: an MP3 round trip at a random bitrate (96-320
  kbps, p = 0.3); it needs ``pydub`` with ffmpeg (and uses ``lameenc`` to
  encode when present), imported only when a round trip runs.

:func:`build_host_chain` builds the chain as the JAX package does: without
a codec it warns and leaves the MP3 step out, as the JAX package does on a
machine without one. The draws come from the loader's
``numpy.random.Generator``, so both packages draw the same numbers.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np

_AUDIO_EXTS = (".wav", ".flac")


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(x), dtype=np.float64)))


class BackgroundNoiseCorpus:
    """Mix random noise-corpus windows at a uniform random SNR: pick a
    file, take a random window (wrap-tiled if shorter than the signal),
    draw ``snr ~ U(min_snr_db, max_snr_db)`` and scale the noise so that
    ``20 log10(rms_signal / rms_noise) == snr``."""

    def __init__(self, sounds_path: str, sample_rate: int = 16000,
                 min_snr_db: float = 3.0, max_snr_db: float = 30.0,
                 p: float = 0.75, cache_items: int = 512):
        self.sounds_path = sounds_path
        self.sample_rate = int(sample_rate)
        self.min_snr_db = float(min_snr_db)
        self.max_snr_db = float(max_snr_db)
        self.p = float(p)
        self.files = self._scan(sounds_path)
        if not self.files:
            raise FileNotFoundError(
                f"noise corpus {sounds_path!r}: no {_AUDIO_EXTS} files found")
        self._cache: dict = {}
        self._cache_items = int(cache_items)

    @staticmethod
    def _scan(root: str) -> List[str]:
        out: List[str] = []
        for dirpath, _, names in os.walk(root):
            for n in names:
                if n.lower().endswith(_AUDIO_EXTS):
                    out.append(os.path.join(dirpath, n))
        return sorted(out)

    def _load(self, idx: int) -> np.ndarray:
        hit = self._cache.get(idx)
        if hit is not None:
            return hit
        from rtdsd_tpu_torch.data.dataset import resample
        from rtdsd_tpu_torch.data.io import load_audio

        wave, sr = load_audio(self.files[idx])
        wave = np.squeeze(wave).astype(np.float32)
        if sr and sr != self.sample_rate:
            wave = resample(wave, sr, self.sample_rate)
        if len(self._cache) < self._cache_items:
            self._cache[idx] = wave
        return wave

    def __call__(self, wave: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        if rng.random() >= self.p:
            return wave
        noise = self._load(int(rng.integers(len(self.files))))
        if len(noise) == 0:          # an empty corpus file: skip it
            return wave
        n = len(wave)
        if len(noise) < n:           # wrap-tile, then a random window
            noise = np.tile(noise, -(-n // len(noise)))
        start = int(rng.integers(0, len(noise) - n + 1))
        noise = noise[start:start + n]
        sig_rms, noise_rms = _rms(wave), _rms(noise)
        if noise_rms < 1e-9 or sig_rms < 1e-9:
            return wave
        snr_db = float(rng.uniform(self.min_snr_db, self.max_snr_db))
        gain = (sig_rms / noise_rms) * (10.0 ** (-snr_db / 20.0))
        return (wave + gain * noise).astype(np.float32)


def mp3_codec_available() -> bool:
    """True when an MP3 round trip can run: decoding goes through pydub and
    ffmpeg (or avconv), so lameenc alone is not enough."""
    try:
        from pydub import AudioSegment  # noqa: F401
        from pydub.utils import which

        return which("ffmpeg") is not None or which("avconv") is not None
    except ImportError:
        return False


class Mp3Compression:
    """MP3 encode / decode at a random bitrate (96-320 kbps, p = 0.3)."""

    BITRATES = (96, 112, 128, 144, 160, 192, 224, 256, 320)

    def __init__(self, sample_rate: int = 16000, min_bitrate: int = 96,
                 max_bitrate: int = 320, p: float = 0.3):
        if not mp3_codec_available():
            raise ImportError(
                "Mp3Compression needs the 'lameenc' or 'pydub'+ffmpeg codec "
                "stack, which is not installed in this environment. Either "
                "install one, or drop Mp3Compression from the host chain "
                "(the device chain covers every non-codec transform).")
        self.sample_rate = int(sample_rate)
        self.rates = [b for b in self.BITRATES
                      if min_bitrate <= b <= max_bitrate]
        self.p = float(p)

    def __call__(self, wave: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        if rng.random() >= self.p:
            return wave
        bitrate = int(self.rates[int(rng.integers(len(self.rates)))])
        return self._roundtrip(wave, bitrate)

    def _roundtrip(self, wave: np.ndarray, bitrate: int) -> np.ndarray:
        import importlib.util
        import io

        from pydub import AudioSegment

        pcm16 = (np.clip(wave, -1.0, 1.0) * 32767.0).astype(np.int16)
        if importlib.util.find_spec("lameenc") is not None:
            import lameenc

            enc = lameenc.Encoder()
            enc.set_bit_rate(bitrate)
            enc.set_in_sample_rate(self.sample_rate)
            enc.set_channels(1)
            enc.set_quality(7)
            mp3 = bytes(enc.encode(pcm16.tobytes())) + bytes(enc.flush())
            seg = AudioSegment.from_file(io.BytesIO(mp3), format="mp3")
        else:
            seg = AudioSegment(pcm16.tobytes(), frame_rate=self.sample_rate,
                               sample_width=2, channels=1)
            buf = io.BytesIO()
            seg.export(buf, format="mp3", bitrate=f"{bitrate}k")
            buf.seek(0)
            seg = AudioSegment.from_file(buf, format="mp3")
        out = np.array(seg.get_array_of_samples(), np.float32) / 32768.0
        # the codec's delay pads the output: back to the input's length
        n = len(wave)
        return out[:n] if len(out) >= n else np.pad(out, (0, n - len(out)))


class HostAugmentChain:
    """Ordered per-item host transforms, applied after the duration fit.
    The reference runs the MP3 round trip last; here it precedes the
    device chain (TST, GAN, AIR, TMK), as in the JAX package."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, wave: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        for t in self.transforms:
            wave = t(wave, rng)
        return wave


def build_host_chain(noise_path: str, sample_rate: int,
                     use_mp3: bool = True) -> Optional[HostAugmentChain]:
    """The ``mul_augment`` host half: background noise when ``noise_path``
    is set, and MP3 when ``use_mp3`` and a codec is installed (without one
    it warns that the chain lacks the reference's Mp3Compression).
    ``None`` when nothing applies."""
    transforms: List[Callable] = []
    if noise_path:
        transforms.append(
            BackgroundNoiseCorpus(noise_path, sample_rate=sample_rate))
    if use_mp3:
        if mp3_codec_available():
            transforms.append(Mp3Compression(sample_rate=sample_rate))
        else:
            import warnings

            warnings.warn(
                "mul_augment: no MP3 codec (pydub+ffmpeg) installed — "
                "training without the reference chain's Mp3Compression(p=0.3)")
    return HostAugmentChain(transforms) if transforms else None

"""Datasets: decode + static-duration fit. The port's own copy of
``rtdsd_tpu/data/dataset.py``: the train/dev set ``ASVspoof2019LA`` and the
eval tracks.

Every item is repeat-tiled and cut to exactly ``duration`` samples (whole
copies, then the residue prefix, then the first or a random window), as the
reference's ``adjustDuration`` does. A dataset's ``host_augment``
(:mod:`rtdsd_tpu_torch.data.host_augment`) runs after that fit, on both
loader paths.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from rtdsd_tpu_torch.config import ExpConfig, SysConfig
from rtdsd_tpu_torch.data import protocols
from rtdsd_tpu_torch.data.io import load_audio
from rtdsd_tpu_torch.data.protocols import Trial


def resample(wave: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(sr), int(target_sr))
    return resample_poly(wave, target_sr // g, sr // g).astype(np.float32)


def _tile_to(x: np.ndarray, duration: int) -> np.ndarray:
    if len(x) >= duration:
        return x
    parts = [x] * (duration // len(x))
    if duration % len(x):
        parts.append(x[:duration % len(x)])
    return np.concatenate(parts)


def adjust_duration(x: np.ndarray, duration: int) -> np.ndarray:
    """First-N window after repeat-tiling."""
    return _tile_to(np.squeeze(x), duration)[:duration]


def adjust_duration_random_start(x: np.ndarray, duration: int,
                                 rng: np.random.Generator) -> np.ndarray:
    """Random window after repeat-tiling."""
    x = _tile_to(np.squeeze(x), duration)
    start = int(rng.integers(0, len(x) - duration + 1))
    return x[start: start + duration]


class AudioDataset:
    """Trial list + decode + duration fit; ``get(i, rng)`` -> (utt_id, wave,
    label)."""

    def __init__(self, trials: Sequence[Trial], duration: int,
                 is_random_start: bool = False, sample_rate: int = 16000,
                 host_augment=None):
        self.trials = list(trials)
        self.duration = int(duration)
        self.is_random_start = is_random_start
        self.sample_rate = sample_rate
        self.host_augment = host_augment

    def __len__(self) -> int:
        return len(self.trials)

    def get(self, index: int, rng: Optional[np.random.Generator] = None
            ) -> Tuple[str, np.ndarray, int]:
        t = self.trials[index]
        wave, sr = load_audio(t.path)
        if sr and sr != self.sample_rate:
            wave = resample(wave, sr, self.sample_rate)
        if self.is_random_start and rng is not None:
            wave = adjust_duration_random_start(wave, self.duration, rng)
        else:
            wave = adjust_duration(wave, self.duration)
        if self.host_augment is not None and rng is not None:
            wave = self.host_augment(wave, rng)
        return t.utt_id, wave.astype(np.float32), t.label


class ASVspoof2019LA(AudioDataset):
    """The ASVspoof 2019 LA train set (``is_train``, random-start crops when
    ``is_random_start``) or dev set (first-N crops), at the train duration.
    The train set carries the host half of the ``mul_augment`` chain when
    that is configured and no RawBoost code is (the reference's if/elif;
    ``allow_data_augmentation`` does not gate it), built even without a
    noise corpus so that a missing MP3 codec is reported."""

    def __init__(self, sys_config: SysConfig, exp_config: ExpConfig,
                 is_train: bool = True):
        if is_train:
            label_path = sys_config.path_label_asv_spoof_2019_la_train
            audio_dir = sys_config.path_asv_spoof_2019_la_train
        else:
            label_path = sys_config.path_label_asv_spoof_2019_la_dev
            audio_dir = sys_config.path_asv_spoof_2019_la_dev
        trials, self.num_of_spoof, self.num_of_bonafide = \
            protocols.parse_asvspoof2019_train(
                label_path, audio_dir,
                include_non_speech=exp_config.include_non_speech,
                include_residual=exp_config.include_residual)
        da = list(exp_config.data_augmentation or [])
        host_chain = None
        if is_train and "mul_augment" in da:
            from rtdsd_tpu_torch.data.host_augment import build_host_chain
            from rtdsd_tpu_torch.engine.steps import pick_rawboost_algo

            if pick_rawboost_algo(da) is None:
                host_chain = build_host_chain(sys_config.noise_path,
                                              exp_config.sample_rate)
        super().__init__(trials, exp_config.train_duration_samples,
                         is_random_start=is_train and exp_config.is_random_start,
                         sample_rate=exp_config.sample_rate,
                         host_augment=host_chain)


class ASVspoof2019LA_eval(AudioDataset):
    def __init__(self, sys_config: SysConfig, exp_config: ExpConfig):
        trials = protocols.parse_asvspoof2019_eval(
            sys_config.path_label_asv_spoof_2019_la_eval,
            sys_config.path_asv_spoof_2019_la_eval,
            include_non_speech=exp_config.include_non_speech,
            include_residual=exp_config.include_residual)
        # The reference's LA19 eval set always crops at a random start;
        # `la19_eval_random_start: false` gives run-to-run stable first-N crops.
        rnd = exp_config.la19_eval_random_start
        super().__init__(trials, exp_config.test_duration_samples,
                         is_random_start=True if rnd is None else bool(rnd),
                         sample_rate=exp_config.sample_rate)


class ASVspoof2021LA_eval(AudioDataset):
    def __init__(self, sys_config: SysConfig, exp_config: ExpConfig):
        trials = protocols.parse_asvspoof2021_la(
            sys_config.path_label_asv_spoof_2021_la_eval,
            sys_config.path_asv_spoof_2021_la_eval)
        super().__init__(trials, exp_config.test_duration_samples,
                         is_random_start=False,
                         sample_rate=exp_config.sample_rate)


class ASVspoof2021DF_eval(AudioDataset):
    def __init__(self, sys_config: SysConfig, exp_config: ExpConfig):
        trials = protocols.parse_asvspoof2021_df(
            sys_config.path_label_asv_spoof_2021_df_eval,
            sys_config.path_asv_spoof_2021_df_eval,
            spec=bool(sys_config.path_label_asv_spoof_2021_la_eval_spec))
        super().__init__(trials, exp_config.test_duration_samples,
                         is_random_start=exp_config.is_random_start,
                         sample_rate=exp_config.sample_rate)


class InTheWild(AudioDataset):
    def __init__(self, sys_config: SysConfig, exp_config: ExpConfig):
        label = sys_config.path_label_in_the_wild or sys_config.path_label_itw_eval
        audio = sys_config.path_in_the_wild or sys_config.path_itw_eval
        super().__init__(protocols.parse_in_the_wild(label, audio),
                         exp_config.test_duration_samples,
                         is_random_start=exp_config.is_random_start,
                         sample_rate=exp_config.sample_rate)


class ASVSpoof5(AudioDataset):
    def __init__(self, sys_config: SysConfig, exp_config: ExpConfig,
                 subset: Optional[str] = None):
        trials = protocols.parse_asvspoof5(
            sys_config.path_label_asvspoof5, sys_config.path_asvspoof5, subset)
        super().__init__(trials, exp_config.test_duration_samples,
                         is_random_start=exp_config.is_random_start,
                         sample_rate=exp_config.sample_rate)


class FakeOrReal(AudioDataset):
    def __init__(self, sys_config: SysConfig, exp_config: ExpConfig):
        trials = protocols.parse_fake_or_real(sys_config.path_label_itw_eval,
                                              sys_config.path_itw_eval)
        super().__init__(trials, exp_config.test_duration_samples,
                         is_random_start=exp_config.is_random_start,
                         sample_rate=exp_config.sample_rate)

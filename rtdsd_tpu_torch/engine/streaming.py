"""Streaming / long-audio scoring: the port of
``rtdsd_tpu/engine/streaming.py``.

Long audio is scored in fixed windows of ``duration`` samples that slide by
``hop``, batched onto the device with a fixed batch shape, and the
per-window CM scores (bonafide logits) are aggregated into one utterance
score. :class:`StreamingScorer` runs the whole model on every window;
:class:`IncrementalStreamingScorer` runs the conv front-end once over the
whole wave and scores each window from a slice of its features.

Both scorers dispatch every batch without waiting and read results back
three batches late (:func:`readback_late`), so the host does not stall the
device between batches.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Literal, Optional, Union

import numpy as np
import torch
from torch import nn

from rtdsd_tpu_torch.device import resolve_device
from rtdsd_tpu_torch.models.wav2vec2 import Wav2Vec2Config, conv_segment_geometry

Aggregate = Literal["mean", "min", "max", "median"]


def frame_starts(t: int, duration: int, hop: int) -> list:
    """Window start samples for a length-t wave: hop-strided, plus a final
    tail window at ``t - duration`` when the stride doesn't reach the end.
    A short wave gets the single window [0]."""
    if t <= duration:
        return [0]
    starts = list(range(0, t - duration + 1, hop))
    if starts[-1] + duration < t:  # cover the tail
        starts.append(t - duration)
    return starts


def _tile(wave: np.ndarray, duration: int) -> np.ndarray:
    """A short wave repeat-tiled and cut to ``duration`` samples, as the
    dataset's duration fit does."""
    reps = -(-duration // max(wave.shape[-1], 1))
    return np.tile(wave, reps)[:duration]


def frame_windows(wave: np.ndarray, duration: int, hop: int) -> np.ndarray:
    """Slice a (T,) wave into (N, duration) windows at :func:`frame_starts`;
    a short input is repeat-tiled into exactly one window."""
    wave = np.asarray(wave, np.float32).squeeze()
    t = wave.shape[-1]
    if t <= duration:
        return _tile(wave, duration)[None]
    return np.stack([wave[s:s + duration]
                     for s in frame_starts(t, duration, hop)])


def readback_late(entries: Iterable, depth: int = 3) -> Iterator:
    """Yield dispatched-work entries ``depth`` items late, so that reading
    one result back overlaps with the device running the next ones (the
    port's copy of ``rtdsd_tpu/data/loader.py::readback_late``)."""
    pending = collections.deque()
    for e in entries:
        pending.append(e)
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()


def _batches(rows: torch.Tensor, batch_size: int):
    """(rows[s:s + batch_size] padded to ``batch_size`` by repeating its
    last row, valid count) for every batch, so each dispatch has one
    shape."""
    for s in range(0, rows.shape[0], batch_size):
        chunk = rows[s:s + batch_size]
        valid = chunk.shape[0]
        if valid < batch_size:
            chunk = torch.cat([chunk, chunk[-1:].expand(
                batch_size - valid, *chunk.shape[1:])])
        yield chunk, valid


def _read_scores(dispatched) -> np.ndarray:
    """Float32 host scores of (device scores, valid) pairs, read late."""
    return np.concatenate([out[:v].float().cpu().numpy()
                           for out, v in readback_late(dispatched)])


class StreamingScorer:
    """Scores arbitrarily long audio with a fixed-window model.

    ``score_step``: waves (B, duration) on ``device`` -> (B,) CM scores
    (bonafide logits), e.g. ``engine/steps.py::make_score_step(model)``.
    ``batch_size`` fixes the batch shape; the last batch is padded up to it
    by repeating its last window. ``device`` is where the model lives
    (``None``: CUDA, which raises without a GPU).
    """

    def __init__(self, score_step: Callable[[torch.Tensor], torch.Tensor],
                 duration: int, hop: Optional[int] = None,
                 batch_size: int = 8, aggregate: Aggregate = "mean",
                 device: Optional[Union[str, torch.device]] = None):
        self.score_step = score_step
        self.duration = duration
        self.hop = hop or duration // 2
        self.batch_size = batch_size
        self.aggregate = aggregate
        self.device = resolve_device(device)

    def window_starts(self, t: int) -> list:
        """Start samples of the windows :meth:`window_scores` scores on a
        length-t wave, in order."""
        return frame_starts(t, self.duration, self.hop)

    def window_scores(self, wave: np.ndarray) -> np.ndarray:
        windows = torch.from_numpy(frame_windows(wave, self.duration,
                                                 self.hop)).to(self.device)
        return _read_scores((self.score_step(chunk), valid)
                            for chunk, valid in _batches(windows,
                                                         self.batch_size))

    def aggregate_scores(self, ws: np.ndarray) -> float:
        """Window scores -> utterance CM score per the configured policy."""
        if self.aggregate == "mean":
            return float(ws.mean())
        if self.aggregate == "min":
            return float(ws.min())
        if self.aggregate == "max":
            return float(ws.max())
        if self.aggregate == "median":
            return float(np.median(ws))
        raise ValueError(f"unknown aggregate {self.aggregate!r}")

    def score(self, wave: np.ndarray) -> float:
        """Utterance-level CM score from aggregated window scores."""
        return self.aggregate_scores(self.window_scores(wave))


def receptive_field(conv_layers) -> int:
    """Conv-stack receptive field in samples (XLSR: 400)."""
    return Wav2Vec2Config(conv_layers=tuple(conv_layers)).conv_receptive_field


class IncrementalStreamingScorer:
    """Streaming scorer that computes the conv front-end once per audio.

    The conv stack is stride-aligned (total stride 320 for XLSR, VALID
    padding) and the layer_norm extractor normalises each frame on its own,
    so the conv features of a window that starts on the stride grid are a
    slice of the whole wave's conv features. This scorer:

    1. runs the model's own ``ConvFeatureExtractor`` over the wave in
       ``seg_frames``-frame segments (segment hop ``seg_frames * stride``,
       so frames line up exactly), all segments in one batched call whose
       features stay on the device;
    2. gathers each window's frames on the device (window starts snapped
       down to the frame grid, duplicates dropped) and scores the batches
       through ``model(None, conv_feats=windows)``.

    At hop = window / 2 it does half the conv work of
    :class:`StreamingScorer`, and its scores equal that scorer's on windows
    that start on the grid, up to summation order.

    ``model`` is an XLSR model of ``models/zoo.py`` in eval mode, on its
    device; ``cfg`` is its ``Wav2Vec2Config``, which must use the
    layer_norm extractor (group_norm normalises across the whole window).
    """

    def __init__(self, model: nn.Module, cfg: Wav2Vec2Config,
                 duration: int, hop: Optional[int] = None,
                 batch_size: int = 8, aggregate: Aggregate = "mean",
                 seg_frames: int = 256):
        if cfg.extractor_mode != "layer_norm":
            raise ValueError(
                "incremental streaming requires the layer_norm extractor "
                "(group_norm normalizes across the full window)")
        self.model = model
        self.cfg = cfg
        self.duration = duration
        self.hop = hop or duration // 2
        self.batch_size = batch_size
        self.aggregate = aggregate
        self.stride = cfg.total_stride
        if self.hop < self.stride:
            # starts snap to the conv frame grid; a sub-frame hop would
            # silently dedup windows away, so the floor is explicit
            raise ValueError(
                f"hop {self.hop} is below the conv frame stride "
                f"{self.stride} ({self.stride / 16000 * 1000:.0f} ms at "
                f"16 kHz) — the incremental scorer cannot produce "
                f"sub-frame window offsets; use the naive scorer")
        self.win_frames = cfg.num_frames(duration)
        self.seg_frames = seg_frames
        self.seg_samples, _, _ = conv_segment_geometry(cfg, seg_frames, 1)
        self.extractor = model.ssl_model.model.feature_extractor
        self.device = next(model.parameters()).device

    # ------------------------------------------------------------ internals

    def conv_features(self, wave: np.ndarray) -> torch.Tensor:
        """(T,) wave -> (>= num_frames(T), C) conv features on the device.
        The segments are strided views of the wave, uploaded once and
        zero-padded to whole segments; rows beyond ``num_frames(T)`` are
        padding that no window gathers."""
        t = wave.shape[-1]
        n_segs = self._bucket(self.cfg.num_frames(t))
        _, seg_hop, pad_to = conv_segment_geometry(self.cfg, self.seg_frames,
                                                   n_segs)
        if t < pad_to:
            wave = np.pad(wave, (0, pad_to - t))
        segs = torch.from_numpy(wave).to(self.device).unfold(
            0, self.seg_samples, seg_hop)[:n_segs]
        with torch.inference_mode():
            feats = self.extractor(segs)
        return feats.reshape(-1, feats.shape[-1])

    def _bucket(self, frames: int) -> int:
        # the segment count rounded up to a multiple of 4, so audio of
        # similar lengths gives the same shapes
        n_segs = -(-frames // self.seg_frames)
        return -(-n_segs // 4) * 4

    def bucket_key(self, t: int) -> int:
        """Segment-count bucket of a length-t wave; a caller warms each
        bucket once before timing (cli/stream.py)."""
        return self._bucket(self.cfg.num_frames(max(t, self.duration)))

    # ------------------------------------------------------------------ api

    def window_starts(self, t: int) -> list:
        """Start samples of the windows :meth:`window_scores` scores on a
        length-t wave: :func:`frame_starts` snapped down to the conv frame
        grid, duplicates dropped."""
        starts = [s - (s % self.stride)  # snap DOWN to the conv frame grid
                  for s in frame_starts(t, self.duration, self.hop)]
        return sorted(dict.fromkeys(starts))  # dedup

    def window_scores(self, wave: np.ndarray) -> np.ndarray:
        wave = np.asarray(wave, np.float32).squeeze()
        t = wave.shape[-1]
        if t <= self.duration:  # short input: tile like the dataset fit
            wave = _tile(wave, self.duration)
            t = self.duration
        feats_flat = self.conv_features(wave)
        starts = np.asarray(self.window_starts(t), np.int64) // self.stride
        idx_all = torch.from_numpy(
            starts[:, None] + np.arange(self.win_frames, dtype=np.int64)
        ).to(self.device)

        with torch.inference_mode():
            # feats_flat[idx]: the (B, win_frames, C) windows, one gather
            return _read_scores(
                (self.model(None, conv_feats=feats_flat[idx])[:, 1], valid)
                for idx, valid in _batches(idx_all, self.batch_size))

    aggregate_scores = StreamingScorer.aggregate_scores

    def score(self, wave: np.ndarray) -> float:
        return self.aggregate_scores(self.window_scores(wave))

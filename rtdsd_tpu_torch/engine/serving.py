"""Multi-stream real-time serving engine: the port of
``rtdsd_tpu/engine/serving.py``.

N concurrent 16 kHz streams, each pushing samples as they arrive, are
scored on one GPU with a fixed set of dispatch shapes:

- per-stream conv features live in a device ring ``(max_streams + 1,
  ring_frames, C)`` in the model's dtype. The XLSR conv stack is
  stride-aligned (VALID padding, per-frame LayerNorm), so the features of
  any window on the frame grid are a slice of the stream's feature
  history (``IncrementalStreamingScorer`` rests on the same fact);
- ``extend``: one batched call of the model's own ``ConvFeatureExtractor``
  computes the features of up to ``extend_batch`` new segments across all
  streams and writes them into the rings at ``frame % ring_frames``;
- ``score``: one batched dispatch gathers up to ``score_batch`` due
  windows from the rings and scores them through the model's
  ``conv_feats=`` entry.

Each stream costs one segment row in ``extend`` and one window row in
``score`` per hop, and the number of dispatches per poll does not grow
with the number of streams. Slot ``max_streams`` is a scratch slot: batch
padding rows write and read it, so the dispatch shapes never change with
occupancy. The rings are tensors written in place by index assignment
(JAX's donated buffers).

Cascade escalation (``escalate=``): a cheap screener is the primary model
and a flagship re-scores the windows whose screener score falls in a band.
The flagship reads a raw-sample ring (the feature ring's geometry in
samples) through its ordinary wave entry, so the pair may be any two
models; an escalated score is the flagship's direct score of the window.
Escalations run inside the same poll, before a later extend can overwrite
the ring rows they read.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtdsd_tpu_torch.device import resolve_device
from rtdsd_tpu_torch.models.wav2vec2 import (Wav2Vec2Config,
                                             conv_segment_geometry,
                                             use_fast_gelu)

__all__ = ["MultiStreamScorer", "WindowScore", "mulaw_encode", "mulaw_decode",
           "dispatch_detail_keys", "probe_hbm_bytes", "hbm_limit_file_path",
           "process_memory_limit", "eager_row_bytes"]

_MU = 255.0  # mu-law companding constant (G.711-style continuous form)


def mulaw_encode(x: np.ndarray) -> np.ndarray:
    """Float wave in [-1, 1] -> companded int8 in [-127, 127] (host side).

    Continuous mu-law (y = sign(x) log1p(mu |x|) / log1p(mu)), quantized
    after companding, so small samples keep about 1.7e-4 resolution while
    full scale costs about 4e-2."""
    x = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    return np.clip(np.rint(y * 127.0), -127, 127).astype(np.int8)


def mulaw_decode(q: torch.Tensor) -> torch.Tensor:
    """Companded int8 -> float32 wave (on the device). Clamps to the
    encoder's [-127, 127] first: a raw int8 buffer from a client may hold
    -128, which would decode outside [-1, 1]."""
    y = q.float().clamp(-127.0, 127.0) * (1.0 / 127.0)
    return torch.sign(y) * torch.expm1(y.abs() * float(np.log1p(_MU))) \
        * (1.0 / _MU)


def hbm_limit_file_path() -> str:
    """Location of the calibrated device-memory sidecar (see
    :func:`probe_hbm_bytes`): ``$RTDSD_HBM_LIMIT_FILE`` or
    ``~/.cache/rtdsd_tpu/hbm_limit.json``."""
    return os.environ.get("RTDSD_HBM_LIMIT_FILE") or os.path.join(
        os.path.expanduser("~"), ".cache", "rtdsd_tpu", "hbm_limit.json")


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def process_memory_limit(free: int, reserved: int, total: int) -> int:
    """Device memory this process can hold, in bytes: the free memory
    ``torch.cuda.mem_get_info`` reports plus what PyTorch's caching
    allocator already holds (the model among it), never more than the
    card's total. Other processes'
    memory and the CUDA context are outside it."""
    return min(int(total), int(free) + int(reserved))


def _device_hbm_bytes(device: torch.device) -> Optional[int]:
    """The memory limit the guard holds the estimate to, in bytes, from (in
    order): on CUDA, :func:`process_memory_limit` of
    ``torch.cuda.mem_get_info`` and ``torch.cuda.memory_reserved``;
    ``$RTDSD_HBM_GB`` (GiB); the sidecar :func:`probe_hbm_bytes` records,
    when it names this device's kind; else None, and the guard is off (the
    CPU)."""
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        return process_memory_limit(free, torch.cuda.memory_reserved(device),
                                    total)
    env_gb = os.environ.get("RTDSD_HBM_GB")
    if env_gb:
        try:
            return int(float(env_gb) * 2 ** 30)
        except ValueError:
            pass
    try:
        with open(hbm_limit_file_path()) as fh:
            rec = json.load(fh)
    except (OSError, ValueError):
        return None
    if rec.get("device_kind") in (None, _device_kind(device)):
        return int(rec.get("bytes", 0)) or None
    return None


def probe_hbm_bytes(max_gb: float = 64.0, block_gb: float = 1.0,
                    alloc=None, record: bool = False,
                    device=None) -> int:
    """Usable device memory by bounded trial allocation: holds an
    increasing count of ``block_gb`` buffers until one fails (or
    ``max_gb`` is reached); usable = blocks held x block size. All the
    trials that succeed come before the one that fails, and every block has
    one size. ``alloc()`` (one block, no arguments) is injectable for tests;
    the default allocates a uint8 buffer on ``device`` (default CUDA).
    ``record=True`` writes the result to :func:`hbm_limit_file_path`,
    keyed by the device's kind."""
    gib = 2 ** 30
    block = int(block_gb * gib)
    if alloc is None or record:
        dev = resolve_device(device)
    if alloc is None:
        def alloc():
            return torch.empty((block,), dtype=torch.uint8, device=dev)

    held = []
    try:
        while len(held) * block < int(max_gb * gib):
            held.append(alloc())
    except RuntimeError:         # torch.cuda.OutOfMemoryError is one
        pass
    lo = len(held) * block
    del held
    if lo == 0:
        raise RuntimeError(
            f"HBM probe: even a {block_gb:g} GiB allocation failed — "
            "device busy or broken, not calibrating")
    if record:
        path = hbm_limit_file_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        kind = _device_kind(dev)
        with open(path, "w") as fh:
            json.dump({"bytes": lo, "device_kind": kind}, fh)
        print(f"[hbm probe] recorded {lo / gib:.2f} GiB usable "
              f"({kind}) -> {path}", file=sys.stderr)
    return lo


def _shape_ladder(full: int, rungs: int, prefix: str, n: int = 1):
    """``rungs`` successive halvings of a dispatch shape, rounded down to a
    multiple of ``n``; rungs that reach zero rows are dropped. Returns
    [(rows, counter_name), ...] in descending rows: a dispatch takes the
    smallest rung its live rows fit. Names are positional (``half``,
    ``quarter``, ``eighth``, ``1_16``, ...): read the rows from
    ``MultiStreamScorer.rung_rows``."""
    names = ("half", "quarter", "eighth")
    out = []
    b = full
    for i in range(max(0, int(rungs))):
        b = (b // 2 // n) * n
        if b <= 0:
            break
        suffix = names[i] if i < len(names) else f"1_{2 ** (i + 1)}"
        out.append((b, f"{prefix}_{suffix}"))
    return out


def dispatch_detail_keys(counts) -> list:
    """Display order of dispatch / cost counter keys, built from the live
    keys so that no rung is dropped: the extend family, then score, then
    escalate; each base shape before its rungs, ``extend_const`` last in
    its family; other keys at the end."""
    fams = ("extend", "score", "escalate")
    order = list(counts)
    out = []
    for f in fams:
        ks = [k for k in order if k == f or k.startswith(f + "_")]
        ks.sort(key=lambda k: (k != f, k == "extend_const", order.index(k)))
        out.extend(ks)
    out.extend(k for k in order
               if not any(k == f or k.startswith(f + "_") for f in fams))
    return out


class WindowScore(NamedTuple):
    stream_id: object
    start_sample: int  # window start in absolute stream samples
    score: float  # bonafide CM score (logit), higher = more bonafide
    escalated: bool = False  # scored by the escalation model (cascade)
    gated: bool = False  # energy-gated silence: score is gate_score,
    #                      no model ran (see gate_rms_dbfs)


class _StreamState:
    __slots__ = ("stream_id", "buf", "chunks", "chunks_len", "next_seg",
                 "next_win", "final_win", "tail_frame", "head", "head_len",
                 "head_cap", "engsq")

    def __init__(self, stream_id, dtype=np.float32, head_cap=0):
        self.stream_id = stream_id
        self.buf = np.zeros((0,), dtype)  # samples from next_seg's start
        self.chunks = []  # pushed-but-uncoalesced chunks (O(1) push)
        self.chunks_len = 0
        self.next_seg = 0  # next conv segment index to extract
        self.next_win = 0  # next window index to score
        self.final_win = None  # set by close(flush=True): total window count
        self.tail_frame = None  # start frame of a tail-aligned final window
        # the first `head_cap` samples, kept so that a stream shorter than
        # one window can be repeat-tiled at flush like the offline scorers
        self.head = []
        self.head_len = 0
        self.head_cap = head_cap
        # per-segment mean-square energy (seg_idx -> float), kept only
        # while the energy gate may still need it (gate_rms_dbfs)
        self.engsq = {}

    def coalesce(self):
        if self.chunks:
            parts = ([self.buf] if len(self.buf) else []) + self.chunks
            self.buf = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self.chunks = []
            self.chunks_len = 0

    @property
    def pending_samples(self):
        return len(self.buf) + self.chunks_len


# f32 temporaries per activation element that the eager forward holds at its
# peak beyond the input and output JAX's formula counts (XLA fuses them
# away). The rational-erf GELU of (b)f16 models (ops/fastgelu.py) holds the
# scaled argument, z, u, p, q and z * p beside its f32 input and result;
# a float32 front-end holds the contiguous copy F.layer_norm makes of its
# transposed conv output; a float32 transformer layer holds none.
_GELU_TEMPS = 6
_LN_COPY_TEMPS = 1


def eager_row_bytes(cfg: Wav2Vec2Config, dtype: torch.dtype,
                    samples: int = 0, frames: int = 0) -> int:
    """Bytes of the eager forward's f32 temporaries (beyond JAX's formula)
    at the peak of one batch row: the conv front-end over ``samples``
    samples (its largest layer output) and the transformer's feed-forward
    GELU over ``frames`` frames; the larger of the two, since the row
    passes through them one after the other."""
    fast = use_fast_gelu(cfg, dtype)
    t, largest = samples, 0
    for (c, k, s) in cfg.conv_layers if samples else ():
        t = (t - k) // s + 1
        largest = max(largest, t * c)
    conv = largest * 4 * (_GELU_TEMPS if fast else _LN_COPY_TEMPS)
    ffn = frames * cfg.encoder_ffn_dim * 4 * _GELU_TEMPS if fast else 0
    return max(conv, ffn)


def _module_bytes(module: nn.Module) -> int:
    """Bytes of a module's parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in itertools.chain(module.parameters(), module.buffers()))


_TRANSPORTS = {"float32": (np.float32, torch.float32),
               "int16": (np.int16, torch.int16),
               "mulaw8": (np.int8, torch.int8)}


class MultiStreamScorer:
    """Scores many concurrent live audio streams on one device.

    Usage::

        eng = MultiStreamScorer(model, model.w2v_cfg, duration=16000,
                                hop=8000, max_streams=64)
        h = eng.open_stream("caller-17")
        eng.push(h, samples)          # any chunk size, any cadence
        for ws in eng.poll():         # one extend + one score dispatch
            ...                       # WindowScore(stream_id, start, score)
        eng.close_stream(h)

    ``model`` is an eval-mode model of ``models/zoo.py`` on its device
    (the engine runs there) and ``cfg`` its ``Wav2Vec2Config``, with the
    layer_norm extractor (group_norm couples the frames of a whole window).
    ``duration`` / ``hop`` are in samples, multiples of the conv stride
    (320 for XLSR). ``escalate`` is a second model, the cascade's
    flagship, on the same device.

    Latency: features are extracted in conv segments that overlap the next
    one by the receptive-field tail (``seg_samples - seg_hop``, 80 samples
    = 5 ms for XLSR), so a window is scored once the segment holding its
    last conv frame is complete: up to that tail after the window's end.
    ``close_stream(flush=True)`` pads and scores whatever remains.
    """

    def __init__(self, model: nn.Module, cfg: Wav2Vec2Config, *,
                 duration: int, hop: Optional[int] = None,
                 max_streams: int = 8,
                 seg_frames: Optional[int] = None,
                 ring_frames: Optional[int] = None,
                 extend_batch: Optional[int] = None,
                 score_batch: Optional[int] = None,
                 escalate: Optional[nn.Module] = None,
                 escalate_band: float = 2.0,
                 escalate_center: float = 0.0,
                 esc_batch: Optional[int] = None,
                 esc_rate: Optional[float] = None,
                 esc_gather: str = "slice",
                 extend_fastpath: bool = True,
                 extend_rungs: int = 2,
                 score_rungs: int = 0,
                 esc_rungs: int = 0,
                 auto_provision: bool = True,
                 provision_after: int = 48,
                 transport_dtype: str = "float32",
                 hbm_limit: Optional[int] = None,
                 auto_batch: bool = False,
                 gate_rms_dbfs: Optional[float] = None,
                 gate_score: float = 0.0):
        if cfg.extractor_mode != "layer_norm":
            raise ValueError(
                "multi-stream serving requires the layer_norm extractor "
                "(group_norm normalizes across the full window)")
        stride = cfg.total_stride
        hop = duration // 2 if hop is None else hop
        if duration % stride or hop % stride:
            raise ValueError(
                f"duration ({duration}) and hop ({hop}) must be multiples "
                f"of the conv stride ({stride}) so windows land on the "
                f"conv frame grid")
        if hop <= 0 or duration <= 0:
            raise ValueError("duration and hop must be positive")
        if hop > duration:
            # ring sizing, backpressure and the uniqueness of one extend's
            # ring writes all assume windows that tile or overlap
            raise ValueError(
                f"hop ({hop}) must not exceed the window duration "
                f"({duration}); subsample streams host-side instead")
        self.model = model
        self.device = next(model.parameters()).device
        self.dtype = model.ssl_model.model.dtype
        self.duration = duration
        self.hop = hop
        self.stride = stride
        self.win_frames = cfg.num_frames(duration)
        self.hop_frames = hop // stride
        self.seg_frames = seg_frames or self.hop_frames
        self.seg_samples, self.seg_hop, _ = conv_segment_geometry(
            cfg, self.seg_frames, 1)
        self._cfg = cfg
        self._escalate = escalate is not None
        # The sample ring holds frame rows of `stride` samples; a segment
        # writes its seg_frames full rows plus the rf - stride sample tail
        # that a window due with no spare frame still needs for its last
        # conv frame, so an escalating engine keeps tail_rows of margin.
        self._tail_len = self.seg_samples - self.seg_frames * stride
        self._tail_rows = -(-self._tail_len // stride) if self._tail_len \
            else 0
        self._ring_margin = self._tail_rows if self._escalate else 0
        # a window plus two segments of slack before backpressure defers
        # a stream's extends
        min_ring = self.win_frames + 2 * self.seg_frames + self._ring_margin
        self.ring_frames = ring_frames or -(-min_ring // 8) * 8
        if self.ring_frames < min_ring:
            raise ValueError(
                f"ring_frames {self.ring_frames} < minimum {min_ring} "
                f"(win_frames + 2*seg_frames + escalation margin)")
        self.max_streams = max_streams
        # a capped score_batch also caps the extend batch provisionally
        # (the extend's conv activations are the largest memory term at
        # large S); the memory check below uncaps it when the full width
        # fits
        self.extend_batch = extend_batch or score_batch or max_streams
        self.score_batch = score_batch or max_streams
        # int16 halves the host-to-device sample upload and is lossless for
        # 16-bit audio; mulaw8 halves it again (lossy, ~38 dB speech SNR).
        # Both decode on the device.
        if transport_dtype not in _TRANSPORTS:
            raise ValueError(f"transport_dtype must be float32, int16 or "
                             f"mulaw8, got {transport_dtype!r}")
        self._mulaw = transport_dtype == "mulaw8"
        self._tdtype, self._ttorch = _TRANSPORTS[transport_dtype]

        # energy gate: a window whose RMS (dBFS re full scale 1.0) is below
        # the threshold emits gate_score with no dispatch. Per-segment mean
        # squares are taken on the host at consume time; the extend still
        # runs for every segment, so the rings stay exact for loud windows
        # next to silent ones.
        if gate_rms_dbfs is not None and gate_rms_dbfs > 0:
            raise ValueError(
                f"gate_rms_dbfs is dBFS relative to full scale 1.0 and "
                f"must be <= 0 (typical speech gate: -45 .. -60), got "
                f"{gate_rms_dbfs}")
        self.gate_msq = (None if gate_rms_dbfs is None
                         else 10.0 ** (gate_rms_dbfs / 10.0))
        self.gate_score = float(gate_score)
        self.gated_windows = 0
        self.zero_segments = 0  # segments served by the zero fastpath
        self.model_swaps = 0
        self._channels = cfg.conv_layers[-1][0]

        # escalation chunk rows: an explicit esc_batch wins; else
        # 1.25 x the calibrated in-band rate x score_batch (padding rows
        # cost real time); else score_batch / 4
        if esc_rate is not None and not 0.0 <= esc_rate <= 1.0:
            raise ValueError(
                f"esc_rate is the expected in-band (escalated) fraction "
                f"of scored windows and must be in [0, 1], got {esc_rate}")
        self._esc_rate = esc_rate
        frac = 1.25 * esc_rate if esc_rate is not None else 0.25

        def esc_size(sb: int) -> int:
            if esc_batch is not None:
                return esc_batch
            # never wider than the score batch that feeds it
            return min(sb, max(1, int(np.ceil(frac * sb))))

        self.esc_batch = esc_size(self.score_batch)

        # pre-flight memory estimate, before any device allocation: a
        # configuration that cannot fit raises here with numbers
        self._estimate(model, cfg, escalate)
        limit = hbm_limit if hbm_limit is not None \
            else _device_hbm_bytes(self.device)
        self.hbm_limit = limit  # what the guard held the estimate to
        auto_shrank = False
        if limit and auto_batch and self.hbm_estimate > limit:
            # halve the dispatch batches until the estimate fits; each
            # tick then drains the due backlog in several dispatches
            auto_req = self.hbm_estimate
            while self.hbm_estimate > limit and self.score_batch > 1:
                sb = max(1, self.score_batch // 2)
                self.score_batch = sb
                self.extend_batch = min(self.extend_batch, sb)
                # an explicit esc_batch is capped to the shrunken rate
                # size too: keeping it full width would defeat the fit
                self.esc_batch = min(self.esc_batch,
                                     max(1, int(np.ceil(frac * sb))))
                self._estimate(model, cfg, escalate)
            auto_shrank = self.hbm_estimate <= limit
        # a capped extend staggers window availability into half-full
        # score dispatches; where extend_batch was not given and the full
        # width fits, keep extend_batch = max_streams
        if extend_batch is None and self.extend_batch < max_streams:
            if limit:
                capped = self.extend_batch
                self.extend_batch = max_streams
                self._estimate(model, cfg, escalate)
                if self.hbm_estimate > limit:
                    self.extend_batch = capped
                    self._estimate(model, cfg, escalate)
            else:
                print(f"[serving] score_batch cap also capped extend_batch "
                      f"at {self.extend_batch} because the device reports no "
                      f"HBM limit; if {max_streams} fits your device, pass "
                      f"extend_batch={max_streams} (or hbm_limit=) — a "
                      f"capped extend staggers windows into half-full score "
                      f"dispatches (~2x tick cost on gated workloads)",
                      file=sys.stderr)
        if auto_shrank:
            print(f"[serving] auto_batch: ~{auto_req / 2**30:.2f} GiB "
                  f"estimate exceeded the {limit / 2**30:.2f} GiB "
                  f"limit; shrank batches to extend={self.extend_batch}"
                  f" score={self.score_batch} esc={self.esc_batch} "
                  f"(~{self.hbm_estimate / 2**30:.2f} GiB) — ticks "
                  f"drain the backlog with multiple dispatches",
                  file=sys.stderr)
        if limit and self.hbm_estimate > limit:
            err = ValueError(
                f"serving configuration needs ~{self.hbm_estimate / 2**30:.2f}"
                f" GiB HBM but the device reports {limit / 2**30:.2f} GiB "
                f"(max_streams={max_streams}, ring_frames={self.ring_frames},"
                f" extend_batch={self.extend_batch}, "
                f"score_batch={self.score_batch}, esc_batch={self.esc_batch})"
                f" — lower max_streams or the batch sizes, pass "
                f"auto_batch=True to shrink the batches to fit, or pass "
                f"hbm_limit=0 to override the guard")
            # structured access for tools (message wording is not an API)
            err.hbm_estimate = self.hbm_estimate
            err.hbm_limit = limit
            raise err

        # +1 slot: scratch for batch-padding rows
        self._scratch = max_streams
        dev = self.device
        self._feats = torch.zeros((max_streams + 1, self.ring_frames,
                                   self._channels), dtype=self.dtype,
                                  device=dev)
        self._extractor = model.ssl_model.model.feature_extractor
        self._seg_arange = torch.arange(self.seg_frames, device=dev)
        self._win_arange = torch.arange(self.win_frames, device=dev)
        self.escalate_band = escalate_band
        self.escalate_center = escalate_center
        self.ring_samples = self.ring_frames * stride
        if esc_gather not in ("slice", "flat"):
            raise ValueError(f"esc_gather must be 'slice' or 'flat', got "
                             f"{esc_gather!r}")
        self.esc_gather = esc_gather
        self._esc_model = escalate
        self._swave = None
        if self._escalate:
            # the sample ring, in frame rows of `stride` samples so that
            # writes and gathers move whole rows
            self._swave = torch.zeros((max_streams + 1, self.ring_frames,
                                       stride), dtype=self._ttorch,
                                      device=dev)
            self._tail_arange = torch.arange(self._tail_rows, device=dev)
            self._dur_arange = torch.arange(duration, device=dev)

        # the zero-segment fastpath: an exact-zero segment (dead air; 0
        # encodes to 0 in every transport) has a constant conv output, so
        # it skips the conv and its precomputed rows are written instead;
        # when the remaining live segments fit a rung of the extend ladder
        # the conv runs at that shape
        self._fastpath = bool(extend_fastpath)
        self._subshape_ok = True
        self._extend_rungs = _shape_ladder(self.extend_batch, extend_rungs,
                                           "extend")
        # score / escalation ladders are opt-in: with the energy gate the
        # due loud windows are fewer than the provisioned batch on bursty
        # workloads, and a half-empty dispatch costs a full one
        self._score_rungs = _shape_ladder(self.score_batch, score_rungs,
                                          "score")
        self._esc_rungs = _shape_ladder(self.esc_batch, esc_rungs,
                                        "escalate")
        # adaptive provisioning: EMAs of live rows per dispatch family;
        # every provision_after polls, a family whose EMA sits below half
        # its smallest shape gains rungs until one fits, within a budget
        self._auto_provision = bool(auto_provision)
        self._provision_after = max(int(provision_after), 1)
        self._ap_polls = 0
        self._ap_budget = 6  # max auto-added rungs
        self._ap_ema = {"score": None, "escalate": None, "extend": None}
        self._const_rows = None  # conv(zero segment) rows, derived lazily
        # stands in before derivation: the zero-batch rows such calls
        # write all go to the scratch slot
        self._const_zero = torch.zeros((self.seg_frames, self._channels),
                                       dtype=self.dtype, device=dev)

        self._slots: Dict[int, _StreamState] = {}
        self._free = collections.deque(range(max_streams))
        self._rr = 0  # round-robin offset; advances once per poll
        self.dispatch_counts = {"extend": 0, "extend_const": 0,
                                "score": 0, "escalate": 0}
        # actual rows per counter (rung names are positional)
        self.rung_rows = {"extend": self.extend_batch,
                          "extend_const": self.extend_batch,
                          "score": self.score_batch,
                          "escalate": self.esc_batch}
        for _rb, _nm in (self._extend_rungs + self._score_rungs
                         + self._esc_rungs):
            self.dispatch_counts.setdefault(_nm, 0)
            self.rung_rows[_nm] = _rb
        self.dispatch_counts.setdefault("extend_half", 0)
        self.dispatch_counts.setdefault("extend_quarter", 0)

    # ---------------------------------------------------------- memory guard

    def _estimate(self, model, cfg, escalate) -> None:
        """Set the estimate at the current batch sizes:
        ``hbm_estimate_jax`` (:meth:`_estimate_hbm`, the JAX package's
        formula), ``hbm_estimate_eager`` (:meth:`_estimate_eager`) and their
        sum ``hbm_estimate``, which the guard's decisions read."""
        self.hbm_estimate_jax = self._estimate_hbm(model, cfg, escalate)
        self.hbm_estimate_eager = self._estimate_eager(cfg, escalate)
        self.hbm_estimate = self.hbm_estimate_jax + self.hbm_estimate_eager

    def _estimate_eager(self, cfg, escalate) -> int:
        """The port's own term (bytes): the f32 temporaries the eager
        forward holds beyond JAX's formula (:func:`eager_row_bytes`) at the
        peak of the largest dispatch. Dispatches run one after another, so
        the term is the largest of extend, score and escalation rows x
        their batch."""
        terms = [self.extend_batch * eager_row_bytes(
                     cfg, self.dtype, samples=self.seg_samples),
                 self.score_batch * eager_row_bytes(
                     cfg, self.dtype, frames=self.win_frames)]
        if escalate is not None:
            terms.append(self.esc_batch * eager_row_bytes(
                escalate.w2v_cfg, escalate.ssl_model.model.dtype,
                self.duration, self.win_frames))
        return max(terms)

    def _estimate_hbm(self, model, cfg, escalate) -> int:
        """Coarse device-memory estimate (bytes): the models' parameters
        and buffers, the two rings, the extend's conv activations and the
        score / escalation forwards' activations (2x margin on activations
        for temporaries). It turns an order-of-magnitude misconfiguration
        into a ValueError with numbers; it does not model the allocator.
        The formula is the JAX package's, the sample ring counted whether
        or not a cascade allocates it."""
        itemsize = self.dtype.itemsize
        total = _module_bytes(model)
        total += (self.max_streams + 1) * self.ring_frames \
            * self._channels * itemsize
        total += (self.max_streams + 1) * self.ring_frames * self.stride \
            * np.dtype(self._tdtype).itemsize

        # extend: conv activations per segment (sum over layer outputs)
        t, conv_act = self.seg_samples, self.seg_samples
        for (c, k, s) in cfg.conv_layers:
            t = (t - k) // s + 1
            conv_act += t * c
        act = self.extend_batch * conv_act * 4

        # score: window gather + transformer working set per layer
        embed = cfg.encoder_embed_dim
        ffn = cfg.encoder_ffn_dim
        wf = self.win_frames
        act += self.score_batch * wf * self._channels * itemsize
        act += 2 * self.score_batch * (
            wf * embed * 4 + cfg.encoder_heads * wf * wf + wf * ffn) \
            * itemsize

        if escalate is not None:
            total += _module_bytes(escalate)
            # the flagship's conv over a full window and its transformer,
            # approximated with this cfg's widths
            scale = self.duration / max(self.seg_samples, 1)
            act += self.esc_batch * conv_act * scale * 4
            act += 2 * self.esc_batch * (
                wf * embed * 4 + cfg.encoder_heads * wf * wf + wf * ffn) \
                * itemsize
        return int(total + 2 * act)

    # ------------------------------------------------------ device dispatches

    def _put(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _decode(self, x: torch.Tensor) -> torch.Tensor:
        """Transport samples -> float32 wave, on the device."""
        if self._mulaw:
            return mulaw_decode(x)
        if self._ttorch is torch.int16:
            return x.float() * (1.0 / 32768.0)
        return x

    def _zero_scatter(self, feats, swave, const_rows, zslots, zpos) -> None:
        """Write conv(0) feature rows and zero sample rows for the zero
        segments (padded with the scratch slot)."""
        zidx = (zpos[:, None] + self._seg_arange) % self.ring_frames
        feats[zslots[:, None], zidx] = const_rows.to(self.dtype)
        if swave is not None:
            zero = torch.zeros((), dtype=self._ttorch, device=swave.device)
            if self._tail_rows:
                ztidx = (zpos[:, None] + self.seg_frames
                         + self._tail_arange) % self.ring_frames
                swave[zslots[:, None], ztidx] = zero
            swave[zslots[:, None], zidx] = zero

    # The dispatches, as functions of the rings (written in place) and the
    # modules they run: the engine calls them on its own rings and model
    # under inference_mode (below), and cli/export.py traces them with
    # torch.export into the programs of a serving bundle.

    def extend_rings(self, extractor, const_rows, feats, swave, segs, slots,
                     pos, zslots, zpos) -> None:
        """One extend: the zero segments' rows first, then the conv of the
        live segments into the feature ring and their samples into the
        sample ring (``swave``, None without a cascade), the zero-padded
        tail rows before the full rows. Where segment k's tail row and
        segment k+1's first row are the same ring row, the ordered writes
        let the real data win."""
        self._zero_scatter(feats, swave, const_rows, zslots, zpos)
        waves = self._decode(segs)
        if waves.device.type == "cpu":
            # PyTorch's CPU convolutions pick their algorithm by batch
            # size, so a row's features would depend on its batch; one row
            # a call keeps them exact across the extend ladder and the
            # precomputed zero rows, as XLA's are
            new = torch.cat([extractor(w[None]) for w in waves])
        else:
            new = extractor(waves)
        idx = (pos[:, None] + self._seg_arange) % self.ring_frames
        feats[slots[:, None], idx] = new.to(self.dtype)
        if swave is not None:
            full = self.seg_frames * self.stride
            if self._tail_rows:
                tail = F.pad(segs[:, full:], (
                    0, self._tail_rows * self.stride - self._tail_len))
                tidx = (pos[:, None] + self.seg_frames
                        + self._tail_arange) % self.ring_frames
                swave[slots[:, None], tidx] = tail.reshape(
                    -1, self._tail_rows, self.stride)
            swave[slots[:, None], idx] = segs[:, :full].reshape(
                -1, self.seg_frames, self.stride)

    def score_windows(self, model, feats, slots, starts) -> torch.Tensor:
        """(B,) bonafide logits of the windows at ring frames ``starts``."""
        idx = (starts[:, None] + self._win_arange) % self.ring_frames
        windows = feats[slots[:, None], idx]  # (B, win_frames, C)
        return model(None, conv_feats=windows)[:, 1]

    def score_esc_windows(self, model, swave, slots, starts) -> torch.Tensor:
        """(B,) flagship logits of the windows' raw samples. ``slice``
        gathers the B slot rows, then each window is a contiguous slice of
        its doubled row (the doubling takes the ring's wrap); ``flat``
        gathers per sample. Both give the same samples."""
        flat = swave.view(swave.shape[0], self.ring_samples)
        if self.esc_gather == "slice":
            rows = flat[slots]  # (B, ring_samples)
            dbl = torch.cat([rows, rows], dim=1)
            waves = dbl.unfold(1, self.duration, self.stride)[
                torch.arange(len(slots), device=swave.device), starts]
        else:
            sidx = (starts[:, None] * self.stride + self._dur_arange) \
                % self.ring_samples
            waves = flat[slots[:, None], sidx]
        return model(self._decode(waves))[:, 1]

    def _extend(self, const_rows, segs, slots, pos, zslots, zpos) -> None:
        with torch.inference_mode():
            self.extend_rings(self._extractor, const_rows, self._feats,
                              self._swave, segs, slots, pos, zslots, zpos)

    def _extend_const(self, const_rows, zslots, zpos) -> None:
        """The zero segments' rows alone, for a tick with no live segment
        (a folded dispatch would pay the conv on an all-padding batch)."""
        with torch.inference_mode():
            self._zero_scatter(self._feats, self._swave, const_rows, zslots,
                               zpos)

    def _score(self, slots, starts) -> torch.Tensor:
        with torch.inference_mode():
            return self.score_windows(self.model, self._feats, slots, starts)

    def _score_esc(self, slots, starts) -> torch.Tensor:
        with torch.inference_mode():
            return self.score_esc_windows(self._esc_model, self._swave,
                                          slots, starts)

    # ------------------------------------------------------------- lifecycle

    def open_stream(self, stream_id=None) -> int:
        """Claim a slot for a new stream; returns the handle."""
        if not self._free:
            raise RuntimeError(
                f"all {self.max_streams} stream slots are busy")
        slot = self._free.popleft()
        self._slots[slot] = _StreamState(
            stream_id if stream_id is not None else slot, self._tdtype,
            head_cap=self.duration)
        return slot

    def close_stream(self, handle: int, flush: bool = False) -> None:
        """Release a slot. ``flush=True`` finishes scoring with the offline
        scorers' window semantics (engine/streaming.py ``frame_starts``):

        - no samples pushed: the slot frees at once, no window;
        - fewer than one window of samples: the stream is repeat-tiled
          into exactly one window (the dataset's duration fit);
        - otherwise: hop-grid windows plus, when the grid does not reach
          the end, a final window at ``total - duration`` snapped down to
          the conv frame grid (the sub-frame remainder zero-padded, as the
          offline incremental scorer pads its last segment).

        The slot frees once its remaining windows drain through
        :meth:`poll`.
        """
        st = self._slots.get(handle)
        if st is None:
            raise KeyError(f"no open stream at slot {handle}")
        if st.final_win is not None and flush:
            return  # a flush in progress; redoing it would corrupt the tail
        st.coalesce()
        total = st.next_seg * self.seg_hop + len(st.buf)
        if not flush or total == 0:
            del self._slots[handle]
            self._free.append(handle)
            return
        if total <= self.duration:
            if st.next_win >= 1:
                # exactly one window of samples, already scored
                del self._slots[handle]
                self._free.append(handle)
                return
            # short stream: repeat-tile into one window; the ring rows are
            # extracted again from the tiled wave
            wave = np.concatenate(st.head)[:total]
            reps = -(-self.duration // total)
            st.buf = np.ascontiguousarray(
                np.tile(wave, reps)[: self.duration])
            st.next_seg = 0
            st.final_win = 1
            st.tail_frame = None
            last_win = 0
        else:
            last_win = (total - self.duration) // self.hop
            st.final_win = last_win + 1
            s_tail = (total - self.duration) - ((total - self.duration)
                                                % self.stride)
            if s_tail > last_win * self.hop:
                # the hop grid does not reach the end: one window more,
                # tail-aligned on real audio
                st.tail_frame = s_tail // self.stride
                st.final_win += 1
        # pad so that the frames needed end on a segment boundary (a
        # partial segment is never extracted), then let poll() drain
        if st.tail_frame is not None:
            frames_needed = st.tail_frame + self.win_frames
        else:
            frames_needed = last_win * self.hop_frames + self.win_frames
        segs_needed = -(-frames_needed // self.seg_frames)
        need = conv_segment_geometry(self._cfg, self.seg_frames,
                                     segs_needed)[2]
        have = st.next_seg * self.seg_hop + len(st.buf)
        if need > have:
            st.buf = np.concatenate(
                [st.buf, np.zeros(need - have, self._tdtype)])

    @property
    def active_streams(self) -> int:
        return len(self._slots)

    def pending_samples(self, handle: int) -> int:
        """Samples pushed and not yet extracted into conv segments: the
        host-side backlog. About one hop while polling keeps up."""
        st = self._slots.get(handle)
        return int(st.pending_samples) if st is not None else 0

    def is_open(self, handle: int) -> bool:
        """True while ``handle`` owns a slot (a closing stream whose final
        windows are still draining included). Slots are reused after
        release."""
        return handle in self._slots

    # ------------------------------------------------------------------ i/o

    def push(self, handle: int, samples: np.ndarray) -> None:
        """Append samples to a stream (host memory only; the device work
        happens in :meth:`poll`). Float waves are in [-1, 1]; int16 chunks
        are 16-bit PCM under any transport."""
        st = self._slots.get(handle)
        if st is None:
            raise KeyError(f"no open stream at slot {handle}")
        if st.final_win is not None:
            raise RuntimeError("stream is closing (close_stream flush=True)")
        samples = np.asarray(samples).reshape(-1)
        if samples.dtype != self._tdtype:
            if self._mulaw:
                if samples.dtype == np.int16:  # raw PCM -> float first
                    samples = samples.astype(np.float32) * (1.0 / 32768.0)
                samples = mulaw_encode(samples)
            elif self._tdtype is np.int16:  # float wave -> 16-bit PCM
                samples = np.clip(np.rint(samples * 32768.0),
                                  -32768, 32767).astype(np.int16)
            elif samples.dtype == np.int16:
                # raw PCM under the float32 transport: dequantize here (a
                # bare astype would feed the model +-32768-scale waves)
                samples = samples.astype(np.float32) * (1.0 / 32768.0)
            else:
                samples = samples.astype(np.float32)
        st.chunks.append(samples)
        st.chunks_len += len(samples)
        if st.head_len < st.head_cap:
            st.head.append(samples)
            st.head_len += len(samples)

    def _win_start_frame(self, st, w):
        """Ring start frame of window ``w``: the hop grid, except a
        flush-time tail-aligned final window (close_stream)."""
        if st.tail_frame is not None and w == st.final_win - 1:
            return st.tail_frame
        return w * self.hop_frames

    def _iter_slots(self):
        """Slots in round-robin order, rotated once per poll: under
        overload every stream gets batch rows in turn."""
        items = list(self._slots.items())
        if len(items) > 1:
            off = self._rr % len(items)
            items = items[off:] + items[:off]
        return items

    def _due_segments(self, limit=None):
        """(slot, seg_index, segment_samples) of extractable segments,
        oldest first per stream, within ring backpressure; stops at
        ``limit``."""
        out = []
        for slot, st in self._iter_slots():
            st.coalesce()
            k = st.next_seg
            # buf[0] is absolute sample k * seg_hop
            off = 0
            while len(st.buf) - off >= self.seg_samples:
                # backpressure: frames [k sf, (k+1) sf) may not overwrite
                # frames the oldest pending window still needs
                oldest_needed = self._win_start_frame(st, st.next_win)
                if (k + 1) * self.seg_frames - oldest_needed \
                        > self.ring_frames - self._ring_margin:
                    break
                out.append((slot, k,
                            st.buf[off:off + self.seg_samples]))
                if limit is not None and len(out) >= limit:
                    return out
                off += self.seg_hop
                k += 1
        return out

    def _consume(self, taken):
        """Advance per-stream state for the segments dispatched."""
        if self.gate_msq is not None:
            # segment k's new samples are its first seg_hop; their mean
            # square stands for frames [k sf, (k+1) sf)
            for slot, k, samples in taken:
                self._slots[slot].engsq[k] = self._mean_square(
                    samples[:self.seg_hop])
        by_slot = collections.Counter(slot for slot, _, _ in taken)
        for slot, n in by_slot.items():
            st = self._slots[slot]
            st.next_seg += n
            st.buf = st.buf[n * self.seg_hop:]

    def _mean_square(self, samples) -> float:
        """Mean square of transport samples on the float [-1, 1] scale
        (the device's decode for float32 / int16; the continuous mu-law
        decode for mulaw8)."""
        if len(samples) == 0:
            return 0.0
        if self._tdtype is np.int16:
            x = samples.astype(np.float32) * (1.0 / 32768.0)
        elif self._mulaw:
            y = np.clip(samples.astype(np.float32), -127.0, 127.0) \
                * (1.0 / 127.0)
            x = np.sign(y) * np.expm1(np.abs(y) * np.log1p(_MU)) \
                * (1.0 / _MU)
        else:
            x = samples
        return float(np.mean(np.square(x, dtype=np.float32)))

    def _due_windows(self, limit=None):
        """Scoreable (slot, window, start_frame) in round-robin order;
        stops at ``limit``."""
        out = []
        for slot, st in self._iter_slots():
            frames_done = st.next_seg * self.seg_frames
            w = st.next_win
            while st.final_win is None or w < st.final_win:
                start = self._win_start_frame(st, w)
                if start + self.win_frames > frames_done:
                    break
                out.append((slot, w, start))
                if limit is not None and len(out) >= limit:
                    return out
                w += 1
        return out

    def _window_msq(self, st, start: int) -> Optional[float]:
        """Mean-square energy of the window at frame ``start`` from the
        per-segment sums; None when a covering segment's is unknown (then
        the window is scored)."""
        sf = self.seg_frames
        k0 = start // sf
        k1 = -(-(start + self.win_frames) // sf)
        total = 0.0
        for k in range(k0, k1):
            e = st.engsq.get(k)
            if e is None:
                return None
            total += e
        return total / max(1, k1 - k0)

    def _due_windows_gated(self, limit):
        """:meth:`_due_windows` with the gate: (to_score, gated), gated
        windows taking no batch row. A stream stops at its first loud
        window that does not fit the batch, so next_win advances
        contiguously."""
        to_score, gated = [], []
        gate_cap = 4 * self.score_batch  # bounds the host work per poll
        for slot, st in self._iter_slots():
            frames_done = st.next_seg * self.seg_frames
            w = st.next_win
            while st.final_win is None or w < st.final_win:
                start = self._win_start_frame(st, w)
                if start + self.win_frames > frames_done:
                    break
                msq = self._window_msq(st, start)
                if msq is not None and msq < self.gate_msq:
                    if len(gated) >= gate_cap:
                        return to_score, gated
                    gated.append((slot, w, start))
                else:
                    if len(to_score) >= limit:
                        break  # this stream stops; others may still gate
                    to_score.append((slot, w, start))
                w += 1
        return to_score, gated

    def _prune_engsq(self, slot) -> None:
        """Drop per-segment energies older than any window still due."""
        st = self._slots.get(slot)
        if st is None:
            return
        if st.final_win is not None and st.next_win >= st.final_win:
            st.engsq.clear()
            return
        oldest = self._win_start_frame(st, st.next_win) // self.seg_frames
        for k in [k for k in st.engsq if k < oldest]:
            del st.engsq[k]

    def _scratch_batch(self, n):
        """(slots, pos) device tensors of ``n`` scratch-padding rows."""
        return (self._put(np.full((n,), self._scratch, np.int64)),
                self._put(np.zeros((n,), np.int64)))

    def _zero_segs(self, n):
        return self._put(np.zeros((n, self.seg_samples), self._tdtype))

    def _ensure_const_rows(self) -> None:
        """Derive the conv(zero segment) rows once per weight set: an
        extend of an all-zero scratch batch, then the scratch slot's
        rows."""
        if self._const_rows is not None:
            return
        slots, pos = self._scratch_batch(self.extend_batch)
        self._extend(self._const_zero, self._zero_segs(self.extend_batch),
                     slots, pos, slots, pos)
        self._const_rows = self._feats[self._scratch,
                                       :self.seg_frames].clone()

    # ------------------------------------------------ adaptive provisioning

    def _ap_obs(self, fam: str, rows: int) -> None:
        """Update the live-row EMA of a dispatch family (a poll where the
        family did not dispatch contributes nothing)."""
        prev = self._ap_ema[fam]
        self._ap_ema[fam] = rows if prev is None \
            else prev + (rows - prev) * (1.0 / 16.0)

    def _maybe_auto_provision(self) -> None:
        """Deepen rung ladders to match observed demand, every
        ``provision_after`` polls; each rung added spends one unit of the
        budget."""
        if (not self._auto_provision or not self._subshape_ok
                or self._ap_budget <= 0
                or self._ap_polls < self._provision_after):
            return
        self._ap_polls = 0
        added = []
        for fam, full, attr in (("score", self.score_batch, "_score_rungs"),
                                ("extend", self.extend_batch,
                                 "_extend_rungs"),
                                ("escalate", self.esc_batch, "_esc_rungs")):
            ema = self._ap_ema[fam]
            if ema is None or (fam == "extend" and not self._fastpath):
                continue  # extend sub-shapes only dispatch with fastpath
            rungs = getattr(self, attr)
            depth = len(rungs)
            while self._ap_budget > 0 and depth < 4:
                smallest = rungs[-1][0] if rungs else full
                # deepen while the next rung (smallest / 2) still fits the
                # typical demand
                if ema > smallest / 2:
                    break
                deeper = _shape_ladder(full, depth + 1, fam)
                if len(deeper) <= len(rungs):
                    break  # one row: no smaller shape
                depth += 1
                self._ap_budget -= 1
                added.append(deeper[-1][1])
                rungs = deeper
            if len(rungs) > len(getattr(self, attr)):
                setattr(self, attr, rungs)
                for rb, nm in rungs:
                    self.dispatch_counts.setdefault(nm, 0)
                    self.rung_rows[nm] = rb
        if added:
            print(f"[serving] auto-provision: added dispatch rungs "
                  f"{added} from observed load (EMAs "
                  f"{ {k: round(v, 1) for k, v in self._ap_ema.items() if v is not None} }); "
                  f"pass auto_provision=False for fixed shapes",
                  file=sys.stderr)

    def provisioning(self) -> Dict[str, object]:
        """Dispatch-shape provisioning: rung rows per family, the
        auto-deepening budget left, and the live-row EMAs."""
        return {
            "score": [self.score_batch] + [r for r, _ in self._score_rungs],
            "extend": [self.extend_batch]
            + [r for r, _ in self._extend_rungs],
            "escalate": ([self.esc_batch]
                         + [r for r, _ in self._esc_rungs]
                         if self._escalate else []),
            "auto": self._auto_provision and self._subshape_ok,
            "auto_budget_left": self._ap_budget,
            "ema": {k: round(v, 1) for k, v in self._ap_ema.items()
                    if v is not None},
        }

    @staticmethod
    def _rung(n, full, full_key, rungs):
        """(rows, counter) of the smallest shape that fits ``n`` rows."""
        nb, key = full, full_key
        for rb, rname in rungs:
            if n > rb:
                break
            nb, key = rb, rname
        return nb, key

    def poll(self) -> List[WindowScore]:
        """Run at most one ``extend`` (the zero segments' rows folded in)
        and one ``score`` dispatch, plus the escalation chunks; returns the
        completed window scores. Call repeatedly (or :meth:`drain`) to
        work through a backlog larger than the batches."""
        results: List[WindowScore] = []
        self._last_poll_work = False
        self._ap_polls += 1
        self._maybe_auto_provision()
        self._rr += 1
        segs = self._due_segments(limit=self.extend_batch)
        if segs:
            self._last_poll_work = True
            if self._fastpath:
                live = [s for s in segs if s[2].any()]
                zero_segs = [s for s in segs if not s[2].any()]
            else:
                live, zero_segs = segs, []
            zslots = np.full((self.extend_batch,), self._scratch, np.int64)
            zpos = np.zeros((self.extend_batch,), np.int64)
            if zero_segs:
                self._ensure_const_rows()
                self.zero_segments += len(zero_segs)
                for i, (slot, seg_idx, _s) in enumerate(zero_segs):
                    zslots[i] = slot
                    zpos[i] = (seg_idx * self.seg_frames) % self.ring_frames
            if live:
                self._ap_obs("extend", len(live))
                nb, key = self.extend_batch, "extend"
                if self._fastpath and self._subshape_ok:
                    nb, key = self._rung(len(live), nb, key,
                                         self._extend_rungs)
                seg_mat = np.zeros((nb, self.seg_samples), self._tdtype)
                slots = np.full((nb,), self._scratch, np.int64)
                pos = np.zeros((nb,), np.int64)
                for i, (slot, seg_idx, samples) in enumerate(live):
                    seg_mat[i] = samples
                    slots[i] = slot
                    pos[i] = (seg_idx * self.seg_frames) % self.ring_frames
                self._extend(
                    (self._const_rows if self._const_rows is not None
                     else self._const_zero),
                    self._put(seg_mat), self._put(slots), self._put(pos),
                    self._put(zslots), self._put(zpos))
                self.dispatch_counts[key] += 1
            elif zero_segs:
                self._extend_const(self._const_rows, self._put(zslots),
                                   self._put(zpos))
                self.dispatch_counts["extend_const"] += 1
            self._consume(segs)

        gated = []
        if self.gate_msq is None:
            wins = self._due_windows(limit=self.score_batch)
        else:
            wins, gated = self._due_windows_gated(self.score_batch)
            if gated:
                self._last_poll_work = True
                self.gated_windows += len(gated)
                for slot, w, start in gated:
                    st = self._slots[slot]
                    st.next_win = max(st.next_win, w + 1)
                    results.append(WindowScore(st.stream_id,
                                               start * self.stride,
                                               self.gate_score,
                                               False, True))
        if wins:
            self._last_poll_work = True
            self._ap_obs("score", len(wins))
            nbs, skey = self.score_batch, "score"
            if self._subshape_ok:
                nbs, skey = self._rung(len(wins), nbs, skey,
                                       self._score_rungs)
            slots = np.full((nbs,), self._scratch, np.int64)
            starts = np.zeros((nbs,), np.int64)
            for i, (slot, w, start) in enumerate(wins):
                slots[i] = slot
                starts[i] = start % self.ring_frames
            scores = self._score(self._put(slots), self._put(starts)
                                 ).float().cpu().numpy()
            self.dispatch_counts[skey] += 1
            escalated = np.zeros(len(wins), bool)
            if self._escalate:
                # same-poll escalation: backpressure still protects the
                # ring rows (no extend ran since the gather above)
                due = [i for i in range(len(wins))
                       if abs(float(scores[i]) - self.escalate_center)
                       <= self.escalate_band]
                if due:
                    # the residual (last) chunk is what padding wastes on
                    self._ap_obs("escalate",
                                 (len(due) - 1) % self.esc_batch + 1)
                for c0 in range(0, len(due), self.esc_batch):
                    chunk = due[c0: c0 + self.esc_batch]
                    nbe, ekey = self.esc_batch, "escalate"
                    if self._subshape_ok:
                        nbe, ekey = self._rung(len(chunk), nbe, ekey,
                                               self._esc_rungs)
                    eslots = np.full((nbe,), self._scratch, np.int64)
                    estarts = np.zeros((nbe,), np.int64)
                    for j, i in enumerate(chunk):
                        eslots[j] = slots[i]
                        estarts[j] = starts[i]
                    esc_scores = self._score_esc(
                        self._put(eslots), self._put(estarts)
                    ).float().cpu().numpy()
                    self.dispatch_counts[ekey] += 1
                    for j, i in enumerate(chunk):
                        scores[i] = esc_scores[j]
                        escalated[i] = True
            for i, (slot, w, start) in enumerate(wins):
                st = self._slots[slot]
                # max(): a later gated window of this stream may already
                # have advanced past this one within this poll
                st.next_win = max(st.next_win, w + 1)
                results.append(WindowScore(st.stream_id,
                                           start * self.stride,
                                           float(scores[i]),
                                           bool(escalated[i])))
        if gated and wins:
            # gated results went in before the score dispatch, so a
            # stream's gated window w+1 can precede its scored window w:
            # reorder each stream's own entries by start, keeping the
            # positions (and the interleave across streams)
            by_stream: Dict[object, List[int]] = {}
            for idx, r in enumerate(results):
                by_stream.setdefault(r.stream_id, []).append(idx)
            for idxs in by_stream.values():
                if len(idxs) > 1:
                    vals = sorted((results[i] for i in idxs),
                                  key=lambda r: r.start_sample)
                    for i, v in zip(idxs, vals):
                        results[i] = v
        if self.gate_msq is not None:
            for slot in ({s for s, _, _ in wins}
                         | {s for s, _, _ in gated}):
                self._prune_engsq(slot)
        # release closing streams whose final window has been scored
        for slot in [s for s, st in self._slots.items()
                     if st.final_win is not None
                     and st.next_win >= st.final_win]:
            del self._slots[slot]
            self._free.append(slot)
        return results

    def _has_pending(self) -> bool:
        """Any extractable segment or scoreable window left?"""
        for st in self._slots.values():
            if st.pending_samples >= self.seg_samples:
                return True
            frames_done = st.next_seg * self.seg_frames
            w = st.next_win
            if ((st.final_win is None or w < st.final_win)
                    and self._win_start_frame(st, w) + self.win_frames
                    <= frames_done):
                return True
        return False

    def drain(self, max_polls: int = 10_000) -> List[WindowScore]:
        """Poll until no stream has extractable work; returns all scores."""
        out: List[WindowScore] = []
        for _ in range(max_polls):
            out.extend(self.poll())
            if not self._last_poll_work:
                if not self._has_pending():
                    return out
                raise RuntimeError(
                    "drain stalled with work pending (ring backpressure "
                    "deadlock? raise ring_frames)")
        raise RuntimeError("drain did not converge")

    # ------------------------------------------------------------ hot swap

    def swap_model(self, state_dict, *, escalate=None) -> None:
        """Hot checkpoint swap: load new weights into the serving models in
        place, with no reallocation and no stream dropped. ``state_dict``
        (and ``escalate``, the cascade flagship's, valid only on an engine
        built with one) are state dicts as ``model.state_dict()`` gives
        them. Every key, shape and dtype is checked before anything is
        copied: a mismatch raises ValueError naming the first bad key and
        leaves the engine as it was.

        Segments extended before the swap keep their old-conv features in
        the ring, so windows straddling the swap are scored by the new
        model on old-conv features; escalated windows run fully through
        the new flagship. Not thread-safe against a concurrent poll."""
        self._check_state("state_dict", self.model, state_dict)
        if escalate is not None:
            if not self._escalate:
                raise ValueError("swap_model(escalate=...) on an engine "
                                 "built without a cascade")
            self._check_state("escalate", self._esc_model, escalate)
        self.model.load_state_dict(state_dict, strict=True)
        if escalate is not None:
            self._esc_model.load_state_dict(escalate, strict=True)
        self._const_rows = None  # conv(0) rows follow the new conv weights
        self.model_swaps += 1

    @staticmethod
    def _check_state(what, module, new):
        """Same keys, shapes and dtypes as ``module``'s state dict, or a
        ValueError naming the first mismatch."""
        old = module.state_dict()
        missing = [k for k in old if k not in new]
        extra = [k for k in new if k not in old]
        if missing or extra:
            key, how = (missing[0], "missing") if missing \
                else (extra[0], "unexpected")
            raise ValueError(
                f"swap_model: {what} key {key!r} is {how} (different "
                f"architecture/quantization mode?) — rebuild the engine "
                f"instead")
        for key, a in old.items():
            b = new[key]
            if tuple(a.shape) != tuple(b.shape) or a.dtype != b.dtype:
                raise ValueError(
                    f"swap_model: {what}[{key!r}] is {tuple(b.shape)}/"
                    f"{b.dtype}, the serving model has {tuple(a.shape)}/"
                    f"{a.dtype} — same architecture checkpoints only")

    # -------------------------------------------------------- warm-up, costs

    def _shapes(self):
        """(counter, rows, dispatch) of every configured shape; ``dispatch``
        runs one dispatch of that shape on scratch rows."""
        const = (self._const_rows if self._const_rows is not None
                 else self._const_zero)
        zslots, zpos = self._scratch_batch(self.extend_batch)
        out = []
        extend = [(self.extend_batch, "extend")]
        if self._fastpath and self._subshape_ok:
            extend += self._extend_rungs
        for rb, name in extend:
            segs = self._zero_segs(rb)
            slots, pos = self._scratch_batch(rb)
            out.append((name, rb, lambda s=segs, sl=slots, p=pos:
                        self._extend(const, s, sl, p, zslots, zpos)))
            if name == "extend" and self._fastpath:
                out.append(("extend_const", self.extend_batch,
                            lambda: self._extend_const(const, zslots, zpos)))
        for fn, full, name, rungs in (
                (self._score, self.score_batch, "score", self._score_rungs),
                (self._score_esc, self.esc_batch, "escalate",
                 self._esc_rungs)):
            if name == "escalate" and not self._escalate:
                continue
            for rb, rname in [(full, name)] + (rungs if self._subshape_ok
                                               else []):
                slots, starts = self._scratch_batch(rb)
                out.append((rname, rb, lambda f=fn, s=slots, t=starts:
                            f(s, t)))
        return out

    def warmup(self) -> None:
        """Run every configured dispatch shape once on scratch rows, so
        that the first real poll does not pay first-call costs (kernel
        builds, cuDNN's algorithm choice); derives the conv(0) rows under
        the fastpath."""
        if self._fastpath:
            self._ensure_const_rows()
        for _name, _rows, dispatch in self._shapes():
            dispatch()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def device_costs(self, n: int = 10) -> Dict[str, float]:
        """Device ms of one dispatch of each configured shape, keyed like
        :attr:`dispatch_counts`: ``n`` back-to-back dispatches on scratch
        rows after one warm-up, timed between CUDA events after a
        synchronize (on the CPU, ``perf_counter``). In eager mode this is
        the stream's elapsed time, which exceeds the kernels' time where
        the host sets the pace of the launches.
        ``sum(device_costs[k] * dispatch_counts[k])`` is the device time
        of a run. Live stream state is untouched."""
        self._ensure_const_rows()
        cuda = self.device.type == "cuda"
        out: Dict[str, float] = {}
        for name, _rows, dispatch in self._shapes():
            dispatch()
            if cuda:
                torch.cuda.synchronize(self.device)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(n):
                    dispatch()
                end.record()
                end.synchronize()
                out[name] = start.elapsed_time(end) / n
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    dispatch()
                out[name] = (time.perf_counter() - t0) / n * 1000.0
        return out

"""Portable model export: the port of ``rtdsd_tpu/cli/export.py``, with
``torch.export`` programs in the place of serialized StableHLO.

Packages the scoring function (the raw bonafide logit, NO pre-emphasis, the
semantics of ``cli.main --is_score``) into an artifact: the programs plus
the checkpoint's weights in a sidecar (``<out>.params``) and the metadata
(``<out>.json``). ``cli/infer.py`` scores from an artifact, and
``cli/serve.py`` / ``cli/daemon.py`` serve from a serving bundle, with no
model code: a program runs through ``ExportedProgram.module()`` and needs
only the kernels' operator registrations (``ops/attention.py``,
``ops/gat.py``).

    # flagship scorer, symbolic batch, programs for the CPU and the GPU
    python -m rtdsd_tpu_torch.cli.export --config cfg.yaml --ckpt best.pt \\
        --out model.tpex

    # distilled student at a fixed batch, int8 matmuls, GPU program only
    python -m rtdsd_tpu_torch.cli.export --config kd.yaml \\
        --ckpt runs/last_kd --student --w8a8 --batch 64 --platforms cuda \\
        --out student.tpex

Weights are call-time *arguments* of every program
(``torch.func.functional_call`` over a dict of tensors), not constants: the
program stays far smaller than its weights, and a new set of weights needs
no new program. The sidecar is the JAX package's format, flax msgpack of
its variables tree (``models/convert.py::to_jax_variables``), the bytes
``rtdsd_tpu.cli.export.save_params_sidecar`` writes for the same weights;
int8 models keep their ``vals`` / ``scales`` leaves there too.

``--platforms`` (default ``cpu,cuda``) names the devices the bundle holds a
program for: each is traced with the model and its inputs on that device,
since a graph records the device of every tensor it makes (the engine's
index ranges, the CPU-only bf16 positional-conv detour). A program file is
a zip of one ``torch.export`` archive per platform; a loader takes the
program of the device it runs on, and a platform the machine lacks raises
at export. Nothing falls back to another device.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import io
import json
import os
import sys
import zipfile
from types import SimpleNamespace
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from rtdsd_tpu_torch.device import resolve_device
from rtdsd_tpu_torch.models import convert
from rtdsd_tpu_torch.ops import attention, fastgelu, gat  # noqa: F401  (operators)
from rtdsd_tpu_torch.utils import flax_msgpack

PLATFORMS = ("cpu", "cuda")
FEATURE_EXTRACTOR = "ssl_model.model.feature_extractor."
# The sizes a symbolic dimension (a batch, a segment or window count) takes
# in every program: traced on the GPU, the model's operators guard a batch
# to 2..65535 (a size of 1 is specialised away), so the runners pad a
# count of 1 to 2 by repeating a row and drop the padding's outputs.
SYMBOLIC = (2, 65535)


def _dim(name: str) -> "torch.export.Dim":
    return torch.export.Dim(name, min=SYMBOLIC[0], max=SYMBOLIC[1])


def _padded(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last row repeated up to SYMBOLIC's least count."""
    short = SYMBOLIC[0] - x.shape[0]
    return x if short <= 0 else torch.cat([x, x[-1:].expand(
        short, *x.shape[1:])])


# ------------------------------------------------------------ tracing

class _Program(nn.Module):
    """``fn(model, *args)`` as a module whose only state is ``model``'s."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        object.__setattr__(self, "fn", fn)

    def forward(self, *args):
        return self.fn(self.model, *args)


class _Stateless(nn.Module):
    """The root of an exported program: it holds no tensor, and the
    weights (a dict keyed like ``model.state_dict()``) are its first
    argument."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        object.__setattr__(self, "program", _Program(model, fn))

    def forward(self, state, *args):
        return torch.func.functional_call(
            self.program, {f"model.{k}": v for k, v in state.items()}, args,
            strict=True)


def _state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A module's weights as a program argument: keys sorted, since a
    program reads its dict arguments in the order of the traced ones."""
    return dict(sorted((k, v.detach())
                       for k, v in module.state_dict().items()))


def _platform_device(platform: str) -> torch.device:
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r} (have: "
                         f"{', '.join(PLATFORMS)})")
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("platform cuda: this machine has no CUDA device; "
                           "export on a machine with the card, or pass "
                           "--platforms cpu")
    return torch.device(platform)


def _devices(platforms: Sequence[str]) -> Dict[str, torch.device]:
    """``{platform: device}``, every platform checked before any tracing."""
    return {p: _platform_device(p) for p in platforms}


def _on(module: nn.Module, dev: torch.device) -> nn.Module:
    """``module`` on ``dev`` (a copy where it lies elsewhere)."""
    here = next(module.parameters(), None)
    if here is None or here.device == dev:
        return module
    return copy.deepcopy(module).to(dev)


def _export(model: nn.Module, fn, args: tuple, dynamic=None):
    """``torch.export`` of ``fn(model, *args)`` with ``model``'s weights as
    the first argument; ``dynamic``, the dynamic shapes of ``args``. The
    example inputs (which hold the weights) are not kept."""
    state = _state(model)
    shapes = None
    if dynamic is not None:
        shapes = ({k: None for k in state}, tuple(dynamic))
    with torch.no_grad():
        ep = torch.export.export(_Stateless(model, fn), (state, *args),
                                 dynamic_shapes=shapes, strict=False)
    ep.example_inputs = None
    return ep


def _avals(ep) -> list:
    """``dtype[dims]`` of the program's non-weight inputs and outputs."""
    def aval(node):
        v = node.meta.get("val")
        if not isinstance(v, torch.Tensor):
            return str(v)
        return (f"{str(v.dtype).replace('torch.', '')}"
                f"[{','.join(str(d) for d in v.shape)}]")

    nodes = {n.name: n for n in ep.graph.nodes}
    sig = ep.graph_signature
    ins = [aval(nodes[s.arg.name]) for s in sig.input_specs
           if s.kind.name == "USER_INPUT" and hasattr(s.arg, "name")
           and not s.arg.name.startswith("state_")]
    outs = [aval(nodes[s.arg.name]) for s in sig.output_specs
            if s.kind.name == "USER_OUTPUT" and hasattr(s.arg, "name")]
    return [ins, outs]


def save_programs(path: str, programs: Dict[str, object]) -> int:
    """Write ``{platform: ExportedProgram}`` as one zip (an archive of
    ``torch.export.save`` per platform); returns the file's bytes."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for platform, ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"{platform}.pt2", buf.getvalue())
    return os.path.getsize(path)


def program_platforms(path: str) -> list:
    with zipfile.ZipFile(path) as z:
        return [n[:-len(".pt2")] for n in z.namelist() if n.endswith(".pt2")]


def load_program(path: str, device: torch.device):
    """The callable program of ``path`` for ``device``'s platform; raises
    if the bundle holds none for it."""
    have = program_platforms(path)
    if device.type not in have:
        raise ValueError(f"{path} holds programs for {have}, not for "
                         f"{device.type}; re-export with --platforms "
                         f"{device.type}")
    with zipfile.ZipFile(path) as z:
        blob = z.read(f"{device.type}.pt2")
    return torch.export.load(io.BytesIO(blob)).module()


# ------------------------------------------------------------ sidecars

def save_params_sidecar(path: str, state_dict, model_name: str) -> int:
    """Write ``<path>.params``, flax msgpack of the JAX variables tree of
    ``state_dict``; returns the byte count."""
    blob = flax_msgpack.packb(convert.to_jax_variables(state_dict,
                                                       model_name))
    with open(path + ".params", "wb") as f:
        f.write(blob)
    return len(blob)


def load_params_sidecar(path: str, model_name: str,
                        device: torch.device) -> Dict[str, torch.Tensor]:
    """The state dict in ``<path>.params``, on ``device``."""
    sidecar = path + ".params"
    if not os.path.exists(sidecar):
        raise FileNotFoundError(
            f"{sidecar} not found: artifacts store weights beside the "
            "program (re-export with cli.export)")
    sd = convert.from_jax_variables(flax_msgpack.read(sidecar), model_name)
    return {k: sd[k].to(device) for k in sorted(sd)}


def _read_meta(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


def _write_meta(path: str, meta: dict) -> None:
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


# ------------------------------------------------------------ batch scorer

def _score_fn(model, waves):
    return model(waves)[:, 1]


def export_scorer(model: nn.Module, *, num_samples: int,
                  batch: Optional[int] = None,
                  platforms: Sequence[str] = PLATFORMS) -> dict:
    """``{platform: ExportedProgram}`` of ``model``'s scoring forward,
    ``program(state, waves (B, num_samples) float32) -> (B,)``.
    ``batch=None`` exports a symbolic batch, B in :data:`SYMBOLIC`
    (:class:`ScoringArtifact` scores a batch of 1 padded to 2); an int
    pins it."""
    model = model.eval()
    out = {}
    for platform, dev in _devices(platforms).items():
        m = _on(model, dev)
        b = 2 if batch is None else int(batch)
        waves = torch.zeros((b, int(num_samples)), device=dev)
        dynamic = None if batch is not None else ({0: _dim("b")},)
        out[platform] = _export(m, _score_fn, (waves,), dynamic)
    return out


def save_exported(programs: dict, path: str, meta: dict, state_dict,
                  model_name: str) -> None:
    """Write the program file, the ``<path>.params`` sidecar and a
    ``<path>.json`` metadata sidecar."""
    nbytes = save_programs(path, programs)
    params_bytes = save_params_sidecar(path, state_dict, model_name)
    in_avals, out_avals = _avals(next(iter(programs.values())))
    if meta.get("batch") == "symbolic":
        meta = dict(meta, batch_range=list(SYMBOLIC))
    _write_meta(path, dict(meta, params_model=model_name, in_avals=in_avals,
                           out_avals=out_avals, platforms=list(programs),
                           artifact_bytes=nbytes, params_bytes=params_bytes))


class ScoringArtifact:
    """Loader and runner of :func:`export_scorer` artifacts: the program
    of this device's platform and its ``<path>.params`` weights.
    ``call(waves)`` scores a (B, T) float32 batch -> (B,) numpy; a
    symbolic-batch program gets a batch of 1 padded to 2."""

    def __init__(self, program, state: Dict[str, torch.Tensor],
                 device: torch.device, symbolic: bool = False):
        self._prog, self._state, self.device = program, state, device
        self.symbolic = symbolic

    @classmethod
    def load(cls, path: str, device=None) -> "ScoringArtifact":
        dev = resolve_device(device)
        meta = _read_meta(path)
        return cls(load_program(path, dev),
                   load_params_sidecar(path, meta["params_model"], dev), dev,
                   "batch_range" in meta)

    def call(self, waves) -> np.ndarray:
        w = torch.as_tensor(np.asarray(waves, np.float32)).to(self.device)
        n = w.shape[0]
        with torch.inference_mode():
            out = self._prog(self._state, _padded(w) if self.symbolic else w)
        return out[:n].float().cpu().numpy()


# ------------------------------------------------------------ streaming

def export_streaming(model: nn.Module, cfg, *, duration: int,
                     hop: Optional[int] = None, seg_frames: int = 256,
                     platforms: Sequence[str] = PLATFORMS):
    """The incremental streaming scorer as TWO programs, as
    ``engine/streaming.py::IncrementalStreamingScorer`` splits it: the conv
    extractor ``(state, segs (S, seg_samples)) -> (S * seg_frames, C)``
    over a symbolic segment count, and the window scorer
    ``(state, feats (F, C), idx (B, win_frames)) -> (B,)`` with symbolic F
    and B (S and B in :data:`SYMBOLIC`; the runner pads a count of 1).
    Host glue (segmenting, grid snapping) is integer arithmetic recorded
    in the metadata; :class:`StreamingArtifact` runs it.

    Returns ``({platform: conv program}, {platform: score program},
    meta)``."""
    from rtdsd_tpu_torch.models.wav2vec2 import conv_segment_geometry

    if cfg.extractor_mode != "layer_norm":
        raise ValueError("streaming export requires the layer_norm "
                         "extractor (group_norm couples frames across the "
                         "whole window)")
    stride = cfg.total_stride
    if hop is None:
        hop = duration // 2
    if hop < stride:
        raise ValueError(f"hop {hop} is below the conv frame stride "
                         f"{stride}; window starts snap to the frame grid")
    model = model.eval()
    n_ch = cfg.conv_layers[-1][0]
    seg_samples, seg_hop, _ = conv_segment_geometry(cfg, seg_frames, 1)
    win_frames = cfg.num_frames(duration)

    def conv_fn(extractor, segs):
        return extractor(segs).reshape(-1, n_ch)

    def score_fn(m, feats, idx):
        return m(None, conv_feats=feats[idx])[:, 1]

    convs, scores = {}, {}
    feats_dtype = model.ssl_model.model.dtype
    for platform, dev in _devices(platforms).items():
        m = _on(model, dev)
        segs = torch.zeros((2, seg_samples), device=dev)
        convs[platform] = _export(m.ssl_model.model.feature_extractor,
                                  conv_fn, (segs,),
                                  ({0: _dim("s")},))
        f = torch.export.Dim("f", min=win_frames)
        b = _dim("b")
        feats = torch.zeros((2 * win_frames, n_ch), dtype=feats_dtype,
                            device=dev)
        idx = torch.zeros((2, win_frames), dtype=torch.int64, device=dev)
        scores[platform] = _export(m, score_fn, (feats, idx),
                                   ({0: f}, {0: b}))
    meta = {
        "streaming": True,
        "duration": int(duration), "hop": int(hop), "stride": int(stride),
        "receptive_field": int(cfg.conv_receptive_field),
        "win_frames": int(win_frames), "channels": int(n_ch),
        "seg_frames": int(seg_frames), "seg_samples": int(seg_samples),
        "seg_hop": int(seg_hop),
        "feats_dtype": str(feats_dtype).replace("torch.", ""),
        "semantics": ("window score = bonafide logit on conv-grid-aligned "
                      "windows; no pre-emphasis"),
    }
    return convs, scores, meta


def save_streaming(convs: dict, scores: dict, prefix: str, meta: dict,
                   state_dict, model_name: str) -> None:
    """Write a streaming bundle: ``<prefix>.conv`` + ``<prefix>.score``
    programs, the ``<prefix>.params`` sidecar and one ``<prefix>.json``
    with the host-glue geometry."""
    blobs = {"conv_bytes": save_programs(prefix + ".conv", convs),
             "score_bytes": save_programs(prefix + ".score", scores),
             "params_bytes": save_params_sidecar(prefix, state_dict,
                                                 model_name)}
    _write_meta(prefix, dict(meta, params_model=model_name,
                             platforms=list(convs), **blobs))


class StreamingArtifact:
    """Model-free runner of :func:`export_streaming` bundles: the two
    programs, the weights and the JSON geometry reproduce
    ``IncrementalStreamingScorer.window_scores``."""

    def __init__(self, conv, score, meta: dict,
                 state: Dict[str, torch.Tensor], device: torch.device):
        self._conv, self._score = conv, score
        self.meta = dict(meta)
        self._state = state
        self._conv_state = {k[len(FEATURE_EXTRACTOR):]: v
                            for k, v in state.items()
                            if k.startswith(FEATURE_EXTRACTOR)}
        self.device = device

    @classmethod
    def load(cls, prefix: str, device=None) -> "StreamingArtifact":
        """Load ``<prefix>.conv`` / ``.score`` / ``.params`` / ``.json`` as
        the ``--streaming`` CLI writes them."""
        dev = resolve_device(device)
        meta = _read_meta(prefix)
        return cls(load_program(prefix + ".conv", dev),
                   load_program(prefix + ".score", dev), meta,
                   load_params_sidecar(prefix, meta["params_model"], dev),
                   dev)

    def _num_frames(self, t: int) -> int:
        m = self.meta
        return (t - m["receptive_field"]) // m["stride"] + 1

    def window_scores(self, wave, return_starts: bool = False,
                      batch_size: Optional[int] = None):
        """Per-window bonafide logits; with ``return_starts``, also the
        window start positions in samples (hop-grid starts snapped down to
        the conv frame grid, plus the tail window; not simply
        ``i * hop``). The windows go to the score program all at once, or
        ``batch_size`` at a time, the last batch padded by repeating its
        last window, as ``IncrementalStreamingScorer`` dispatches them."""
        m = self.meta
        wave = np.asarray(wave, np.float32).squeeze()
        t = int(wave.shape[-1])
        if t <= m["duration"]:  # short input: tile like the dataset fit
            reps = -(-m["duration"] // max(t, 1))
            wave = np.tile(wave, reps)[: m["duration"]]
            t = m["duration"]
        # conv features once per audio (symbolic segment count: no bucket)
        n_segs = -(-self._num_frames(t) // m["seg_frames"])
        pad_to = (n_segs - 1) * m["seg_hop"] + m["seg_samples"]
        if t < pad_to:
            wave = np.pad(wave, (0, pad_to - t))
        segs = torch.from_numpy(wave).to(self.device).unfold(
            0, m["seg_samples"], m["seg_hop"])[:n_segs].contiguous()
        # window starts on the hop grid (plus a tail window), snapped down
        # to the frame grid: engine.streaming's frame_starts and
        # window_starts, inlined so the runner needs no model code
        raw = list(range(0, t - m["duration"] + 1, m["hop"])) or [0]
        if raw[-1] + m["duration"] < t:
            raw.append(t - m["duration"])
        starts = sorted(dict.fromkeys(s - (s % m["stride"]) for s in raw))
        idx = torch.from_numpy(
            np.asarray(starts, np.int64)[:, None] // m["stride"]
            + np.arange(m["win_frames"], dtype=np.int64)).to(self.device)
        n = batch_size or len(starts)
        with torch.inference_mode():
            feats = self._conv(self._conv_state, _padded(segs))
            scores = torch.cat([self._score(self._state, feats, _padded(
                torch.cat([c, c[-1:].expand(n - len(c), -1)])))[:len(c)]
                for c in idx.split(n)])
        scores = scores.float().cpu().numpy()
        if return_starts:
            return scores, np.asarray(starts, np.int64)
        return scores

    def score(self, wave, aggregate: str = "mean") -> float:
        ws = self.window_scores(wave)
        agg = {"mean": np.mean, "min": np.min, "max": np.max,
               "median": np.median}[aggregate]
        return float(agg(ws))


# ------------------------------------------------------------ serving

def export_serving(model: nn.Module, cfg, *, duration: int,
                   hop: Optional[int] = None, max_streams: int = 8,
                   seg_frames: Optional[int] = None,
                   ring_frames: Optional[int] = None,
                   extend_batch: Optional[int] = None,
                   score_batch: Optional[int] = None,
                   transport_dtype: str = "int16",
                   escalate: Optional[nn.Module] = None,
                   escalate_band: float = 2.0,
                   escalate_center: float = 0.0,
                   esc_batch: Optional[int] = None,
                   esc_rate: Optional[float] = None,
                   platforms: Sequence[str] = PLATFORMS):
    """The multi-stream serving engine's dispatches as programs, at the
    engine's exact geometry (``engine/serving.py``): the batched extend
    (``(conv state, const_rows, feats, swave, segs, slots, pos, zslots,
    zpos)``, the zero-segment scatter folded in; the rings ``feats`` and,
    with a cascade, ``swave`` are inputs it writes in place), the batched
    window score (``(state, feats, slots, starts) -> (B,)``) and, with
    ``escalate``, the cascade's escalation re-score (``(flagship state,
    swave, slots, starts) -> (B,)``). :func:`load_serving` rebuilds an
    engine on them without model code. The host's knobs (energy gate,
    escalation band, memory guard) stay configurable at load.

    Returns ``({platform: extend}, {platform: score}, {platform: escalate}
    or None, meta)``."""
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer

    model = model.eval()
    if escalate is not None:
        escalate = escalate.eval()
    ext, sco, esc = {}, {}, ({} if escalate is not None else None)
    eng = None
    for platform, dev in _devices(platforms).items():
        m = _on(model, dev)
        e_m = None if escalate is None else _on(escalate, dev)
        eng = MultiStreamScorer(
            m, cfg, duration=duration, hop=hop, max_streams=max_streams,
            seg_frames=seg_frames, ring_frames=ring_frames,
            extend_batch=extend_batch, score_batch=score_batch,
            escalate=e_m, escalate_band=escalate_band,
            escalate_center=escalate_center, esc_batch=esc_batch,
            esc_rate=esc_rate, transport_dtype=transport_dtype,
            hbm_limit=0)   # the guard runs on the serving host
        rows = lambda n: torch.full((n,), eng._scratch, dtype=torch.int64,
                                    device=dev)
        zeros = lambda n: torch.zeros((n,), dtype=torch.int64, device=dev)
        nb = eng.extend_batch
        segs = torch.zeros((nb, eng.seg_samples), dtype=eng._ttorch,
                           device=dev)
        ext[platform] = _export(
            m.ssl_model.model.feature_extractor,
            lambda ex, *a: eng.extend_rings(ex, *a),
            (eng._const_zero, eng._feats, eng._swave, segs, rows(nb),
             zeros(nb), rows(nb), zeros(nb)))
        sb = eng.score_batch
        sco[platform] = _export(
            m, lambda mm, *a: eng.score_windows(mm, *a),
            (eng._feats, rows(sb), zeros(sb)))
        if escalate is not None:
            eb = eng.esc_batch
            esc[platform] = _export(
                e_m, lambda mm, *a: eng.score_esc_windows(mm, *a),
                (eng._swave, rows(eb), zeros(eb)))

    def dtype_name(module):
        return str(module.ssl_model.model.dtype).replace("torch.", "")

    meta = {
        "serving": True,
        # format 2: the extend program carries the folded zero-segment
        # scatter (const_rows, feats, swave, segs, slots, pos, zslots,
        # zpos), as the JAX package's
        "serving_format": 2,
        "w2v_cfg": dataclasses.asdict(cfg),
        "model_dtype": dtype_name(model),
        "duration": int(eng.duration), "hop": int(eng.hop),
        "max_streams": int(eng.max_streams),
        "seg_frames": int(eng.seg_frames),
        "ring_frames": int(eng.ring_frames),
        "extend_batch": int(eng.extend_batch),
        "score_batch": int(eng.score_batch),
        "esc_batch": int(eng.esc_batch),
        "esc_gather": eng.esc_gather,
        "transport_dtype": transport_dtype,
        "escalate": escalate is not None,
        "escalate_band": float(eng.escalate_band),
        "escalate_center": float(eng.escalate_center),
        "hbm_estimate": int(eng.hbm_estimate),
        "semantics": ("window score = bonafide logit on conv-grid-aligned "
                      "windows from live streams; no pre-emphasis"),
    }
    if escalate is not None:
        meta.update(esc_w2v_cfg=dataclasses.asdict(escalate.w2v_cfg),
                    esc_model_dtype=dtype_name(escalate))
    return ext, sco, esc, meta


def save_serving(ext: dict, sco: dict, esc: Optional[dict], prefix: str,
                 meta: dict, state_dict, model_name: str,
                 esc_state_dict=None, esc_model_name: Optional[str] = None
                 ) -> None:
    """Write a serving bundle: ``<prefix>.extend`` + ``<prefix>.score``
    (+ ``<prefix>.escalate``) programs, weight sidecars
    (``<prefix>.params``, ``<prefix>.esc.params``) and one
    ``<prefix>.json`` with the engine geometry."""
    blobs = {"extend_bytes": save_programs(prefix + ".extend", ext),
             "score_bytes": save_programs(prefix + ".score", sco)}
    if esc is not None:
        blobs["escalate_bytes"] = save_programs(prefix + ".escalate", esc)
    blobs["params_bytes"] = save_params_sidecar(prefix, state_dict,
                                                model_name)
    names = {"params_model": model_name}
    if esc_state_dict is not None:
        blobs["esc_params_bytes"] = save_params_sidecar(
            prefix + ".esc", esc_state_dict, esc_model_name)
        names["esc_params_model"] = esc_model_name
    _write_meta(prefix, dict(meta, platforms=list(ext), **names, **blobs))


class ArtifactModel(nn.Module):
    """Stand-in for a model in an artifact-backed serving engine: it holds
    the weights that the bundle's programs take as their first argument
    (``state``, updated in place by :meth:`load_state_dict`, so a hot swap
    reaches the programs), and the attributes the engine reads; calling it
    raises, so an accidental model call fails loudly."""

    def __init__(self, state: Dict[str, torch.Tensor], dtype: torch.dtype,
                 cfg):
        super().__init__()
        self.state = state
        self.w2v_cfg = cfg
        self.ssl_model = SimpleNamespace(model=SimpleNamespace(
            dtype=dtype, feature_extractor=None))

    def parameters(self, recurse: bool = True):
        return iter(self.state.values())

    def buffers(self, recurse: bool = True):
        return iter(())

    def state_dict(self, *args, **kwargs):
        return dict(self.state)

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        with torch.no_grad():
            for k, t in self.state.items():
                t.copy_(state_dict[k])

    def forward(self, *args, **kwargs):
        raise RuntimeError(
            "artifact-backed serving engine has no model code: its "
            "dispatches are the programs of export_serving; re-export to "
            "change the model")


def _w2v_config(d: dict):
    from rtdsd_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    d = dict(d)
    d["conv_layers"] = tuple(tuple(l) for l in d["conv_layers"])
    return Wav2Vec2Config(**d)


def read_serving_meta(prefix: str) -> dict:
    """The ``<prefix>.json`` of a serving bundle, checked."""
    meta = _read_meta(prefix)
    if not meta.get("serving"):
        raise ValueError(f"{prefix} is not a serving artifact (export with "
                         f"cli.export --serving)")
    if meta.get("serving_format", 1) != 2:
        raise ValueError(
            f"{prefix} is a format-{meta.get('serving_format', 1)} serving "
            f"bundle; this engine expects format 2 (the extend program "
            f"carries the folded zero-segment scatter): re-export with "
            f"cli.export --serving")
    return meta


def load_serving_params(prefix: str, meta: dict, device: torch.device):
    """``(state_dict, escalation state_dict or None)`` from the bundle's
    weight sidecars, on ``device``."""
    esc = None
    if meta["escalate"]:
        esc = load_params_sidecar(prefix + ".esc", meta["esc_params_model"],
                                  device)
    return load_params_sidecar(prefix, meta["params_model"], device), esc


def load_serving(prefix: str, *, device=None,
                 hbm_limit: Optional[int] = None,
                 gate_rms_dbfs: Optional[float] = None,
                 gate_score: float = 0.0,
                 escalate_band: Optional[float] = None,
                 escalate_center: Optional[float] = None,
                 extend_fastpath: bool = True):
    """A ``MultiStreamScorer`` on an :func:`export_serving` bundle, with no
    model code: built at the bundle's exact geometry, its dispatches
    replaced by the programs of ``device``'s platform. The programs are
    fixed-shape, so no sub-shape dispatch runs (``_subshape_ok = False``:
    no extend half/quarter rungs, score or escalation rungs); the
    zero-segment scatter alone, which needs no model, still runs eagerly.
    Host knobs (energy gate, escalation band and center, memory guard)
    stay configurable. Returns ``(engine, meta)``."""
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer

    dev = resolve_device(device)
    meta = read_serving_meta(prefix)
    state, esc_state = load_serving_params(prefix, meta, dev)
    dtype = getattr(torch, meta["model_dtype"])
    model = ArtifactModel(state, dtype, _w2v_config(meta["w2v_cfg"]))
    esc = None
    if esc_state is not None:
        esc = ArtifactModel(esc_state, getattr(torch, meta["esc_model_dtype"]),
                            _w2v_config(meta["esc_w2v_cfg"]))
    eng = MultiStreamScorer(
        model, model.w2v_cfg, duration=meta["duration"], hop=meta["hop"],
        max_streams=meta["max_streams"], seg_frames=meta["seg_frames"],
        ring_frames=meta["ring_frames"], extend_batch=meta["extend_batch"],
        score_batch=meta["score_batch"], esc_batch=meta["esc_batch"],
        esc_gather=meta.get("esc_gather", "slice"),
        extend_fastpath=extend_fastpath, escalate=esc,
        escalate_band=(meta["escalate_band"] if escalate_band is None
                       else escalate_band),
        escalate_center=(meta["escalate_center"] if escalate_center is None
                         else escalate_center),
        transport_dtype=meta["transport_dtype"], hbm_limit=hbm_limit,
        gate_rms_dbfs=gate_rms_dbfs, gate_score=gate_score)
    ext = load_program(prefix + ".extend", dev)
    sco = load_program(prefix + ".score", dev)
    conv_state = {k[len(FEATURE_EXTRACTOR):]: v for k, v in state.items()
                  if k.startswith(FEATURE_EXTRACTOR)}

    def extend(const_rows, segs, slots, pos, zslots, zpos):
        with torch.inference_mode():
            ext(conv_state, const_rows, eng._feats, eng._swave, segs, slots,
                pos, zslots, zpos)

    def score(slots, starts):
        with torch.inference_mode():
            return sco(state, eng._feats, slots, starts)

    eng._extend, eng._score = extend, score
    if esc is not None:
        esc_prog = load_program(prefix + ".escalate", dev)

        def score_esc(slots, starts):
            with torch.inference_mode():
                return esc_prog(esc_state, eng._swave, slots, starts)

        eng._score_esc = score_esc
    eng._subshape_ok = False
    eng.artifact_meta = meta
    return eng, meta


# ------------------------------------------------------------ the CLI

def main(argv=None):
    p = argparse.ArgumentParser(
        description="export a scoring model as torch.export programs")
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--batch", type=str, default="sym",
                   help='"sym" (symbolic, default) or a fixed batch size')
    p.add_argument("--duration_sec", type=float, default=None,
                   help="clip seconds (default: config test_duration_sec)")
    p.add_argument("--student", action="store_true",
                   help="export kd_kwargs.student_kwargs model "
                        "(sys_config.student_model) instead of the teacher")
    p.add_argument("--w8", action="store_true",
                   help="int8-quantize transformer weights first")
    p.add_argument("--w8a8", action="store_true",
                   help="w8 plus dynamic int8 activations")
    p.add_argument("--streaming", action="store_true",
                   help="export the incremental streaming scorer instead: "
                        "<out>.conv + <out>.score + <out>.json "
                        "(StreamingArtifact bundle)")
    p.add_argument("--hop_sec", type=float, default=None,
                   help="streaming hop seconds (default: duration/2)")
    p.add_argument("--seg_frames", type=int, default=256,
                   help="conv frames per extractor segment (streaming)")
    p.add_argument("--serving", action="store_true",
                   help="export the multi-stream serving engine's "
                        "dispatches instead: <out>.extend + <out>.score "
                        "(+ <out>.escalate with --cascade_ckpt) + weight "
                        "sidecars + <out>.json; cli.serve/cli.daemon "
                        "--artifact serve from the bundle with no model "
                        "code")
    p.add_argument("--max_streams", type=int, default=8,
                   help="serving: stream-slot count")
    p.add_argument("--transport", type=str, default="int16",
                   choices=("float32", "int16", "mulaw8"),
                   help="serving: sample transport dtype (baked into the "
                        "extend program)")
    p.add_argument("--score_batch", type=int, default=None,
                   help="serving: cap the window-score batch")
    p.add_argument("--extend_batch", type=int, default=None,
                   help="serving: cap the conv-extend batch")
    p.add_argument("--esc_batch", type=int, default=None,
                   help="serving: escalation dispatch batch")
    p.add_argument("--cascade_ckpt", type=str, default=None,
                   help="serving: screener checkpoint; the screener becomes "
                        "the engine's primary model and --ckpt the cascade "
                        "escalation flagship (as cli.serve)")
    p.add_argument("--cascade_config", type=str, default=None,
                   help="serving: screener config (default: --config)")
    p.add_argument("--cascade_w8a8", action="store_true",
                   help="serving: w8a8-quantize the screener transformer")
    p.add_argument("--cascade_band", type=float, default=None,
                   help="serving: escalation half-band baked into the "
                        "bundle (default 2.0)")
    p.add_argument("--cascade_center", type=float, default=None,
                   help="serving: escalation band center baked into the "
                        "bundle (default 0.0)")
    p.add_argument("--cascade_calibration", type=str, default=None,
                   help="serving: cascade band sidecar from 'cli.evaluate "
                        "--cascade-sweep --cascade-out'; bakes the dev-set "
                        "band/center into the bundle (explicit "
                        "--cascade_band/--cascade_center override it)")
    p.add_argument("--platforms", type=str, default=",".join(PLATFORMS),
                   help="comma-separated platforms to hold a program for "
                        "(cpu, cuda)")
    args = p.parse_args(argv)

    from rtdsd_tpu_torch.cli.common import load_eval_model
    from rtdsd_tpu_torch.config import load_yaml_config

    platforms = tuple(s.strip() for s in args.platforms.split(",") if s)
    _devices(platforms)                # a platform the machine lacks raises
    # weights load (and quantize) on the card when the bundle targets it
    device = torch.device("cuda" if "cuda" in platforms else "cpu")
    sys_config, exp_config = load_yaml_config(args.config)
    name = kwargs = None
    if args.student:
        kd = exp_config.kd_kwargs or {}
        name, kwargs = sys_config.student_model, kd.get("student_kwargs", {})
    spec = load_eval_model(sys_config, exp_config, args.ckpt, device,
                           w8=args.w8, w8a8=args.w8a8, name=name,
                           kwargs=kwargs)
    model = spec.module.eval()
    dur = (args.duration_sec if args.duration_sec is not None
           else exp_config.test_duration_sec)
    sr = exp_config.sample_rate
    num_samples = int(round(dur * sr))
    batch = None if args.batch == "sym" else int(args.batch)
    quant = "w8a8" if args.w8a8 else ("w8" if args.w8 else "none")

    if args.serving:
        hop = int(round(args.hop_sec * sr)) if args.hop_sec is not None \
            else None
        primary, primary_name = model, spec.name
        escalate = esc_name = None
        model_name = spec.name
        if args.cascade_ckpt:
            # as cli.serve: the screener is the engine's primary model,
            # --ckpt's model the escalation flagship
            screen_sys, screen_exp = (load_yaml_config(args.cascade_config)
                                      if args.cascade_config
                                      else (sys_config, exp_config))
            screener = load_eval_model(screen_sys, screen_exp,
                                       args.cascade_ckpt, device,
                                       w8a8=args.cascade_w8a8)
            escalate, esc_name = model, spec.name
            primary, primary_name = screener.module.eval(), screener.name
            model_name = f"{screener.name} -> {spec.name} cascade"
        band, center, esc_rate = args.cascade_band, args.cascade_center, None
        if args.cascade_calibration:
            import math

            from rtdsd_tpu_torch.utils.metrics import load_cascade_calibration

            cal = load_cascade_calibration(args.cascade_calibration)
            if band is None:
                band = float(cal["band"])
            if center is None:
                center = float(cal["center"])
            rate = cal.get("escalation_rate")
            if rate is not None and math.isfinite(float(rate)):
                esc_rate = float(rate)  # sizes the baked escalation chunk
            print(f"baking cascade band {band} around {center} from "
                  f"{args.cascade_calibration}"
                  + (f" (esc chunk sized for {esc_rate * 100:.1f}% "
                     f"escalation)" if esc_rate is not None else ""))
        ext, sco, esc, meta = export_serving(
            primary, primary.w2v_cfg, duration=num_samples, hop=hop,
            max_streams=args.max_streams, extend_batch=args.extend_batch,
            score_batch=args.score_batch, esc_batch=args.esc_batch,
            esc_rate=esc_rate, transport_dtype=args.transport,
            escalate=escalate,
            escalate_band=2.0 if band is None else band,
            escalate_center=0.0 if center is None else center,
            platforms=platforms)
        meta.update(model=model_name, ckpt=os.path.abspath(args.ckpt),
                    sample_rate=sr, quant=quant)
        save_serving(ext, sco, esc, args.out, meta, _state(primary),
                     primary_name,
                     None if escalate is None else _state(escalate),
                     esc_name)
        parts = ["extend", "score"] + (["escalate"] if esc else [])
        print(f"exported {model_name} serving -> {args.out}."
              f"{{{','.join(parts)},params,json}} (max_streams="
              f"{meta['max_streams']} extend={meta['extend_batch']} "
              f"score={meta['score_batch']} transport="
              f"{meta['transport_dtype']}, platforms={platforms})")
        return
    if args.streaming:
        hop = (int(round(args.hop_sec * sr)) if args.hop_sec is not None
               else None)
        convs, scores, meta = export_streaming(
            model, model.w2v_cfg, duration=num_samples, hop=hop,
            seg_frames=args.seg_frames, platforms=platforms)
        meta.update(model=spec.name, ckpt=os.path.abspath(args.ckpt),
                    duration_sec=dur, sample_rate=sr, quant=quant)
        save_streaming(convs, scores, args.out, meta, _state(model),
                       spec.name)
        sizes = tuple(os.path.getsize(args.out + ext)
                      for ext in (".conv", ".score", ".params"))
        print(f"exported {spec.name} streaming -> {args.out}.{{conv,score,"
              f"params,json}} ({sizes[0]}+{sizes[1]}+{sizes[2]} bytes, "
              f"platforms={platforms}, win={num_samples} hop={meta['hop']})")
        return

    programs = export_scorer(model, num_samples=num_samples, batch=batch,
                             platforms=platforms)
    save_exported(programs, args.out, {
        "model": spec.name,
        "ckpt": os.path.abspath(args.ckpt),
        "duration_sec": dur,
        "sample_rate": sr,
        "batch": "symbolic" if batch is None else batch,
        "quant": quant,
        "semantics": "score = bonafide logit, no pre-emphasis",
    }, _state(model), spec.name)
    print(f"exported {spec.name} -> {args.out} "
          f"({os.path.getsize(args.out)} bytes, platforms={platforms}, "
          f"batch={'sym' if batch is None else batch}, T={num_samples})")


if __name__ == "__main__":
    sys.exit(main())

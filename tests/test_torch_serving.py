"""The port's multi-stream serving engine (``engine/serving.py``) against
the JAX package's, on the CPU, at tests/test_serving.py's geometry (stride
40, 3200-sample windows, 1600-sample hop) on a tiny 2-layer XLSR_AASIST.

Weights are made with numpy from a seed on the JAX modules' shapes
(``_torch_track.random_variables``) and carried into the port by
``convert.from_jax_variables``. Each scenario pushes one seeded sequence
(irregular chunks, interleaved streams, flushes) through both engines:
the WindowScore sequences must agree poll for poll (stream, start,
``escalated`` and ``gated`` exactly; scores to tests/test_serving.py's
rtol 2e-4, atol 2e-5), and so must ``dispatch_counts``, ``rung_rows``,
``provisioning()``, ``zero_segments`` and ``gated_windows``. A JAX engine
compiles each of its dispatch shapes, so the scenarios are few, each run
once per module, and engines of one configuration share compilations.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_track import random_variables
from rtdsd_tpu.engine import serving as jax_serving
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu.models.quantize import quantize_encoder_params
from rtdsd_tpu_torch.engine import serving
from rtdsd_tpu_torch.models import convert, registry
from rtdsd_tpu_torch.models.quantize import quantize_state_dict

W2V = {"conv_layers": [[8, 10, 5], [8, 4, 4], [8, 2, 2]],
       "encoder_embed_dim": 8, "encoder_ffn_dim": 16, "encoder_heads": 2,
       "conv_pos": 4, "conv_pos_groups": 2}
NAME = "My_XLSR_AASIST"
DUR = 80 * 40                 # 3200 samples, 80 frames of stride 40
HOP = DUR // 2
TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_serving.py


def _pair(seed):
    """(JAX module, params, batch_stats, port module) of one tiny model
    with weights from ``seed``."""
    jax_mod = jax_registry.get_model(NAME, num_layers=2, w2v=W2V).module
    v = random_variables(jax_mod, np.zeros((1, DUR), np.float32), seed=seed,
                         train=False)
    port = registry.get_model(NAME, num_layers=2, w2v=W2V).module
    port.load_state_dict(convert.from_jax_variables(v, NAME), strict=True)
    return jax_mod, v["params"], v["batch_stats"], port.eval()


def _w8a8(pair):
    """The port module of ``pair`` with its transformer quantized (w8a8;
    round to nearest on the CPU)."""
    port = registry.get_model(NAME, num_layers=2,
                              w2v={**W2V, "w8": True, "a8": True}).module
    port.load_state_dict(quantize_state_dict(pair[3].state_dict()),
                         strict=True)
    return port.eval()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines' CPU work is thousands of tiny ops, which run fastest on
    one thread, and far slower with a full thread pool a worker each
    beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return {"primary": _pair(3), "flagship": _pair(5), "other": _pair(9)}


def _engine(models, kwargs, port):
    """One engine of a configuration, the port's or JAX's; an
    ``escalate`` key takes the flagship pair."""
    jax_mod, params, stats, module = models["primary"]
    kwargs = dict(kwargs)
    if kwargs.pop("escalate", None):
        f = models["flagship"]
        kwargs["escalate"] = f[3] if port else f[:3]
    if port:
        return serving.MultiStreamScorer(module, module.w2v_cfg, **kwargs)
    return jax_serving.MultiStreamScorer(jax_mod, params, stats,
                                         jax_mod.w2v_cfg, **kwargs)


def _engines(models, kwargs):
    """(JAX engine, port engine) of one configuration."""
    return _engine(models, kwargs, False), _engine(models, kwargs, True)


def _wave(rng, n, scale=0.1):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _interleaved(eng, waves, rng, chunk=(100, 1500), dtypes=None):
    """Push every stream's wave in irregular chunks, round by round,
    polling after each round -> [(poll index, WindowScore)]."""
    out, polls = [], [0]
    handles = {eng.open_stream(f"s{i}"): i for i in range(len(waves))}
    cursors = {h: 0 for h in handles}
    while any(cursors[h] < len(waves[i]) for h, i in handles.items()):
        for h, i in handles.items():
            c = cursors[h]
            if c < len(waves[i]):
                n = int(rng.integers(*chunk))
                piece = waves[i][c:c + n]
                if dtypes and dtypes[i] == "int16":
                    piece = np.clip(np.rint(piece * 32768.0), -32768,
                                    32767).astype(np.int16)
                eng.push(h, piece)
                cursors[h] = c + n
        out += [(polls[0], ws) for ws in eng.poll()]
        polls[0] += 1
    for h in handles:
        eng.close_stream(h, flush=True)
    out += [(-1, ws) for ws in eng.drain()]
    return out


# ------------------------------------------------------------- scenarios

def _flush_semantics(eng):
    """float32: a grid-length stream, a tail off the hop grid by 203
    samples (flushed twice), a stream shorter than a window pushed in two
    pieces (tiled into one window), a stream with no pushes (its slot
    reused at once), and int16 PCM pushed under the float32 transport."""
    rng = np.random.default_rng(7)
    a, b = _wave(rng, 3 * HOP + DUR), _wave(rng, 2 * HOP + DUR + 203)
    short, pcm = _wave(rng, DUR // 3 - 7), _wave(rng, 2 * HOP + DUR + 240)
    ha, hb, hs, hn = (eng.open_stream(s) for s in ("a", "b", "short", "none"))
    eng.close_stream(hn, flush=True)          # no samples: no window
    hp = eng.open_stream("pcm")
    assert hp == hn and eng.active_streams == 4
    out = []
    eng.push(hs, short[:100])
    eng.push(hs, short[100:])
    cur = 0
    for step, n in enumerate(rng.integers(300, 1400, size=12)):
        for h, w in ((ha, a), (hb, b), (hp, pcm)):
            piece = w[cur:cur + n]
            if h == hp:
                piece = np.clip(np.rint(piece * 32768.0), -32768,
                                32767).astype(np.int16)
            if len(piece):
                eng.push(h, piece)
        cur += n
        out += [(step, ws) for ws in eng.poll()]
    for h, w in ((ha, a), (hb, b), (hp, pcm)):
        if cur < len(w):
            eng.push(h, w[cur:])
    for h in (ha, hb, hs, hp):
        eng.close_stream(h, flush=True)
    eng.close_stream(hb, flush=True)          # a flush in progress: no-op
    with pytest.raises(RuntimeError, match="closing"):
        eng.push(ha, np.zeros(10, np.float32))
    return out + [(-1, ws) for ws in eng.drain()]


def _gated(eng):
    """[loud | exact silence | loud] beside a loud stream, both pushed
    whole: gated windows, the zero-segment fastpath, and a stream's scored
    and gated windows due in one poll (emitted in start order)."""
    rng = np.random.default_rng(31)
    gw = np.concatenate([_wave(rng, DUR), np.zeros(2 * DUR, np.float32),
                         _wave(rng, DUR)])
    hg, hl = eng.open_stream("g"), eng.open_stream("l")
    eng.push(hl, _wave(rng, 3 * HOP + DUR))
    eng.push(hg, gw)
    for h in (hg, hl):
        eng.close_stream(h, flush=True)
    out = []
    while True:
        got = eng.poll()
        if not (got or eng._last_poll_work):
            return out
        out += [(len(out), ws) for ws in got]


def _cascade(eng):
    """Two streams, one with an int16 PCM chunk, every window escalated."""
    rng = np.random.default_rng(23)
    return _interleaved(eng, [_wave(rng, 2 * HOP + DUR + 40),
                              _wave(rng, 3 * HOP + DUR)], rng,
                        dtypes=[None, "int16"])


def _hop_by_hop(eng):
    """One loud stream and one of exact zeros pushed a hop at a time over
    14 hops: one loud window due per poll (the zero stream's are gated),
    so with provision_after=4 the engine deepens its score and escalation
    ladders; the zero stream rides the const scatter and the live extend
    the quarter rung."""
    rng = np.random.default_rng(29)
    loud = _wave(rng, 12 * HOP + DUR)
    hl, hz = eng.open_stream("loud"), eng.open_stream("dtx")
    out = []
    for i in range(0, len(loud), HOP):
        eng.push(hl, loud[i:i + HOP])
        eng.push(hz, np.zeros(HOP, np.float32))
        out += [(i, ws) for ws in eng.poll()]
    eng.close_stream(hl, flush=True)
    eng.close_stream(hz, flush=True)
    return out + [(-1, ws) for ws in eng.drain()]


def _capped(eng):
    """At score_batch 1 and extend_batch 2: the flush semantics, then
    three streams pushed whole at once, a backlog drained by many bounded
    polls with the one score row handed round robin."""
    out = _flush_semantics(eng)
    rng = np.random.default_rng(37)
    hs = [eng.open_stream(f"s{i}") for i in range(3)]
    for h in hs:
        eng.push(h, _wave(rng, 4 * HOP + DUR))
    for p in range(12):
        out += [(("overload", p), ws) for ws in eng.poll()]
    for h in hs:
        eng.close_stream(h, flush=True)
    return out + [(("overload", -1), ws) for ws in eng.drain()]


SCENARIOS = {
    "float32_capped": (dict(duration=DUR, hop=HOP, max_streams=4,
                            extend_batch=2, score_batch=1), _capped),
    "int16_gate": (dict(duration=DUR, hop=HOP, max_streams=4,
                        transport_dtype="int16", gate_rms_dbfs=-50.0,
                        gate_score=-7.5), _gated),
    "mulaw8_cascade_flat": (dict(duration=DUR, hop=HOP, max_streams=4,
                                 transport_dtype="mulaw8", escalate=True,
                                 escalate_band=1e9, esc_gather="flat"),
                            _cascade),
    "cascade_slice_rungs": (dict(duration=DUR, hop=HOP, max_streams=4,
                                 transport_dtype="int16", score_batch=4,
                                 esc_batch=4, score_rungs=1, esc_rungs=1,
                                 escalate=True, escalate_band=1e9,
                                 gate_rms_dbfs=-50.0, provision_after=4),
                            _hop_by_hop),
}


def _run(eng, script):
    out = script(eng)
    return dict(out=out, counts=dict(eng.dispatch_counts),
                rows=dict(eng.rung_rows), prov=eng.provisioning(),
                zero=eng.zero_segments, gated=eng.gated_windows,
                active=eng.active_streams)


@pytest.fixture(scope="module")
def runs(models):
    """Each scenario through the JAX engine and the port's."""
    res = {}
    for name, (kwargs, script) in SCENARIOS.items():
        jax_eng, port_eng = _engines(models, kwargs)
        res[name] = (_run(jax_eng, script), _run(port_eng, script))
    return res


def _same_windows(got, want):
    key = lambda o: [(p, w.stream_id, w.start_sample, w.escalated, w.gated)
                     for p, w in o]
    assert key(got) == key(want)
    np.testing.assert_allclose([w.score for _, w in got],
                               [w.score for _, w in want], **TOL)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_matches_jax(runs, name):
    """The WindowScore sequence poll for poll, and the engine's counters,
    against the JAX engine's."""
    want, got = runs[name]
    _same_windows(got["out"], want["out"])
    for k in ("counts", "rows", "prov", "zero", "gated", "active"):
        assert got[k] == want[k], k
    assert got["active"] == 0 and got["out"]


def test_scenarios_exercise_their_paths(runs):
    """What each scenario is there for did happen."""
    out = {k: [w for _, w in v[1]["out"]] for k, v in runs.items()}
    flush = out["float32_capped"]
    per = {s: [w.start_sample for w in flush if w.stream_id == s]
           for s in ("a", "b", "short", "none", "pcm")}
    assert per["short"] == [0] and per["none"] == []
    assert per["a"] == [i * HOP for i in range(4)]
    tail = 2 * HOP + 203 - 203 % 40          # snapped to the frame grid
    assert per["b"] == [0, HOP, 2 * HOP, tail]
    assert per["pcm"][-1] == 2 * HOP + 240
    gated = runs["int16_gate"][1]
    assert gated["gated"] >= 2 and gated["zero"] > 0
    g = [w for w in out["int16_gate"] if w.stream_id == "g"]
    assert any(w.gated and w.score == -7.5 for w in g)
    for s in ("g", "l"):     # per-stream emission order, unsorted output
        starts = [w.start_sample for w in out["int16_gate"]
                  if w.stream_id == s]
        assert starts == sorted(starts)
    for name in ("mulaw8_cascade_flat", "cascade_slice_rungs"):
        assert all(w.escalated != w.gated for w in out[name])
        assert sum(w.escalated for w in out[name]) >= 8
    rungs = runs["cascade_slice_rungs"][1]
    assert rungs["prov"]["score"] == rungs["prov"]["escalate"] == [4, 2, 1]
    assert rungs["prov"]["auto_budget_left"] < 6
    assert rungs["counts"]["extend_quarter"] > 0 and rungs["zero"] > 0
    assert sum(rungs["counts"][k] for k in rungs["counts"]
               if k.startswith("score_")) > 0
    overload = [(p[1], w) for p, w in runs["float32_capped"][1]["out"]
                if isinstance(p, tuple)]
    first = [w.stream_id for p, w in overload if p >= 0][:3]
    assert sorted(first) == ["s0", "s1", "s2"]        # round robin
    assert len(overload) == 3 * 5


@pytest.mark.parametrize("name", ["int16_gate", "cascade_slice_rungs"])
def test_zero_segment_fastpath_bit_exact(models, name):
    """On the CPU the fastpath (precomputed conv(0) rows, the extend
    ladder) gives the plain engine's scores bit for bit; on the card
    cuDNN may choose another algorithm at another batch shape."""
    kwargs, script = SCENARIOS[name]
    kwargs = {**kwargs, "auto_provision": False, "score_rungs": 0,
              "esc_rungs": 0}
    outs = []
    for fast in (False, True):
        eng = _engine(models, {**kwargs, "extend_fastpath": fast}, True)
        outs.append(_run(eng, script))
    ref, got = outs
    assert got["zero"] > 0 and ref["zero"] == 0
    assert [w.score for _, w in got["out"]] == [w.score for _, w in ref["out"]]
    assert ([(w.start_sample, w.gated) for _, w in got["out"]]
            == [(w.start_sample, w.gated) for _, w in ref["out"]])


def test_esc_gather_forms_agree(models):
    """``slice`` and ``flat`` gather the same samples: equal scores."""
    kwargs, script = SCENARIOS["mulaw8_cascade_flat"]
    scores = []
    for form in ("slice", "flat"):
        eng = _engine(models, {**kwargs, "esc_gather": form}, True)
        scores.append([w.score for _, w in script(eng)])
    assert scores[0] == scores[1]


# ------------------------------------------------------------ hot swap

def _swap_script(eng):
    rng = np.random.default_rng(13)
    return _interleaved(eng, [_wave(rng, 2 * HOP + DUR)], rng)


def _swap_sd(pair):
    return {k: v.clone() for k, v in pair[3].state_dict().items()}


def _check_swap_errors(eng, sd, extra=()):
    """A state dict with a missing key or a wrong shape (and ``extra``
    (state dict, message) pairs) raise ValueError naming the key; a swap
    that raises counts nothing."""
    key = next(k for k in sd if k.endswith("post_extract_proj.weight"))
    swaps = eng.model_swaps
    for state, match in [({k: v for k, v in sd.items() if k != key},
                          "missing"),
                         ({**sd, key: sd[key][:, :-1]}, "is \\(8, 7\\)"),
                         *extra]:
        with pytest.raises(ValueError, match=match):
            eng.swap_model(state)
    if not eng._escalate:
        with pytest.raises(ValueError, match="without a cascade"):
            eng.swap_model(sd, escalate=sd)
    assert eng.model_swaps == swaps


@pytest.mark.parametrize("case", ["float", "flagship"])
def test_swap_model_matches_jax(models, case):
    """A swap before the first push: every window is the new model's, as
    in JAX; a flagship swap through ``escalate=``. Swaps that raise leave
    the engine serving as before."""
    # the scenarios' configurations, so that JAX compiles little anew
    kwargs = SCENARIOS["mulaw8_cascade_flat" if case == "flagship"
                       else "float32_capped"][0]
    jax_eng, port_eng = _engines(models, kwargs)
    new = models["other"]
    if case == "flagship":
        jax_eng.swap_model(models["primary"][1], models["primary"][2],
                           escalate=new[1:3])
        port_eng.swap_model(_swap_sd(models["primary"]),
                            escalate=_swap_sd(new))
    else:
        jax_eng.swap_model(new[1], new[2])
        port_eng.swap_model(_swap_sd(new))
    assert port_eng.model_swaps == jax_eng.model_swaps == 1
    want, got = _swap_script(jax_eng), _swap_script(port_eng)
    _same_windows(got, want)
    _check_swap_errors(port_eng, _swap_sd(new))
    _same_windows(_swap_script(port_eng), got)


def test_swap_model_w8a8(models):
    """w8a8 state dicts swap in: the swapped engine gives, bit for bit,
    the windows of an engine built on the new quantized weights (JAX
    parity of the w8a8 model itself is tests/test_torch_quant.py's); a
    float state dict raises."""
    kwargs = SCENARIOS["float32_capped"][0]
    primary, other = _w8a8(models["primary"]), _w8a8(models["other"])
    eng = serving.MultiStreamScorer(primary, primary.w2v_cfg, **kwargs)
    eng.swap_model({k: v.clone() for k, v in other.state_dict().items()})
    fresh = serving.MultiStreamScorer(other, other.w2v_cfg, **kwargs)
    got, want = _swap_script(eng), _swap_script(fresh)
    assert [(p, w) for p, w in got] == [(p, w) for p, w in want]
    assert eng.model_swaps == 1
    _check_swap_errors(eng, other.state_dict(),
                       [(_swap_sd(models["other"]), "is (missing|unexpected)")])
    assert _swap_script(eng) == got


# ------------------------------------------------- sizing and memory guard

GUARD = [
    dict(max_streams=8),
    dict(max_streams=8, score_batch=1, extend_batch=1, esc_batch=1),
    dict(max_streams=8, score_batch=2),
    dict(max_streams=8, score_batch=2, extend_batch=4),
    dict(max_streams=32, escalate=True),
    dict(max_streams=32, escalate=True, esc_rate=0.1),
    dict(max_streams=32, escalate=True, esc_rate=0.5),
    dict(max_streams=32, escalate=True, esc_rate=0.0),
    dict(max_streams=32, escalate=True, esc_rate=1.0),
    dict(max_streams=32, escalate=True, esc_rate=0.1, esc_batch=16),
    dict(max_streams=32, escalate=True, esc_rate=0.5, score_batch=16),
    dict(max_streams=8, transport_dtype="mulaw8", seg_frames=20),
]


def _sizes(eng):
    return (eng.score_batch, eng.extend_batch, eng.esc_batch,
            eng.ring_frames, eng.seg_frames, eng.seg_samples, eng.win_frames)


def _close_estimates(port, jax_est):
    """The port counts the models' parameters and buffers where JAX counts
    its params and batch_stats trees. The two hold the same weights and
    statistics, and the port's BatchNorm layers add an 8-byte
    ``num_batches_tracked`` each (120 bytes for this model); the rest of
    the formula is JAX's. Within 1%."""
    assert abs(port - jax_est) <= 0.01 * jax_est, (port, jax_est)


@pytest.mark.parametrize("kwargs", GUARD)
def test_batch_sizing_matches_jax(models, kwargs, capsys):
    """Batch sizes (esc_rate sizing among them) and the JAX formula's part
    of the memory estimate, with the guard off (hbm_limit=0), against JAX's
    engine; the estimate the guard reads adds the port's eager term."""
    jax_eng, port_eng = _engines(models, dict(duration=DUR, hbm_limit=0,
                                              **kwargs))
    assert _sizes(port_eng) == _sizes(jax_eng)
    _close_estimates(port_eng.hbm_estimate_jax, jax_eng.hbm_estimate)
    assert port_eng.hbm_estimate == (port_eng.hbm_estimate_jax
                                     + port_eng.hbm_estimate_eager)


def _limit_cases(models, port):
    """(name, engine kwargs) whose hbm_limit sits between two estimates of
    the engine's own (the port's with its eager term, JAX's), as
    tests/test_serving.py sets them, and 4 KiB clear of each (the port's
    JAX part is 120 bytes above JAX's here)."""
    def est(**kw):
        return _engine(models, dict(duration=DUR, hbm_limit=0, **kw),
                       port).hbm_estimate
    full, floor = est(max_streams=8), est(max_streams=8, score_batch=1,
                                         extend_batch=1, esc_batch=1)
    capped = est(max_streams=8, score_batch=2, extend_batch=2)
    wide = est(max_streams=8, score_batch=2, extend_batch=8)
    target = est(max_streams=8, score_batch=4, extend_batch=8)
    efull = est(max_streams=8, escalate=True)
    efloor = est(max_streams=8, score_batch=1, extend_batch=1, esc_batch=1,
                 escalate=True)
    return [
        ("shrink", dict(max_streams=8, hbm_limit=(floor + full) // 2,
                        auto_batch=True)),
        ("uncap", dict(max_streams=8, score_batch=2, hbm_limit=wide + 4096)),
        ("keep cap", dict(max_streams=8, score_batch=2,
                          hbm_limit=(capped + wide) // 2)),
        ("explicit", dict(max_streams=8, score_batch=2, extend_batch=4,
                          hbm_limit=wide + 4096)),
        ("shrink then uncap", dict(max_streams=8, hbm_limit=target + 4096,
                                   auto_batch=True)),
        ("esc rate shrink", dict(max_streams=8, escalate=True, esc_rate=0.5,
                                 auto_batch=True,
                                 hbm_limit=(efloor + efull) // 2)),
    ]


def test_memory_guard_matches_jax(models, capsys):
    """With hbm_limit injected, each engine's limits placed between its own
    estimates: auto_batch's halving, the extend uncap (and its notice when
    the limit is unknown), and the ValueError with .hbm_estimate /
    .hbm_limit give the batch sizes of JAX's engine."""
    cases = zip(_limit_cases(models, False), _limit_cases(models, True))
    for (name, jax_kw), (_, port_kw) in cases:
        jax_eng = _engine(models, dict(duration=DUR, **jax_kw), False)
        port_eng = _engine(models, dict(duration=DUR, **port_kw), True)
        assert _sizes(port_eng) == _sizes(jax_eng), name
        _close_estimates(port_eng.hbm_estimate_jax, jax_eng.hbm_estimate)
        assert port_eng.hbm_estimate <= port_kw["hbm_limit"], name
        assert jax_eng.hbm_estimate <= jax_kw["hbm_limit"], name
    capsys.readouterr()
    jax_eng, port_eng = _engines(models, dict(duration=DUR, max_streams=8,
                                              score_batch=2))
    assert port_eng.extend_batch == jax_eng.extend_batch == 2
    assert "capped extend_batch at 2" in capsys.readouterr().err
    for kw, shrunk in ((dict(), dict()),
                       (dict(auto_batch=True),
                        dict(score_batch=1, extend_batch=1))):
        errors = []
        for port in (True, False):
            with pytest.raises(ValueError, match="GiB HBM") as e:
                _engine(models, dict(duration=DUR, max_streams=4,
                                     hbm_limit=1000, **kw), port)
            errors.append(e.value)
        assert errors[0].hbm_limit == errors[1].hbm_limit == 1000
        ref = _engine(models, dict(duration=DUR, max_streams=4, hbm_limit=0,
                                   **shrunk), True)
        assert errors[0].hbm_estimate == ref.hbm_estimate
        _close_estimates(ref.hbm_estimate_jax, errors[1].hbm_estimate)


# Hand arithmetic of the eager term on the tiny model (conv layers (8, 10,
# 5), (8, 4, 4), (8, 2, 2); ffn 16; 3200-sample windows of (3200 - 45) //
# 40 + 1 = 79 frames). An extend row is a
# 1605-sample segment (40 frames of stride 40 plus the 45-sample receptive
# field less one stride), whose largest conv output is layer 1's
# (1605 - 10) // 5 + 1 = 320 frames x 8 channels; an escalated row is the
# 3200-sample window, 639 x 8. float32 counts F.layer_norm's copy (1 f32
# temporary an element) in the front-end and nothing in the transformer;
# bf16 counts the rational GELU's 6, in the front-end and over the 79 x 16
# feed-forward activations.
EAGER_CASES = [
    ("float32, extend", "float32", dict(max_streams=8),
     8 * 320 * 8 * 4 * 1),
    ("bf16, extend", "bfloat16", dict(max_streams=8), 8 * 320 * 8 * 4 * 6),
    ("bf16, score", "bfloat16", dict(max_streams=8, extend_batch=1),
     8 * 79 * 16 * 4 * 6),
    ("bf16, escalation", "bfloat16",
     dict(max_streams=8, escalate=True, esc_batch=8), 8 * 639 * 8 * 4 * 6),
]


@pytest.mark.parametrize("case", EAGER_CASES, ids=[c[0] for c in EAGER_CASES])
def test_eager_term_by_hand(case):
    """The port's eager term, the largest dispatch's rows x the f32
    temporaries of its row, against hand arithmetic."""
    _, dtype, kwargs, want = case
    kwargs = dict(kwargs)

    def module():
        return registry.get_model(NAME, num_layers=2, w2v=W2V,
                                  dtype=getattr(torch, dtype)).module.eval()

    primary = module()
    if kwargs.pop("escalate", False):
        kwargs["escalate"] = module()
    eng = serving.MultiStreamScorer(primary, primary.w2v_cfg, duration=DUR,
                                    hbm_limit=0, **kwargs)
    assert eng.hbm_estimate_eager == want
    assert eng.hbm_estimate == eng.hbm_estimate_jax + want


def test_process_memory_limit(monkeypatch):
    """The CUDA limit is what the process can hold: the card's free
    memory plus the caching allocator's reservations, at most the card's
    total; the CUDA path of _device_hbm_bytes reads exactly that."""
    gib = 2 ** 30
    assert serving.process_memory_limit(60 * gib, 2 * gib, 80 * gib) \
        == 62 * gib
    assert serving.process_memory_limit(0, 5 * gib, 80 * gib) == 5 * gib
    assert serving.process_memory_limit(79 * gib, 3 * gib, 80 * gib) \
        == 80 * gib
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (40 * gib, 80 * gib))
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: 3 * gib)
    monkeypatch.setenv("RTDSD_HBM_GB", "7.5")
    assert serving._device_hbm_bytes(torch.device("cuda")) == 43 * gib


def test_probe_and_sidecar_match_jax(tmp_path, monkeypatch):
    """probe_hbm_bytes with an injected allocator (monotone ascent, the
    max_gb cap, a dead device), the sidecar it records and the env
    override, read as JAX reads them on the CPU."""
    true_limit = int(13.3 * 2 ** 30)

    def make_alloc():
        state = {"used": 0, "poisoned": False}

        def alloc():
            if state["poisoned"] or state["used"] + 2 ** 30 > true_limit:
                state["poisoned"] = True
                raise RuntimeError("out of memory")
            state["used"] += 2 ** 30
            return object()
        return alloc

    for mod in (serving, jax_serving):
        assert mod.probe_hbm_bytes(alloc=make_alloc()) == 13 * 2 ** 30
        assert mod.probe_hbm_bytes(max_gb=4.0, alloc=lambda: object()) \
            == 4 * 2 ** 30

        def dead():
            raise RuntimeError("out of memory")
        with pytest.raises(RuntimeError, match="GiB"):
            mod.probe_hbm_bytes(alloc=dead)
    path = str(tmp_path / "hbm.json")
    monkeypatch.setenv("RTDSD_HBM_LIMIT_FILE", path)
    monkeypatch.delenv("RTDSD_HBM_GB", raising=False)
    assert serving.hbm_limit_file_path() == jax_serving.hbm_limit_file_path()
    rec = serving.probe_hbm_bytes(alloc=make_alloc(), record=True,
                                  device="cpu")
    assert json.load(open(path)) == {"bytes": rec, "device_kind": "cpu"}
    cpu = torch.device("cpu")
    assert serving._device_hbm_bytes(cpu) == jax_serving._device_hbm_bytes() \
        == rec
    monkeypatch.setenv("RTDSD_HBM_GB", "7.5")
    assert serving._device_hbm_bytes(cpu) == jax_serving._device_hbm_bytes() \
        == int(7.5 * 2 ** 30)
    monkeypatch.delenv("RTDSD_HBM_GB")
    json.dump({"bytes": 123, "device_kind": "TPU v9"}, open(path, "w"))
    assert serving._device_hbm_bytes(cpu) is None
    assert jax_serving._device_hbm_bytes() is None


# ------------------------------------------------------ host-side helpers

def test_mulaw_matches_jax():
    """The encoder bit for bit; the decoder over every int8 code within
    two float32 ulps, -128 clamped to -1 as in JAX. Two, not one:
    ``torch.expm1`` and XLA's float32 expm1 differ by two ulps on their
    own at some of these inputs (codes +-1, +-2 and +-7)."""
    x = np.concatenate([np.linspace(-1.2, 1.2, 4001),
                        np.random.default_rng(0).standard_normal(2000) * 0.05]
                       ).astype(np.float32)
    codes = serving.mulaw_encode(x)
    np.testing.assert_array_equal(codes, jax_serving.mulaw_encode(x))
    assert codes.dtype == np.int8
    q = np.arange(-128, 128, dtype=np.int8)
    got = serving.mulaw_decode(torch.from_numpy(q)).numpy()
    want = np.asarray(jax_serving.mulaw_decode(jnp.asarray(q)))
    assert got.dtype == np.float32 and got[0] == got[1] == -1.0
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2 and np.mean(ulps <= 1) > 0.95


@pytest.mark.parametrize("full,rungs,prefix", [
    (512, 2, "extend"), (24, 3, "score"), (4, 3, "extend"), (64, 4, "x"),
    (64, 0, "x"), (1, 2, "escalate"), (7, 5, "score")])
def test_shape_ladder_matches_jax(full, rungs, prefix):
    assert serving._shape_ladder(full, rungs, prefix) == \
        jax_serving._shape_ladder(full, rungs, prefix, 1)


def test_dispatch_detail_keys_match_jax():
    counts = {"extend": 1, "extend_const": 2, "score": 3, "escalate": 4,
              "extend_half": 5, "extend_quarter": 6, "score_half": 7,
              "escalate_half": 8, "escalate_quarter": 9,
              "escalate_eighth": 10, "escalate_1_16": 11, "other": 12}
    assert serving.dispatch_detail_keys(counts) == \
        jax_serving.dispatch_detail_keys(counts)


BAD = [
    (dict(duration=DUR, hop=HOP + 1), "multiples"),
    (dict(duration=DUR, hop=2 * DUR), "must not exceed"),
    (dict(duration=DUR, ring_frames=100), "ring_frames 100 < minimum"),
    (dict(duration=DUR, transport_dtype="int8"), "transport_dtype"),
    (dict(duration=DUR, gate_rms_dbfs=3.0), "dBFS"),
    (dict(duration=DUR, esc_gather="rows"), "esc_gather"),
    (dict(duration=DUR, escalate=True, esc_rate=1.5), "esc_rate"),
]


@pytest.mark.parametrize("kwargs,match", BAD)
def test_rejects_bad_configuration_as_jax(models, kwargs, match):
    errors = []
    for port in (False, True):
        with pytest.raises(ValueError, match=match) as e:
            _engine(models, dict(hbm_limit=0, **kwargs), port)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_rejects_group_norm_and_lifecycle_errors(models):
    port = registry.get_model(NAME, num_layers=2, w2v={
        **W2V, "extractor_mode": "group_norm"}).module
    with pytest.raises(ValueError, match="layer_norm"):
        serving.MultiStreamScorer(port, port.w2v_cfg, duration=DUR)
    eng = _engine(models, dict(duration=DUR, max_streams=2), True)
    a = eng.open_stream("a")
    eng.open_stream("b")
    with pytest.raises(RuntimeError, match="busy"):
        eng.open_stream("c")
    eng.close_stream(a)
    assert not eng.is_open(a) and eng.pending_samples(a) == 0
    c = eng.open_stream("c")
    eng.push(c, np.zeros(100, np.float32))
    assert eng.is_open(c) and eng.pending_samples(c) == 100
    with pytest.raises(KeyError):
        eng.push(99, np.zeros(10, np.float32))

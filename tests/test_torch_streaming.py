"""Streaming of the port (``engine/streaming.py``, ``cli/stream.py``) and
the encoder's ``conv_feats`` entry and ``return_hiddens``, against the JAX
package's, on the CPU, at a tiny size.

Weights are made with numpy from a seed on the JAX modules' shapes
(``_torch_track.random_variables``: no init is compiled) and carried into
the port by ``convert.from_jax_variables``; the CLI tests use the tiny
Conformer ``.pt`` of ``_torch_track.make_conformer`` and run
``rtdsd_tpu.cli.stream`` in process. Tolerances: float32 modules and whole models to 1e-4, as
tests/test_torch_models.py holds them; the scorers at
tests/test_streaming.py's own geometry and tolerance (rtol 2e-4, atol
2e-5); the ``--w8a8`` CLI as tests/test_torch_quant.py holds it.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_track import make_conformer, random_variables, write_track
from rtdsd_tpu.cli import stream as jax_cli
from rtdsd_tpu.engine import streaming as jax_streaming
from rtdsd_tpu.engine.steps import make_score_step as jax_score_step
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from rtdsd_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from rtdsd_tpu_torch.cli import stream as port_cli
from rtdsd_tpu_torch.data.io import write_wav
from rtdsd_tpu_torch.engine import steps, streaming
from rtdsd_tpu_torch.models import convert, registry, wav2vec2

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
TOL = dict(rtol=1e-4, atol=1e-4)          # float32, tests/test_torch_models.py
STREAM_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_streaming.py


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _apply(module, variables, *args, **kw):
    """A flax eval forward, jitted, outputs as float32 numpy."""
    out = jax.jit(lambda v, *a: module.apply(v, *a, **kw))(
        variables, *(None if a is None else jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(lambda o: np.asarray(o, np.float32), out)


def _models(name, w2v, seed, samples, **head):
    """(JAX module, numpy variables, port module) of one tiny 2-layer model."""
    kwargs = {"num_layers": 2, "w2v": w2v, **head}
    jax_mod = jax_registry.get_model(name, **kwargs).module
    v = random_variables(jax_mod, np.zeros((1, samples), np.float32),
                         seed=seed, train=False)
    port = registry.get_model(name, **kwargs).module
    port.load_state_dict(convert.from_jax_variables(v, name), strict=True)
    return jax_mod, v, port.eval()


# ------------------------------------------------------------ window geometry

@pytest.mark.parametrize("t,duration,hop", [
    (30, 40, 30),        # shorter than a window: tiled into one
    (40, 40, 30),        # exactly one window
    (100, 40, 30),       # the hop grid reaches the end
    (105, 40, 30),       # a tail window off the hop grid
    (120, 40, 40),       # hop = duration
    (7300, 1000, 500),   # tests/test_streaming.py's tail case
])
def test_frame_windows_match_jax(t, duration, hop):
    wave = np.random.default_rng(t).standard_normal(t).astype(np.float32)
    assert (streaming.frame_starts(t, duration, hop)
            == jax_streaming.frame_starts(t, duration, hop))
    got = streaming.frame_windows(wave, duration, hop)
    np.testing.assert_array_equal(
        got, jax_streaming.frame_windows(wave, duration, hop))
    assert got.shape == (len(streaming.frame_starts(t, duration, hop)),
                         duration)


def test_receptive_field_matches_jax():
    cfg = JaxW2VConfig()
    assert streaming.receptive_field(cfg.conv_layers) == \
        jax_streaming.receptive_field(cfg.conv_layers) == 400


# ---------------------------------------------------- encoder entry points

@pytest.mark.parametrize("layer_norm_first", [True, False])
def test_return_hiddens_match_jax(layer_norm_first):
    """(x, hiddens (L, B, T, D)), each layer's output before the final
    LayerNorm; the default call stays what ``x`` is, bit for bit."""
    waves = (np.random.default_rng(2).standard_normal((2, 8000)) * 0.3
             ).astype(np.float32)
    mod = JaxEncoder(JaxW2VConfig(encoder_layers=2,
                                  layer_norm_first=layer_norm_first, **W2V))
    v = random_variables(mod, waves, seed=2, train=False)
    want_x, want_h = _apply(mod, v, waves, train=False, return_hiddens=True)
    enc = wav2vec2.Wav2Vec2Encoder(wav2vec2.make_w2v_cfg(
        2, layer_norm_first=layer_norm_first, **W2V))
    enc.load_state_dict(convert._w2v(v["params"], ""), strict=True)
    with torch.inference_mode():
        x, hiddens = enc.eval()(torch.from_numpy(waves), return_hiddens=True)
        plain = enc(torch.from_numpy(waves))
    assert hiddens.shape == want_h.shape == (2, 2, 199, 32)
    for layer in range(2):
        np.testing.assert_allclose(hiddens[layer].numpy(), want_h[layer], **TOL)
    np.testing.assert_allclose(x.numpy(), want_x, **TOL)
    assert torch.equal(plain, x)
    # with layer_norm_first the final LayerNorm comes after the last hidden
    assert layer_norm_first != torch.allclose(hiddens[-1], x)


@pytest.mark.parametrize("name,head", [
    ("My_XLSR_AASIST", {}),
    ("My_XLSR_Conformer", {"emb_size": 16, "heads": 4, "kernel_size": 16,
                           "n_encoders": 2}),
])
def test_conv_feats_logits_match_jax(name, head):
    """``model(None, conv_feats=...)`` against JAX's, float32; in the port,
    ``model(wave)`` is ``model(None, conv_feats=extractor(wave))``."""
    waves = (np.random.default_rng(4).standard_normal((2, 8000)) * 0.3
             ).astype(np.float32)
    jax_mod, v, port = _models(name, dict(W2V), 4, 8000, **head)
    with torch.inference_mode():
        feats = port.ssl_model.model.feature_extractor(torch.from_numpy(waves))
        got = port(None, conv_feats=feats)
        whole = port(torch.from_numpy(waves))
    assert feats.shape == (2, 199, 32)
    want = _apply(jax_mod, v, None, train=False, conv_feats=feats.numpy())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, whole)


# ------------------------------------------------------------------ scorers

@pytest.fixture(scope="module")
def geometry():
    """tests/test_streaming.py's incremental-scorer geometry (stride 40,
    duration 80 strides, hop 40, 200 strides of audio, seg_frames 50) on a
    tiny XLSR_AASIST, batch 3 so the last batch is ragged: the JAX
    scorers' window scores, and the port's scorers."""
    w2v = {"conv_layers": [[8, 10, 5], [8, 4, 4], [8, 2, 2]],
           "encoder_embed_dim": 8, "encoder_ffn_dim": 16,
           "encoder_heads": 2, "conv_pos": 4, "conv_pos_groups": 2}
    stride = 40
    duration, hop = 80 * stride, 40 * stride
    jax_mod, v, port = _models("My_XLSR_AASIST", w2v, 3, duration)
    assert port.w2v_cfg.total_stride == stride
    rng = np.random.default_rng(3)
    waves = {"grid": rng.standard_normal(200 * stride).astype(np.float32),
             "tail": rng.standard_normal(200 * stride + 100).astype(np.float32)}
    waves["short"] = waves["grid"][: duration // 2]
    kw = dict(duration=duration, hop=hop, batch_size=3)
    naive = jax_streaming.StreamingScorer(jax_score_step(jax_mod), v["params"],
                                          v["batch_stats"], **kw)
    inc = jax_streaming.IncrementalStreamingScorer(
        jax_mod, v["params"], v["batch_stats"], jax_mod.w2v_cfg,
        seg_frames=50, **kw)
    jax_ws = {(k, "naive"): naive.window_scores(w) for k, w in waves.items()}
    jax_ws.update({(k, "inc"): inc.window_scores(waves[k])
                   for k in ("grid", "short")})
    scorers = {"naive": streaming.StreamingScorer(
                   steps.make_score_step(port), device="cpu", **kw),
               "inc": streaming.IncrementalStreamingScorer(
                   port, port.w2v_cfg, seg_frames=50, **kw)}
    return dict(waves=waves, jax=jax_ws, jax_naive=naive, jax_inc=inc,
                scorers=scorers)


@pytest.mark.parametrize("wave", ["grid", "tail", "short"])
def test_streaming_scorer_matches_jax(geometry, wave):
    """Window scores, a ragged last batch included, their starts, and the
    four aggregates; an unknown aggregate raises, as in JAX."""
    scorer = geometry["scorers"]["naive"]
    ws = scorer.window_scores(geometry["waves"][wave])
    want = geometry["jax"][wave, "naive"]
    assert ws.dtype == np.float32 and ws.shape == want.shape
    assert len(ws) == {"grid": 4, "tail": 5, "short": 1}[wave]
    t = len(geometry["waves"][wave])
    assert (scorer.window_starts(t)
            == jax_streaming.frame_starts(t, scorer.duration, scorer.hop))
    assert len(scorer.window_starts(t)) == len(ws)
    np.testing.assert_allclose(ws, want, **TOL)
    jax_naive = geometry["jax_naive"]
    for agg in ("mean", "min", "max", "median"):
        scorer.aggregate = jax_naive.aggregate = agg
        np.testing.assert_allclose(scorer.aggregate_scores(ws),
                                   jax_naive.aggregate_scores(want), **TOL)
    assert scorer.score(geometry["waves"][wave]) == scorer.aggregate_scores(ws)
    for s in (scorer, jax_naive):
        s.aggregate = "mode"
        with pytest.raises(ValueError, match="unknown aggregate 'mode'"):
            s.aggregate_scores(ws)
        s.aggregate = "mean"


@pytest.mark.parametrize("wave", ["grid", "short"])
def test_incremental_scorer_matches_jax_and_naive(geometry, wave):
    """The incremental scorer against JAX's and against the port's naive
    scorer, at tests/test_streaming.py's tolerance, on grid-aligned windows
    and on a short (tiled) input."""
    inc = geometry["scorers"]["inc"]
    ws = inc.window_scores(geometry["waves"][wave])
    np.testing.assert_allclose(ws, geometry["jax"][wave, "inc"], **STREAM_TOL)
    np.testing.assert_allclose(
        ws, geometry["scorers"]["naive"].window_scores(geometry["waves"][wave]),
        **STREAM_TOL)
    assert inc.bucket_key(len(geometry["waves"][wave])) == 4


def test_incremental_grid_starts_and_buckets_match_jax(geometry):
    """Snapped, deduplicated window starts and segment buckets, over
    lengths on and off the grid, short and long."""
    port, jax_inc = geometry["scorers"]["inc"], geometry["jax_inc"]
    for t in (100, 3200, 3201, 8000, 8100, 9999, 20000, 123457):
        assert port.window_starts(t) == jax_inc._grid_starts(t)
        assert port.bucket_key(t) == jax_inc.bucket_key(t)


def test_incremental_scorer_raises_as_jax():
    """The group_norm extractor and a hop below the conv stride raise, with
    JAX's messages."""
    w2v = {**W2V, "extractor_mode": "group_norm"}
    port = registry.get_model("My_XLSR_AASIST", num_layers=2, w2v=w2v).module
    jax_cfg = JaxW2VConfig(extractor_mode="group_norm")
    errors = []
    for make in (lambda: streaming.IncrementalStreamingScorer(
                     port, port.w2v_cfg, duration=8000),
                 lambda: jax_streaming.IncrementalStreamingScorer(
                     None, {}, {}, jax_cfg, duration=8000)):
        with pytest.raises(ValueError, match="layer_norm extractor") as e:
            make()
        errors.append(str(e.value))
    port = registry.get_model("My_XLSR_AASIST", num_layers=2,
                              w2v=dict(W2V)).module
    for make in (lambda: streaming.IncrementalStreamingScorer(
                     port, port.w2v_cfg, duration=8000, hop=39),
                 lambda: jax_streaming.IncrementalStreamingScorer(
                     None, {}, {}, JaxW2VConfig(
                         conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2),
                                      (32, 2, 2))), duration=8000, hop=39)):
        with pytest.raises(ValueError, match="below the conv frame stride") as e:
            make()
        errors.append(str(e.value))
    assert errors[0] == errors[1] and errors[2] == errors[3]


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def track(tmp_path_factory):
    """The tiny Conformer .pt and config of tests/_torch_track.py, three
    audio files (a tail off the hop grid; shorter than a window; 22.05 kHz)
    and a calibration file. All three fall in one segment bucket, so each
    incremental run warms one bucket.

    The CLI is held on the Conformer: the AASIST head pairs the kept nodes
    of its two branches by their pooling rank (``torch.maximum(out_t1,
    out_t2)``), so where two pooling scores are within summation-order
    noise of each other a score moves by 1e-3 (seen with the AASIST of
    ``make_track`` on the 2.3 s file: a rank gap of 2e-7 in ``pool_hT1``).
    The AASIST scorers are held above on tests/test_streaming.py's own
    geometry."""
    root = tmp_path_factory.mktemp("torch_stream")
    write_track(root)
    cfg, pt = make_conformer(root, seed=5)
    rng = np.random.default_rng(9)
    audio = []
    for name, n, sr in (("long", 37150, 16000), ("short", 4800, 16000),
                        ("resampled", 33075, 22050)):
        t = np.arange(n) / sr
        wave = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(n)
        path = str(root / f"{name}.wav")
        write_wav(path, wave.astype(np.float32), sr)
        audio.append(path)
    cal = root / "cal.json"
    # a threshold between the files' aggregates (about -1.35, -1.52 and
    # -1.42), so that both decisions are printed
    cal.write_text(json.dumps({"platt_a": 1.5, "platt_b": -0.2,
                               "eer_threshold": -1.47}))
    return dict(root=root, cfg=cfg, pt=pt, audio=audio, cal=str(cal))


def _run(main, track, capsys, tag, extra=()):
    """Run one CLI over the track's audio -> (per-window rows, file rows,
    --out rows, stderr rows). Window rows: (path#i, start, score, p);
    file rows: (path, score, p, verdict)."""
    out = track["root"] / f"out_{tag}.txt"
    capsys.readouterr()
    main(["--config", track["cfg"], "--ckpt", track["pt"], "--audio",
          *track["audio"], "--window_sec", "0.5", "--hop_sec", "0.25",
          "--per_window", "--out", str(out), *extra])
    printed = capsys.readouterr()
    windows, files = [], []
    for line in printed.out.splitlines():
        parts = line.split(" ")
        if "#" in parts[0] and parts[0].split("#")[0] in track["audio"]:
            windows.append((parts[0], parts[1], float(parts[2]), parts[3:]))
        elif parts[0] in track["audio"]:
            files.append((parts[0], float(parts[1]), parts[2:]))
    out_rows = [(l.split(" ")[0], float(l.split(" ")[1]))
                for l in out.read_text().splitlines()]
    xrt = [re.sub(r"in \S+s -> xRT \S+", "", l)
           for l in printed.err.splitlines() if "xRT" in l]
    return windows, files, out_rows, xrt


def _same_rows(got, want, tol):
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose([r[1] for r in got], [r[1] for r in want], **tol)


@pytest.mark.parametrize("mode", ["naive", "incremental"])
def test_stream_cli_matches_jax(track, capsys, mode):
    """Per-window and per-file lines, the --out file and the stderr lines
    of the port's CLI against the JAX CLI's, with --calibration."""
    extra = ["--calibration", track["cal"]] + (
        ["--incremental"] if mode == "incremental" else [])
    jax_rows = _run(jax_cli.main, track, capsys, f"jax_{mode}", extra)
    port_rows = _run(port_cli.main, track, capsys, f"port_{mode}",
                     extra + ["--device", "cpu"])
    (jw, jf, jo, jx), (pw, pf, po, px) = jax_rows, port_rows
    # window index and start time: 9 windows (the tail at sample 29150,
    # off the hop grid, snapped to 29120 under --incremental), 1 tiled, 5
    # resampled
    assert [(r[0], r[1]) for r in pw] == [(r[0], r[1]) for r in jw]
    assert len(pw) == 15
    np.testing.assert_allclose([r[2] for r in pw], [r[2] for r in jw], **TOL)
    for got, want in ((pw, jw), (pf, jf)):
        # p= to its printed 4 decimals; the decision word exactly
        for g, w in zip(got, want):
            p_g, p_w = float(g[-1][0][2:]), float(w[-1][0][2:])
            assert abs(p_g - p_w) <= 2e-4 and g[-1][1:] == w[-1][1:]
    _same_rows([r[:2] for r in pf], [r[:2] for r in jf], TOL)
    _same_rows(po, jo, TOL)
    assert [r[0] for r in po] == track["audio"]
    assert px == jx and len(px) == 3
    assert [r[2][1] for r in pf] == ["accept@eer", "reject@eer", "accept@eer"]


def test_stream_cli_w8a8_incremental_matches_jax(track, capsys):
    """--w8a8 --incremental against JAX's, as tests/test_torch_quant.py
    holds --w8a8 scoring: within a tenth of JAX's own w8a8-vs-float gap,
    plus 1e-4."""
    scores = {}
    for tag, main, extra in (
            ("jax_w8a8", jax_cli.main, ["--w8a8"]),
            ("port_w8a8", port_cli.main, ["--w8a8", "--device", "cpu"]),
            ("jax_float", jax_cli.main, [])):
        windows, files, _, _ = _run(main, track, capsys, tag,
                                    ["--incremental", *extra])
        scores[tag] = np.array([r[2] for r in windows])
        assert [r[0] for r in windows][-1] == track["audio"][2] + "#4"
    gap = np.abs(scores["jax_w8a8"] - scores["jax_float"]).max()
    err = np.abs(scores["port_w8a8"] - scores["jax_w8a8"]).max()
    assert gap > 0 and err <= 0.1 * gap + 1e-4, (err, gap)


@pytest.mark.parametrize("flags,message", [
    (["--window_sec", "0"], "--window_sec must be > 0"),
    (["--hop_sec", "-1"], "--hop_sec must be > 0"),
    (["--hop_sec", "0.00001"], "is under one sample"),
])
def test_stream_cli_argument_errors_match_jax(track, flags, message):
    args = ["--config", track["cfg"], "--ckpt", track["pt"], "--audio",
            track["audio"][0], *flags]
    errors = []
    for main, extra in ((jax_cli.main, []), (port_cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match=message) as e:
            main(args + extra)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_stream_cli_sub_frame_hop_raises(track):
    with pytest.raises(ValueError, match="below the conv frame stride"):
        port_cli.main(["--config", track["cfg"], "--ckpt", track["pt"],
                       "--audio", track["audio"][0], "--hop_sec", "0.001",
                       "--incremental", "--device", "cpu"])


def test_stream_cli_without_device_needs_a_gpu(track, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--config", track["cfg"], "--ckpt", track["pt"],
                       "--audio", track["audio"][0]])
    assert "Loaded checkpoint" not in capsys.readouterr().out

"""The port's export (``rtdsd_tpu_torch/cli/export.py``) against the JAX
package, on the CPU: the counterparts of tests/test_export.py.

The tiny ``My_XLSR_AASIST`` of tests/test_export.py (2 layers, width 32)
gets seeded numpy weights on the JAX module's shapes
(``_torch_track.random_variables``), carried into the port by
``convert.from_jax_variables``. Every artifact goes through bytes on disk
and back (``torch.export`` programs, the flax msgpack weight sidecar, the
JSON metadata) and is held against the JAX package on the same weights and
the same seeded inputs: the scorer against ``apply(...)[:, 1]`` at rtol
1e-4 / atol 1e-5 (tests/test_export.py), the streaming bundle against the
JAX ``IncrementalStreamingScorer`` and the serving bundle against the JAX
checkpoint-backed engine at rtol 2e-4 / atol 2e-5
(tests/test_torch_streaming.py, tests/test_torch_serving.py). Each bundle
is exported once per module.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_track import random_variables
from rtdsd_tpu.cli import export as jax_export
from rtdsd_tpu.data.dataset import adjust_duration
from rtdsd_tpu.data.io import load_audio
from rtdsd_tpu.engine import serving as jax_serving
from rtdsd_tpu.engine.streaming import IncrementalStreamingScorer
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu_torch.cli import export, serve
from rtdsd_tpu_torch.models import convert, registry

NAME = "My_XLSR_AASIST"
W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
T = 8000                                   # 0.5 s
CPU = ("cpu",)
TOL = dict(rtol=1e-4, atol=1e-5)           # tests/test_export.py
STREAM_TOL = dict(rtol=2e-4, atol=2e-5)    # tests/test_torch_streaming.py


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tracing and the tiny programs run fastest on one thread, beside the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed):
    """(JAX module, JAX variables, port module) of one tiny model."""
    jax_mod = jax_registry.get_model(NAME, num_layers=2, w2v=W2V).module
    v = random_variables(jax_mod, np.zeros((2, T), np.float32), seed=seed,
                         train=False)
    port = registry.get_model(NAME, num_layers=2, w2v=W2V).module
    port.load_state_dict(convert.from_jax_variables(v, NAME), strict=True)
    return jax_mod, v, port.eval()


@pytest.fixture(scope="module")
def tiny():
    return _pair(0)


@pytest.fixture(scope="module")
def direct(tiny):
    """The JAX module's scores, ``apply(...)[:, 1]`` under jit (op by op
    it takes half a minute a call on the CPU)."""
    jax_mod, v, _ = tiny
    fn = jax.jit(lambda w: jax_mod.apply(v, w, train=False)[:, 1])
    return lambda w: np.asarray(fn(jnp.asarray(w)))


@pytest.fixture(scope="module")
def scorer(tiny, tmp_path_factory):
    """A symbolic-batch scorer artifact on disk."""
    _, _, port = tiny
    path = str(tmp_path_factory.mktemp("export") / "model.tpex")
    export.save_exported(
        export.export_scorer(port, num_samples=T, batch=None, platforms=CPU),
        path, {"model": NAME, "sample_rate": 16000, "duration_sec": 0.5,
               "batch": "symbolic"}, export._state(port), NAME)
    return path


def test_export_symbolic_batch_roundtrip(direct, scorer):
    art = export.ScoringArtifact.load(scorer, "cpu")
    for b, seed in [(1, 3), (3, 0), (5, 1)]:  # batch 1 is accepted too
        w = np.random.default_rng(seed).standard_normal((b, T)) \
            .astype(np.float32)
        got = art.call(w)
        assert got.shape == (b,)
        np.testing.assert_allclose(got, direct(w), **TOL)

    meta = json.loads(open(scorer + ".json").read())
    assert meta["platforms"] == ["cpu"]
    assert meta["in_avals"][0].startswith("float32[") \
        and meta["in_avals"][0].endswith(f",{T}]")
    # weights live in the sidecar, not in the program, which is far
    # smaller than the weights it scores with
    assert 0 < meta["artifact_bytes"] < meta["params_bytes"]


def test_export_fixed_batch_rejects_other_batch(tiny, direct, tmp_path):
    _, _, port = tiny
    path = str(tmp_path / "fixed.tpex")
    export.save_exported(
        export.export_scorer(port, num_samples=T, batch=5, platforms=CPU),
        path, {"model": NAME}, export._state(port), NAME)
    art = export.ScoringArtifact.load(path, "cpu")
    w = np.random.default_rng(2).standard_normal((5, T)).astype(np.float32)
    np.testing.assert_allclose(art.call(w), direct(w), **TOL)
    with pytest.raises(Exception):  # shape-checked at the program boundary
        art.call(w[:2])


def test_export_streaming_matches_incremental_scorer(tiny, tmp_path):
    """The two-program streaming bundle, through bytes on disk, gives the
    JAX IncrementalStreamingScorer's window scores (tail window and frame
    snap included) on long, short (tiled) and exact-length audio, with
    one and several conv segments."""
    jax_mod, v, port = tiny
    hop = 2000
    convs, scores, meta = export.export_streaming(
        port, port.w2v_cfg, duration=T, hop=hop, seg_frames=32,
        platforms=CPU)
    prefix = str(tmp_path / "stream")
    export.save_streaming(convs, scores, prefix, meta, export._state(port),
                          NAME)
    art = export.StreamingArtifact.load(prefix, "cpu")
    scorer = IncrementalStreamingScorer(
        jax_mod, v["params"], v["batch_stats"], jax_mod.w2v_cfg, duration=T,
        hop=hop, seg_frames=32)

    rng = np.random.default_rng(7)
    for t in (23500, 3000, T):  # long (tail window), short (tiled), exact
        w = rng.standard_normal(t).astype(np.float32) * 0.1
        got, starts = art.window_scores(w, return_starts=True)
        want = np.asarray(scorer.window_scores(w))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **STREAM_TOL)
        assert starts.shape == got.shape
        assert all(s % art.meta["stride"] == 0 for s in starts)
        if t > T:  # tail window present and grid-snapped
            tail = (t - T) - ((t - T) % art.meta["stride"])
            assert starts[-1] == tail
    assert np.isfinite(art.score(w, aggregate="mean"))
    side = json.loads(open(prefix + ".json").read())
    assert side["streaming"] and side["hop"] == hop
    assert side["platforms"] == ["cpu"]


@pytest.fixture(scope="module")
def serving(tiny, direct, tmp_path_factory):
    """A serving bundle with a cascade (flagship seed 5), int16 transport
    and a band that splits the screener's scores, beside the same
    configuration's kwargs and the flagship pair."""
    jax_mod, v, port = tiny
    flagship = _pair(5)
    cfg = port.w2v_cfg
    duration = 80 * cfg.total_stride
    hop = duration // 2
    rng = np.random.default_rng(0)
    wave = (rng.standard_normal(4 * hop + duration) * 0.1).astype(np.float32)
    wins = np.stack([wave[s:s + duration]
                     for s in range(0, len(wave) - duration + 1, hop)])
    s_scores = direct(wins)
    center = float(np.median(s_scores))
    band = float(np.quantile(np.abs(s_scores - center), 0.6)) + 1e-3
    kwargs = dict(duration=duration, hop=hop, max_streams=2,
                  transport_dtype="int16", escalate_band=band,
                  escalate_center=center)
    ext, sco, esc, meta = export.export_serving(
        port, cfg, escalate=flagship[2], platforms=CPU, **kwargs)
    meta.update(sample_rate=16000)
    prefix = str(tmp_path_factory.mktemp("serving") / "bundle")
    export.save_serving(ext, sco, esc, prefix, meta, export._state(port),
                        NAME, export._state(flagship[2]), NAME)
    return dict(prefix=prefix, kwargs=kwargs, wave=wave, flagship=flagship)


def _polls(eng, wave):
    """A loud stream pushed in irregular chunks beside a stream of exact
    zeros (gated, and served by the zero-segment scatter), polled after
    each push, then flushed and drained -> [(poll, stream, start, score,
    escalated, gated)]."""
    out = []
    loud, quiet = eng.open_stream("loud"), eng.open_stream("quiet")
    rng = np.random.default_rng(1)
    cur, poll = 0, 0
    while cur < len(wave):
        n = int(rng.integers(700, 2500))
        eng.push(loud, wave[cur:cur + n])
        eng.push(quiet, np.zeros(len(wave[cur:cur + n]), np.float32))
        cur += n
        out += [(poll, g) for g in eng.poll()]
        poll += 1
    for h in (loud, quiet):
        eng.close_stream(h, flush=True)
    out += [(-1, g) for g in eng.drain()]
    return [(p, g.stream_id, g.start_sample, g.score, g.escalated, g.gated)
            for p, g in out]


def test_export_serving_artifact_matches_ckpt_engine(tiny, serving):
    """A serving bundle, served through ``cli.serve``'s ``--artifact``
    engine, rebuilds an engine with no model code whose window scores,
    poll for poll, are the JAX checkpoint-backed engine's: stream, start,
    escalated and gated exactly, scores to 2e-4 / 2e-5, with the cascade,
    the int16 transport, the energy gate and the zero-segment scatter
    composed."""
    jax_mod, v, _ = tiny
    fj, fv, _ = serving["flagship"]
    ref = jax_serving.MultiStreamScorer(
        jax_mod, v["params"], v["batch_stats"], jax_mod.w2v_cfg,
        gate_rms_dbfs=-50.0, escalate=(fj, fv["params"], fv["batch_stats"]),
        **serving["kwargs"])
    eng, sr = serve.build_engine(serve.parse_args(
        ["--artifact", serving["prefix"], "--audio", "x.wav", "--device",
         "cpu", "--gate_db", "-50"]), 1)
    assert sr == 16000.0 and eng.max_streams == 2
    meta = eng.artifact_meta
    assert meta["escalate"] and meta["transport_dtype"] == "int16"
    eng.dispatch_counts = dict.fromkeys(eng.dispatch_counts, 0)  # warm-up
    want, got = _polls(ref, serving["wave"]), _polls(eng, serving["wave"])
    assert [g[:3] + g[4:] for g in got] == [w[:3] + w[4:] for w in want]
    assert any(g[4] for g in got) and not all(g[4] for g in got
                                              if not g[5])
    assert any(g[5] for g in got) and eng.zero_segments > 0
    np.testing.assert_allclose([g[3] for g in got], [w[3] for w in want],
                               **STREAM_TOL)
    # fixed-shape programs: no sub-shape dispatch ran
    assert eng._subshape_ok is False
    assert eng.dispatch_counts["extend_half"] == 0
    with pytest.raises(RuntimeError, match="no model code"):
        eng.model(None)


def test_serve_cli_artifact_flag_validation(serving):
    """--artifact excludes --config/--ckpt and every flag baked at export;
    --max_streams must match the bundle's slot count (the bundle serving
    with no such flag: test_export_serving_artifact_matches_ckpt_engine)."""
    prefix = serving["prefix"]

    def refused(match, *flags):
        with pytest.raises(SystemExit, match=match):
            serve.build_engine(serve.parse_args(
                ["--artifact", prefix, "--audio", "x.wav", "--device", "cpu",
                 *flags]), 1)

    if not torch.cuda.is_available():   # the device defaults to cuda
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.build_engine(serve.parse_args(
                ["--artifact", prefix, "--audio", "x.wav"]), 1)
    refused("replaces", "--config", "c", "--ckpt", "k")
    refused("baked", "--window_sec", "1")
    refused("baked", "--w8a8")
    refused("slot count", "--max_streams", "4")


def test_reload_params_from_artifact_sidecars(tiny, serving):
    """reload_params in --artifact mode reads the weight sidecars again:
    the primary's and the flagship's state dicts, value for value."""
    _, _, port = tiny
    args = serve.parse_args(["--artifact", serving["prefix"], "--audio",
                             "x.wav", "--device", "cpu"])
    sd, esc = serve.reload_params(args)
    for got, model in ((sd, port), (esc, serving["flagship"][2])):
        want = model.state_dict()
        assert sorted(got) == sorted(want)
        for k, t in want.items():
            assert torch.equal(got[k], t), k


def test_export_streaming_rejects_subframe_hop(tiny):
    _, _, port = tiny
    for hop in (1, 0):  # 0 must trip the guard, not fall back to default
        with pytest.raises(ValueError, match="frame stride"):
            export.export_streaming(port, port.w2v_cfg, duration=T, hop=hop,
                                    platforms=CPU)


def test_export_bundle_lists_its_platforms(tiny, scorer, tmp_path):
    """A bundle lists every platform it holds a program for, and a loader
    asks for its own: one the bundle lacks raises, nothing falls back. The
    default platforms (cpu, cuda) need the card at export."""
    _, _, port = tiny
    assert export.program_platforms(scorer) == ["cpu"]
    assert json.loads(open(scorer + ".json").read())["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="holds programs for"):
        export.load_program(scorer, torch.device("cuda"))
    if torch.cuda.is_available():
        progs = export.export_scorer(port, num_samples=T, batch=2)
        path = str(tmp_path / "both.tpex")
        export.save_exported(progs, path, {"model": NAME},
                             export._state(port), NAME)
        assert export.program_platforms(path) == ["cpu", "cuda"]
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.export_scorer(port, num_samples=T, batch=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.ScoringArtifact.load(scorer)   # cuda unless asked


def test_params_sidecar_bytes_equal_jax(tiny, scorer, tmp_path):
    """The port's ``.params`` holds the bytes the JAX package's
    ``save_params_sidecar`` writes for the same float32 weights."""
    _, v, _ = tiny
    n = jax_export.save_params_sidecar(str(tmp_path / "jax"), v)
    with open(str(tmp_path / "jax") + ".params", "rb") as f:
        want = f.read()
    with open(scorer + ".params", "rb") as f:
        got = f.read()
    assert n == len(got) and got == want


def test_infer_imports_no_model_module(direct, scorer, tmp_path):
    """cli.infer, run in a fresh process, scores through the artifact with
    no module that defines a model imported, and no JAX."""
    from rtdsd_tpu_torch.data.io import write_wav

    rng = np.random.default_rng(9)
    files = []
    for i, n in enumerate((T, 5000, 9000)):   # exact, tiled, cropped
        files.append(str(tmp_path / f"clip{i}.wav"))
        write_wav(files[-1], (rng.standard_normal(n) * 0.1)
                  .astype(np.float32), 16000)
    code = (
        "import sys\n"
        "from rtdsd_tpu_torch.cli import infer\n"
        "infer.main(sys.argv[1:])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax',"
        " 'rtdsd_tpu') or m in ('rtdsd_tpu_torch.models.wav2vec2',"
        " 'rtdsd_tpu_torch.models.aasist', 'rtdsd_tpu_torch.models.conformer',"
        " 'rtdsd_tpu_torch.models.zoo')]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--artifact", scorer, "--audio", *files,
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = [float(l.split(" ")[1]) for l in proc.stdout.splitlines()]
    waves = np.stack([adjust_duration(load_audio(p)[0], T) for p in files])
    np.testing.assert_allclose(got, direct(waves), **TOL)

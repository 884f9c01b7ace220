"""The port's scoring CLI beyond plain scoring, its score-file metrics and
evaluate CLI, and ``conv_segments``, against the JAX package's, on the CPU.

The synthetic LA21 track of tests/_torch_track.py (10 clips) is scored with
two tiny ``My_XLSR_Conformer`` ``.pt`` files (weights from two seeds: the
full model and a screener) by the JAX CLI in-process
(``rtdsd_tpu.cli.main.main``, and for the cascades the JAX CLI's own
``load_eval_model`` / ``produce_evaluation_file_cascade`` on models loaded
once, since every JAX load initialises a model eagerly) and by
``rtdsd_tpu_torch.cli.main.main --device cpu``. One model family keeps the
file to one JAX compile; the chip smoke runs the AASIST-screened cascade.
Score files are held to the float32 tolerance of tests/test_torch_cli.py
(1e-4); the metrics and the evaluate CLI, copies of numpy code, to 1e-12
and to equal output.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_track import make_conformer, random_variables, write_track
from rtdsd_tpu.cli import common as jax_common
from rtdsd_tpu.cli import evaluate as jax_evaluate
from rtdsd_tpu.cli import main as jax_main
from rtdsd_tpu.config import load_yaml_config as jax_load_config
from rtdsd_tpu.data.dataset import ASVspoof2021LA_eval as JaxLA21
from rtdsd_tpu.models.wav2vec2 import Wav2Vec2Config as JaxW2VConfig
from rtdsd_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from rtdsd_tpu.utils import metrics as jax_metrics
from rtdsd_tpu_torch.cli import evaluate as port_evaluate
from rtdsd_tpu_torch.cli import main as port_main
from rtdsd_tpu_torch.models import convert, wav2vec2
from rtdsd_tpu_torch.utils import metrics as port_metrics

TOL = dict(rtol=1e-4, atol=1e-4)     # tiny float32 models, tests/test_torch_cli.py


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    lines = open(path).read().splitlines()
    return ([l.split(" ")[0] for l in lines],
            np.array([float(l.split(" ")[1]) for l in lines]))


@pytest.fixture(scope="module")
def track(tmp_path_factory):
    """The track, the two .pt files, the screener's own config, both CLIs'
    score files of each model alone, and the JAX models loaded once."""
    root = tmp_path_factory.mktemp("torch_scoring")
    write_track(root)
    cfg, full_pt = make_conformer(root, seed=3)
    _, screen_pt = make_conformer(root, seed=4)
    screen_cfg = root / "screener.yaml"
    shutil.copy(cfg, screen_cfg)
    args = ["--config", cfg, "--is_eval", "--is_score", "--tracks", "LA21"]
    jax_main.main(args + ["--ckpt", full_pt, "--comment", "jax_full"])
    for pt, tag in ((full_pt, "full"), (screen_pt, "screen")):
        port_main.main(args + ["--ckpt", pt, "--comment", f"port_{tag}",
                               "--device", "cpu"])
    sys_j, exp_j = jax_load_config(cfg)
    jax_models = {tag: jax_common.load_eval_model(sys_j, exp_j, pt)
                  for tag, pt in (("full", full_pt), ("screen", screen_pt))}
    spec, state, _, sharding = jax_models["screen"]
    jax_common.produce_evaluation_file(
        JaxLA21(sys_j, exp_j), spec, state, str(root / "jax_screen.txt"),
        exp_j.batch_size_test, sharding, num_workers=1)
    return dict(root=root, cfg=cfg, full_pt=full_pt, screen_pt=screen_pt,
                screen_cfg=str(screen_cfg), jax_cfg=(sys_j, exp_j),
                jax_models=jax_models)


def test_conformer_score_file_matches_jax_cli(track):
    root = track["root"]
    ids_j, s_j = _read(root / "scores_la21_jax_full.txt")
    ids_p, s_p = _read(root / "scores_la21_port_full.txt")
    assert ids_p == ids_j and len(ids_p) == 10
    np.testing.assert_allclose(s_p, s_j, **TOL)
    _, screen_j = _read(root / "jax_screen.txt")
    _, screen_p = _read(root / "scores_la21_port_screen.txt")
    np.testing.assert_allclose(screen_p, screen_j, **TOL)
    assert np.abs(screen_j - s_j).min() > 1e-2      # two different models


def _band(kind, screener):
    """-1 (no trial), over every trial, or between two |scores| at least
    2e-3 apart, nearest the middle, so no near-tie can flip a trial."""
    mags = np.sort(np.abs(screener))
    if kind == "none":
        return -1.0
    if kind == "all":
        return float(mags[-1]) + 1.0
    gaps = [(abs(i - len(mags) / 2), (mags[i - 1] + mags[i]) / 2)
            for i in range(1, len(mags)) if mags[i] - mags[i - 1] >= 2e-3]
    return float(min(gaps)[1])


@pytest.mark.parametrize("kind", ["none", "some", "all"])
def test_cascade_matches_jax_cli(track, capsys, kind):
    """Both CLIs escalate the same trials (the band taken from the JAX
    screener's scores) and write the same scores; every line that did not
    escalate is the port screener's own score, bit for bit, and every line
    that did is the full model's."""
    root = track["root"]
    _, screen_j = _read(root / "jax_screen.txt")
    _, screen_p = _read(root / "scores_la21_port_screen.txt")
    _, full_p = _read(root / "scores_la21_port_full.txt")
    band = _band(kind, screen_j)
    esc = np.abs(screen_j) <= band
    assert esc.sum() == {"none": 0, "all": 10}.get(kind, esc.sum())
    assert kind != "some" or 0 < esc.sum() < 10

    capsys.readouterr()
    (f_spec, f_state, _, sharding), (s_spec, s_state, _, _) = (
        track["jax_models"][t] for t in ("full", "screen"))
    ds = JaxLA21(*track["jax_cfg"])
    jax_common.produce_evaluation_file_cascade(
        ds, ds, s_spec, s_state, f_spec, f_state,
        str(root / f"jax_cascade_{kind}.txt"), 8, band=band, center=0.0,
        sharding=sharding, num_workers=1)
    printed = {"jax": capsys.readouterr().out}
    port_main.main(["--config", track["cfg"], "--is_eval", "--is_score",
                    "--ckpt", track["full_pt"], "--tracks", "LA21",
                    "--cascade_ckpt", track["screen_pt"], "--cascade_config",
                    track["screen_cfg"], "--cascade_band", repr(band),
                    "--cascade_center", "0", "--comment", f"cascade_{kind}",
                    "--device", "cpu"])
    printed["port"] = capsys.readouterr().out
    lines = {k: [l for l in v.splitlines() if l.startswith("cascade:")]
             for k, v in printed.items()}
    assert lines["port"] == lines["jax"] == [
        f"cascade: {esc.sum()}/10 escalated ({10.0 * esc.sum():.1f}%, "
        f"band {band} around 0.0)"]
    ids_j, s_j = _read(root / f"jax_cascade_{kind}.txt")
    ids_p, s_p = _read(root / f"scores_la21_cascade_{kind}.txt")
    assert ids_p == ids_j
    np.testing.assert_allclose(s_p, s_j, **TOL)
    np.testing.assert_array_equal(s_p[~esc], screen_p[~esc])
    np.testing.assert_allclose(s_p[esc], full_p[esc], **TOL)


def test_score_all_folder_matches_jax_cli(track, monkeypatch):
    """Two .pt files and a stray file: the JAX CLI's folder loop (its
    scoring stubbed to record what it would score) and the port's name the
    same checkpoints with the same comments, and the port writes their
    score files."""
    root = track["root"]
    folder = root / "ckpts"
    folder.mkdir()
    for name in ("b.pt", "a.pt"):
        shutil.copy(track["full_pt"], folder / name)
    (folder / "notes.txt").write_text("not a checkpoint\n")
    args = ["--config", track["cfg"], "--is_eval", "--score_all_folder_path",
            str(folder), "--tracks", "LA21", "--comment", "dir"]
    jax_calls = []
    monkeypatch.setattr(jax_main, "run_score", lambda a, *rest: jax_calls.append(
        (os.path.basename(a.ckpt), a.comment)))
    jax_main.main(args)
    assert jax_calls == [("a.pt", "dir_a.pt"), ("b.pt", "dir_b.pt")]
    before = set(os.listdir(root))
    port_main.main(args + ["--device", "cpu"])
    assert sorted(set(os.listdir(root)) - before) == [
        f"scores_la21_{comment}.txt" for _, comment in jax_calls]
    _, full_p = _read(root / "scores_la21_port_full.txt")
    for _, comment in jax_calls:
        np.testing.assert_array_equal(
            _read(root / f"scores_la21_{comment}.txt")[1], full_p)


# ------------------------------------------------------------- conv_segments

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": ((32, 10, 5), (32, 3, 2), (32, 2, 2), (32, 2, 2))}


@pytest.mark.parametrize("segments", [2, 3])
def test_conv_segments_match_jax(segments):
    """The segmented conv front-end (the wave zero-padded to whole
    segments at both counts) against JAX's, float32, and against the port's
    own unsegmented encoder."""
    waves = (np.random.default_rng(segments).standard_normal((2, 8000)) * 0.3
             ).astype(np.float32)
    mod = JaxEncoder(JaxW2VConfig(encoder_layers=2, conv_segments=segments,
                                  **W2V))
    v = random_variables(mod, waves, seed=segments, train=False)
    want = np.asarray(jax.jit(lambda p, w: mod.apply(p, w, train=False))(
        v, jnp.asarray(waves)))
    sd = convert._w2v(v["params"], "")
    got = {}
    for n in (segments, 0):
        enc = wav2vec2.Wav2Vec2Encoder(wav2vec2.make_w2v_cfg(
            2, **{**W2V, "conv_segments": n}))
        enc.load_state_dict(sd, strict=True)
        with torch.inference_mode():
            got[n] = enc.eval()(torch.from_numpy(waves)).numpy()
    assert got[segments].shape == (2, 199, 32)
    np.testing.assert_allclose(got[segments], want, **TOL)
    np.testing.assert_allclose(got[segments], got[0], rtol=1e-5, atol=1e-5)


def test_conv_segments_rejects_group_norm():
    cfg = wav2vec2.make_w2v_cfg(2, **{**W2V, "conv_segments": 2,
                                      "extractor_mode": "group_norm"})
    enc = wav2vec2.Wav2Vec2Encoder(cfg).eval()
    with pytest.raises(ValueError, match="layer_norm extractor"):
        enc(torch.zeros(1, 8000))


# ------------------------------------------------------------------ metrics

@pytest.fixture(scope="module")
def scored():
    """Seeded scores of 60 bonafide and 140 spoof trials, some tied."""
    rng = np.random.default_rng(11)
    labels = np.r_[np.ones(60, int), np.zeros(140, int)]
    scores = np.r_[rng.normal(1.0, 1.2, 60), rng.normal(-1.0, 1.0, 140)]
    scores[::17] = np.round(scores[::17], 1)
    return scores, labels


def _cal_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _cal_equal(a[k], b[k])
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12)


@pytest.mark.parametrize("fn", ["compute_eer", "calibrate_scores",
                                "load_calibration", "load_cascade_calibration",
                                "platt_prob", "calibration_threshold",
                                "compute_min_tdcf"])
def test_metrics_match_jax(scored, tmp_path, fn):
    s, y = scored
    cal = {m: m.calibrate_scores(s, y, target_frrs=(0.1,))
           for m in (jax_metrics, port_metrics)}
    if fn == "compute_eer":
        for pos in (1, 0):
            np.testing.assert_allclose(port_metrics.compute_eer(s, y, pos),
                                       jax_metrics.compute_eer(s, y, pos),
                                       rtol=0, atol=1e-12)
    elif fn == "calibrate_scores":
        _cal_equal(cal[port_metrics], cal[jax_metrics])
    elif fn in ("load_calibration", "load_cascade_calibration"):
        good = tmp_path / "good.json"
        good.write_text(json.dumps({"platt_a": 1.5, "platt_b": -0.2,
                                    "eer_threshold": 0.1, "band": 0.7,
                                    "center": 0.0}))
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        assert (getattr(port_metrics, fn)(str(good))
                == getattr(jax_metrics, fn)(str(good)))
        for m in (port_metrics, jax_metrics):
            with pytest.raises(ValueError, match="missing"):
                getattr(m, fn)(str(bad))
    elif fn == "platt_prob":
        for x in (s, 0.3):
            np.testing.assert_allclose(
                port_metrics.platt_prob(x, cal[port_metrics]),
                jax_metrics.platt_prob(x, cal[jax_metrics]), rtol=0,
                atol=1e-12)
    elif fn == "calibration_threshold":
        for c in cal.values():       # keyed by the printed rate, as the CLI's JSON
            for table in ("at_far", "at_frr"):
                c[table] = {f"{k:g}": v for k, v in c[table].items()}
        for point in ("eer", "far=0.05", "frr=0.1"):
            np.testing.assert_allclose(
                port_metrics.calibration_threshold(cal[port_metrics], point),
                jax_metrics.calibration_threshold(cal[jax_metrics], point),
                rtol=0, atol=1e-12)
        for m in (port_metrics, jax_metrics):
            with pytest.raises(ValueError, match="not in this calibration"):
                m.calibration_threshold(cal[m], "far=0.5")
    else:
        for kw in ({}, {"pmiss_asv": 0.05, "pfa_asv": 0.01,
                        "pmiss_spoof_asv": 0.3}):
            np.testing.assert_allclose(
                port_metrics.compute_min_tdcf(s, y, **kw),
                jax_metrics.compute_min_tdcf(s, y, **kw), rtol=0, atol=1e-12)


# ------------------------------------------------------------ evaluate CLI

EVAL_MODES = {
    "eer": [],
    "tdcf": ["--tdcf", "--pmiss-asv", "0.05", "--pfa-asv", "0.01",
             "--pmiss-spoof-asv", "0.3"],
    "calibrate": ["--calibrate", "--target-frr", "0.1"],
    "fuse": ["--fuse", "{other}", "--fuse-weights", "0.7", "0.3",
             "--fuse-out", "{out}"],
    "cascade_sweep": ["--cascade-sweep", "{other}", "--cascade-out", "{out}"],
    "config_track": ["--config", "{config}", "--track", "LA21", "--tdcf"],
}


@pytest.mark.parametrize("mode", sorted(EVAL_MODES))
def test_evaluate_cli_matches_jax(scored, tmp_path, capsys, mode):
    """Each mode prints what the JAX CLI prints and writes the same file."""
    s, y = scored
    ids = [f"LA_E_{i:04d}" for i in range(len(s))]
    (tmp_path / "la21.txt").write_text("".join(
        f"LA_0001 {u} - A01 {'bonafide' if l else 'spoof'}\n"
        for u, l in zip(ids, y)))
    (tmp_path / "scores.txt").write_text("".join(
        f"{u} {v}\n" for u, v in zip(ids, s)))
    other = s + np.random.default_rng(12).normal(0, 0.8, len(s))
    (tmp_path / "other.txt").write_text("".join(
        f"{u} {v}\n" for u, v in zip(ids, other)))
    (tmp_path / "cfg.json").write_text(json.dumps({"SysConfig": {
        "path_label_asv_spoof_2021_la_eval": str(tmp_path / "la21.txt")}}))
    out = tmp_path / "out"
    args = ["--scores", str(tmp_path / "scores.txt")]
    if mode != "config_track":
        args += ["--protocol", str(tmp_path / "la21.txt"), "--track", "LA21"]
    args += [a.format(other=tmp_path / "other.txt", out=out,
                      config=tmp_path / "cfg.json") for a in EVAL_MODES[mode]]
    got = {}
    for side, main in (("jax", jax_evaluate.main), ("port", port_evaluate.main)):
        if out.exists():
            out.unlink()
        capsys.readouterr()
        rc = main(args)
        got[side] = (rc, capsys.readouterr().out,
                     out.read_text() if out.exists() else None)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and "EER" in got["port"][1]
    if mode in ("fuse", "cascade_sweep"):
        assert got["port"][2]

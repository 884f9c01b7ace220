"""The port's serving CLI (``rtdsd_tpu_torch.cli.serve``) against the JAX
package's (``rtdsd_tpu.cli.serve``), both run in process on the CPU on two
tiny Conformer ``.pt`` files of ``tests/_torch_track.py`` (the AASIST head
pairs its branches' nodes by pooling rank, and flips at rank near-ties:
see tests/test_torch_streaming.py).

Four synthetic files are served as live streams at 0.5 s windows and a
0.25 s hop: one whose tail window is off the hop grid (``#tail``), one
shorter than a window (tiled), one with two seconds of exact silence
(gated under ``--gate_db``, the zero-segment fastpath under the int16
transport) and one at 22.05 kHz. Lines must agree: window labels, starts,
marks and decisions exactly; scores, calibrated probabilities and
aggregates to float32 model tolerance.
"""

import json
import re

import numpy as np
import pytest
import torch

from _torch_track import make_conformer, write_track
from rtdsd_tpu.cli import serve as jax_cli
from rtdsd_tpu_torch.cli import serve as port_cli
from rtdsd_tpu_torch.data.io import write_wav

TOL = dict(rtol=1e-4, atol=1e-4)          # float32, tests/test_torch_models.py


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU serving is thousands of tiny ops, which run fastest
    on one thread, and far slower with a full thread pool a worker each
    beside the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def track(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    write_track(root)
    cfg, pt = make_conformer(root, seed=5)
    _, screener = make_conformer(root, seed=3)
    rng = np.random.default_rng(11)
    audio = []
    for name, n, sr, silent in (("tail", 37150, 16000, None),
                                ("short", 4800, 16000, None),
                                ("silent", 40000, 16000, (8000, 40000)),
                                ("resampled", 22050, 22050, None)):
        t = np.arange(n) / sr
        wave = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.1 * rng.standard_normal(n)
        if silent:
            wave[silent[0]:silent[0] + 32000] = 0.0
        path = str(root / f"{name}.wav")
        write_wav(path, wave.astype(np.float32), sr)
        audio.append(path)
    cal = root / "cal.json"
    cal.write_text(json.dumps({"platt_a": 1.5, "platt_b": -0.2,
                               "eer_threshold": -0.95}))
    return dict(root=root, cfg=cfg, pt=pt, screener=screener, audio=audio,
                cal=str(cal))


def _serve(main, track, capsys, tag, extra=()):
    """Run one CLI over the track's audio -> dict of its window rows
    (label, start, score, rest), file rows (path, score, rest), --out rows
    and stderr lines."""
    out = track["root"] / f"out_{tag}.txt"
    capsys.readouterr()
    main(["--config", track["cfg"], "--ckpt", track["pt"], "--audio",
          *track["audio"], "--window_sec", "0.5", "--hop_sec", "0.25",
          "--per_window", "--out", str(out), *extra])
    printed = capsys.readouterr()
    windows, files = [], []
    for line in printed.out.splitlines():
        head, *rest = line.split(" ")
        if head.split("#")[0] not in track["audio"]:
            continue
        if "#" in head:
            windows.append((head, rest[0], float(rest[1]), rest[2:]))
        else:
            files.append((head, float(rest[0]), rest[1:]))
    rows = [(l.split(" ")[0], float(l.split(" ")[1]))
            for l in out.read_text().splitlines()]
    return dict(windows=windows, files=files, out=rows,
                err=printed.err.splitlines())


def _prob(rest):
    return [float(r[2:]) for r in rest if r.startswith("p=")]


def _same(got, want):
    """Windows in the same order with the same labels, starts and marks,
    and scores (and p=) within TOL; file rows likewise; --out rows."""
    assert [(w[0], w[1], [r for r in w[3] if not r.startswith("p=")])
            for w in got["windows"]] == \
        [(w[0], w[1], [r for r in w[3] if not r.startswith("p=")])
         for w in want["windows"]]
    np.testing.assert_allclose([w[2] for w in got["windows"]],
                               [w[2] for w in want["windows"]], **TOL)
    np.testing.assert_allclose(sum((_prob(w[3]) for w in got["windows"]), []),
                               sum((_prob(w[3]) for w in want["windows"]), []),
                               atol=2e-4)
    assert [(f[0], [r for r in f[2] if not r.startswith("p=")])
            for f in got["files"]] == \
        [(f[0], [r for r in f[2] if not r.startswith("p=")])
         for f in want["files"]]
    np.testing.assert_allclose([f[1] for f in got["files"]],
                               [f[1] for f in want["files"]], **TOL)
    assert [r[0] for r in got["out"]] == [r[0] for r in want["out"]]
    np.testing.assert_allclose([r[1] for r in got["out"]],
                               [r[1] for r in want["out"]], **TOL)


def _stats_lines(err):
    """stderr lines that do not carry a time."""
    return [l for l in err if "energy gate" in l or "cascade:" in l
            or "snapped" in l]


# the cascade run also caps the score batch (each tick drains its backlog
# in several dispatches); one JAX compilation of the escalation and of the
# capped score program serves both
RUNS = {
    "gate_calibration": ["--gate_db", "-50", "--calibration", "cal"],
    "cascade_capped": ["--cascade_ckpt", "screener", "--cascade_band", "1e9",
                       "--score_batch", "1"],
}


def _extra(track, name):
    return [track.get(a, a) for a in RUNS[name]]


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_cli_matches_jax(track, capsys, name):
    extra = _extra(track, name)
    want = _serve(jax_cli.main, track, capsys, f"jax_{name}", extra)
    got = _serve(port_cli.main, track, capsys, f"port_{name}",
                 extra + ["--device", "cpu"])
    _same(got, want)
    assert _stats_lines(got["err"]) == _stats_lines(want["err"])
    labels = [w[0].split("#")[1] for w in got["windows"]]
    marks = [m for w in got["windows"] for m in w[3] if not m.startswith("p=")]
    assert "tail" in labels and len(got["files"]) == 4
    if name == "gate_calibration":
        assert marks.count("gated") >= 4 and "escalated" not in marks
        verdicts = [f[2][-1] for f in got["files"]]
        assert {"accept@eer", "reject@eer"} <= set(verdicts), verdicts
    else:
        assert marks.count("escalated") == len(got["windows"])
        assert any("windows escalated" in l for l in got["err"])
    tick = [l for l in got["err"] if "tick p50" in l]
    assert len(tick) == 1 and "4 streams" in tick[0]


def test_serve_cli_device_ms(track, capsys):
    """--device_ms prints device ms per tick with the dispatch breakdown."""
    got = _serve(port_cli.main, track, capsys, "port_device_ms",
                 ["--device_ms", "--device", "cpu"])
    line = [l for l in got["err"] if "ms/tick" in l]
    assert len(line) == 1
    assert re.search(r"device [\d.]+ ms/tick \(extend:[\d.]+ms x[\d.]+ .*"
                     r"score:[\d.]+ms x[\d.]+", line[0]), line[0]


@pytest.mark.parametrize("flag,item", [
    (["--shard"], "Queue 1 item 8"),
])
def test_unported_flags_exit_naming_roadmap_item(track, flag, item):
    with pytest.raises(SystemExit, match=item):
        port_cli.main(["--config", track["cfg"], "--ckpt", track["pt"],
                       "--audio", track["audio"][0], "--device", "cpu", *flag])


def test_serve_cli_without_device_needs_a_gpu(track, capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--config", track["cfg"], "--ckpt", track["pt"],
                       "--audio", track["audio"][0]])
    assert "Loaded checkpoint" not in capsys.readouterr().out


def test_reload_params_swaps_in_place(track):
    """reload_params reads the checkpoints again as build_engine does; a
    swap with them leaves the engine serving the same scores."""
    args = port_cli.parse_args([
        "--config", track["cfg"], "--ckpt", track["pt"], "--audio",
        track["audio"][0], "--window_sec", "0.5", "--cascade_ckpt",
        track["screener"], "--cascade_band", "1e9", "--device", "cpu"])
    eng, sr = port_cli.build_engine(args, 1)
    assert sr == 16000.0 and args.cascade_esc_rate is None
    wave = np.random.default_rng(3).standard_normal(16000).astype(np.float32)

    def serve_once():
        h = eng.open_stream("x")
        eng.push(h, wave * 0.1)
        eng.close_stream(h, flush=True)
        return [w.score for w in eng.drain()]

    before = serve_once()
    primary, flagship = port_cli.reload_params(args)
    assert flagship is not None
    eng.swap_model(primary, escalate=flagship)
    assert eng.model_swaps == 1 and serve_once() == before

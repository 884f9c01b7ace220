"""The port's export and artifact CLIs end to end on the CPU
(``rtdsd_tpu_torch.cli.export``, ``cli.infer``, ``cli.serve --artifact``):
the counterparts of tests/test_cli_smoke.py's export, serving export,
streaming export and infer tests.

The track and the reference ``.pt`` of a tiny JAX ``My_XLSR_AASIST`` come
from ``tests/_torch_track.py``; every CLI runs in process with
``--platforms cpu`` / ``--device cpu``. What comes out of an artifact is
held against the port's own checkpoint-backed CLI on the same files
(``cli.main --is_score``, ``cli.stream --incremental``, ``cli.serve``),
which tests/test_torch_cli.py, tests/test_torch_streaming.py and
tests/test_torch_serve_cli.py hold against the JAX package.
"""

import json

import numpy as np
import pytest
import torch

from _torch_track import make_track
from rtdsd_tpu_torch.cli import export, infer
from rtdsd_tpu_torch.cli import main as port_main
from rtdsd_tpu_torch.cli import serve, stream
from rtdsd_tpu_torch.data.io import write_wav

TOL = 1e-4          # float32, tests/test_torch_models.py


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def track(tmp_path_factory):
    return make_track(tmp_path_factory.mktemp("torch_export_cli"))


def _lines(text, prefix):
    return [l for l in text.splitlines() if l.startswith(prefix)]


def test_cli_export_and_infer(track, capsys):
    """cli.export at a fixed batch of 2, then cli.infer over three files
    (the tail batch padded) gives cli.main --is_score's scores."""
    root, cfg, pt = track
    art = str(root / "model.tpex")
    export.main(["--config", cfg, "--ckpt", pt, "--batch", "2",
                 "--platforms", "cpu", "--out", art])
    assert "exported My_XLSR_AASIST" in capsys.readouterr().out
    meta = json.loads((root / "model.tpex.json").read_text())
    assert meta["batch"] == 2 and meta["sample_rate"] == 16000
    assert meta["platforms"] == ["cpu"] and meta["quant"] == "none"

    port_main.main(["--config", cfg, "--is_eval", "--is_score", "--ckpt", pt,
                    "--tracks", "LA21", "--device", "cpu"])
    want = dict(l.split(" ") for l in
                (root / "scores_la21.txt").read_text().splitlines())
    uids = ("LA_E_0000", "LA_E_0001", "LA_E_0002")
    out = root / "infer_scores.txt"
    infer.main(["--artifact", art, "--audio",
                *(str(root / "audio" / f"{u}.flac") for u in uids),
                "--out", str(out), "--device", "cpu"])
    got = [l.split(" ") for l in out.read_text().splitlines()]
    assert [u for u, _ in got] == list(uids)
    for uid, score in got:
        assert abs(float(score) - float(want[uid])) < TOL


def test_cli_export_streaming_and_infer(track, capsys):
    """cli.export --streaming, then cli.infer --per_window on long audio:
    the windows and scores of cli.stream --incremental."""
    root, cfg, pt = track
    prefix = str(root / "stream_art")
    export.main(["--config", cfg, "--ckpt", pt, "--streaming",
                 "--hop_sec", "0.25", "--platforms", "cpu", "--out", prefix])
    assert "streaming" in capsys.readouterr().out
    for ext in (".conv", ".score", ".params", ".json"):
        assert (root / ("stream_art" + ext)).stat().st_size > 0
    wav = str(root / "long.wav")
    t = np.arange(30000) / 16000
    write_wav(wav, (0.3 * np.sin(2 * np.pi * 440 * t)
                    + 0.05 * np.random.default_rng(0).standard_normal(
                        len(t))).astype(np.float32), 16000)

    infer.main(["--artifact", prefix, "--audio", wav, "--per_window",
                "--aggregate", "median", "--device", "cpu"])
    got = capsys.readouterr().out
    stream.main(["--config", cfg, "--ckpt", pt, "--audio", wav,
                 "--window_sec", "0.5", "--hop_sec", "0.25", "--per_window",
                 "--incremental", "--aggregate", "median", "--device",
                 "cpu"])
    want = capsys.readouterr().out
    got_w, want_w = _lines(got, "long#"), _lines(want, wav + "#")
    assert len(got_w) == len(want_w) >= 4
    for g, w in zip(got_w, want_w):
        assert g.split(" ")[1] == w.split(" ")[1]          # window start
        assert abs(float(g.split(" ")[2]) - float(w.split(" ")[2])) < TOL
    agg_got = float(_lines(got, "long ")[0].split(" ")[1])
    agg_want = float(_lines(want, wav + " ")[0].split(" ")[1])
    assert abs(agg_got - agg_want) < TOL


def test_cli_export_serving_then_serve_artifact(track, capsys):
    """cli.export --serving with a cascade, then cli.serve --artifact with
    no --config/--ckpt: with every window escalated to the flagship
    (--ckpt's model) the aggregate is the checkpoint-backed serve's."""
    root, cfg, pt = track
    prefix = str(root / "serve_art")
    export.main(["--config", cfg, "--ckpt", pt, "--serving",
                 "--max_streams", "2", "--platforms", "cpu",
                 "--cascade_ckpt", pt, "--out", prefix])
    assert "serving" in capsys.readouterr().out
    for ext in (".extend", ".score", ".escalate", ".params", ".esc.params",
                ".json"):
        assert (root / ("serve_art" + ext)).stat().st_size > 0
    wav = str(root / "serve_in.wav")
    write_wav(wav, np.random.default_rng(4).standard_normal(24000)
              .astype(np.float32) * 0.1, 16000)
    serve.main(["--artifact", prefix, "--cascade_band", "1e9", "--audio",
                wav, "--device", "cpu"])
    art_out = capsys.readouterr().out
    serve.main(["--config", cfg, "--ckpt", pt, "--audio", wav, "--device",
                "cpu"])
    ckpt_out = capsys.readouterr().out
    score_of = lambda s: float(_lines(s, wav)[0].rsplit(" ", 1)[1])
    assert abs(score_of(art_out) - score_of(ckpt_out)) < TOL

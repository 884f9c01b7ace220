"""The port's native daemon client (``rtdsd_tpu_torch/native/serve_client.cpp``
through ``native/client.py``) and the port's daemon CLI
(``rtdsd_tpu_torch.cli.daemon``), on the CPU; tests/test_native_client.py
and tests/test_cli_smoke.py::test_cli_daemon_smoke hold the JAX package's.

The C library re-implements the wire protocol and the client-side
transport encodings, so the oracles are the port's Python ``ServeClient``:
the bytes each puts on the wire for float32, int16 and mulaw8, the scores
each receives from the port's daemon, and the feeder binary's aggregate of
a WAV file. Both outputs are built with g++ at first use into
``build/rtdsd_tpu_torch/``; a build that fails raises with the compiler's
message.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from _torch_track import make_track
from test_torch_netserve import (DUR, _port_daemon, models,  # noqa: F401
                                 one_thread, serve)
from rtdsd_tpu_torch.data.io import load_audio, write_wav
from rtdsd_tpu_torch.engine.netserve import ServeClient
from rtdsd_tpu_torch.engine.serving import mulaw_encode
from rtdsd_tpu_torch.native import client

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native():
    client.build()
    assert client.available()
    return client


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


@pytest.mark.parametrize("transport", ["int16", "mulaw8", "float32"])
def test_wire_encoding_matches_python_client(native, models, serve,
                                             transport):
    """The C client's transport conversion puts the Python client's bytes
    on the wire: int16 = clip(rint(x * 32768)) half to even, mulaw8 =
    continuous mu-law quantized after companding, float32 as is."""
    served = serve(_port_daemon(models, tick_sec=1e9, max_streams=4,
                                transport_dtype=transport))
    eng = served.daemon.engine
    rng = np.random.default_rng(3)
    # exact halves after scaling, clip edges, +-1
    wave = np.concatenate([
        rng.uniform(-1.2, 1.2, 3000).astype(np.float32),
        np.float32([1.0, -1.0, 0.5 / 32768, 1.5 / 32768, -0.5 / 32768,
                    32766.5 / 32768, -32768.5 / 32768, 0.0])])
    pc = served.client()
    nc = native.NativeServeClient(unix_path=served.sock_path)
    assert (nc.proto, nc.sample_rate, nc.duration, nc.hop, nc.transport,
            nc.max_streams) == (pc.proto, pc.sample_rate, pc.duration,
                                pc.hop, pc.transport, pc.max_streams)
    hp, hn = pc.open("py"), nc.open("c")
    pc.push(hp, wave)
    nc.push(hn, wave)
    pc.ping()
    nc.ping()   # the PONGs follow both pushes through the daemon's loop
    _wait(lambda: min(eng._slots[h].chunks_len for h in (hp, hn))
          >= len(wave), "pushes did not arrive")
    got_py = np.concatenate(eng._slots[hp].chunks)
    got_c = np.concatenate(eng._slots[hn].chunks)
    assert got_py.dtype == got_c.dtype == np.dtype(eng._tdtype)
    np.testing.assert_array_equal(got_py, got_c)
    if transport == "mulaw8":
        np.testing.assert_array_equal(got_c, mulaw_encode(wave))
    nc.close_socket()
    pc.close_socket()


def test_native_client_scores_match_python_client(native, models, serve):
    """The same audio through the C client and the Python client gets the
    same window scores, bit for bit."""
    served = serve(_port_daemon(models))
    wave = np.random.default_rng(11).uniform(-0.5, 0.5, DUR * 3).astype(
        np.float32)
    got = []
    for cli in (native.NativeServeClient(unix_path=served.sock_path),
                served.client()):
        h = cli.open("stream")
        for i in range(0, len(wave), 1000):
            cli.push(h, wave[i:i + 1000])
        cli.close(h, flush=True)
        got.append(cli.collect({h})[h])
        cli.close_socket()
    assert len(got[0]) == len(got[1]) > 0
    assert got[0] == got[1]


def test_native_client_error_events_not_fatal(native, models, serve):
    """An ERROR frame is an ("error", handle, message) event: one bad
    stream does not end a consumer of many."""
    served = serve(_port_daemon(models))
    nc = native.NativeServeClient(unix_path=served.sock_path)
    nc.push_bytes(99, np.zeros(100, np.int16).tobytes())   # never opened
    ev = next(nc.events())
    assert ev[0] == "error" and ev[1] == 99
    assert "not an open stream" in ev[2]
    nc.ping()
    nc.close_socket()


def test_feeder_binary_end_to_end(native, models, serve, tmp_path):
    """The feeder streams a PCM16 WAV and prints the aggregate the Python
    client's windows of the same PCM give."""
    feed = native.build_feeder()
    served = serve(_port_daemon(models))
    wave = np.random.default_rng(7).uniform(-0.5, 0.5, DUR * 2).astype(
        np.float32)
    path = str(tmp_path / "clip.wav")
    write_wav(path, wave, 16000)
    out = subprocess.run([feed, f"unix:{served.sock_path}", path],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1].split()[0] == path
    pcm = load_audio(path)[0]
    pc = served.client()
    h = pc.open("oracle")
    pc.push(h, pcm)
    pc.close(h, flush=True)
    scores = [s for _, s, _ in sorted(pc.collect({h})[h])]
    pc.close_socket()
    assert len([l for l in lines if l.startswith("window @")]) == len(scores)
    assert float(lines[-1].split()[-1]) == pytest.approx(
        float(np.mean(scores)), abs=1e-4)


def test_build_failure_raises_with_compiler_message(native, tmp_path,
                                                    monkeypatch):
    """A source g++ refuses raises with the compiler's message, for the
    library and for the feeder: nothing quietly returns None."""
    bad = tmp_path / "serve_client.cpp"
    bad.write_text("int main() { return undeclared_name; }\n")
    monkeypatch.setattr(client, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="build failed(.|\n)*undeclared"):
        client.build_feeder()
    with pytest.raises(RuntimeError, match="build failed(.|\n)*undeclared"):
        client.build()


# ------------------------------------------------------------ daemon CLI

@pytest.fixture(scope="module")
def track(tmp_path_factory):
    return make_track(tmp_path_factory.mktemp("torch_daemon"))


def _stream_file(cli, wave, name):
    h = cli.open(name)
    for c in range(0, len(wave), 3000):     # a live producer's chunks
        cli.push(h, wave[c:c + 3000])
    cli.close(h, flush=True)
    return sorted(cli.collect({h})[h])


def test_cli_daemon_smoke(track, tmp_path):
    """``python -m rtdsd_tpu_torch.cli.daemon --device cpu`` on the tiny
    track: a stream gets its windows and CLOSED; SIGHUP reloads the same
    --ckpt and a new stream gets the same scores; SIGTERM stops it with
    exit code 0."""
    root, cfg, pt = track
    sock = str(tmp_path / "d.sock")
    t = np.arange(24000) / 16000
    wave = (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    log_path = tmp_path / "daemon.log"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "rtdsd_tpu_torch.cli.daemon", "--config",
             cfg, "--ckpt", pt, "--max_streams", "2", "--window_sec", "0.5",
             "--hop_sec", "0.25", "--listen", f"unix:{sock}",
             "--stats_every", "0", "--device", "cpu"],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        _wait(lambda: os.path.exists(sock) or proc.poll() is not None,
              "daemon never opened its socket", 300)
        assert proc.poll() is None, log_path.read_text()[-2000:]
        cli = ServeClient(unix_path=sock)
        assert (cli.duration, cli.hop) == (8000, 4000)
        got = _stream_file(cli, wave, "a")
        # 1.5 s at 0.5 s windows and a 0.25 s hop: 5 hop-grid windows
        assert [s for s, _, _ in got] == [k * 4000 for k in range(5)]
        assert all(np.isfinite(v) for _, v, _ in got)
        proc.send_signal(signal.SIGHUP)
        _wait(lambda: "reloaded checkpoint" in log_path.read_text()
              or proc.poll() is not None, "no reload line", 300)
        assert proc.poll() is None, log_path.read_text()[-2000:]
        again = _stream_file(cli, wave, "b")
        assert [s for s, _, _ in again] == [s for s, _, _ in got]
        np.testing.assert_allclose([v for _, v, _ in again],
                                   [v for _, v, _ in got], rtol=1e-5,
                                   atol=1e-6)
        cli.close_socket()
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
    text = log_path.read_text()
    assert proc.returncode == 0, text[-2000:]
    assert "[daemon] stopped" in text and "swap #1" in text


def test_cli_daemon_needs_a_gpu_or_device_cpu(track, tmp_path):
    """Without --device, on a machine with no GPU, the daemon raises before
    it opens a socket."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from rtdsd_tpu_torch.cli import daemon

    root, cfg, pt = track
    sock = tmp_path / "none.sock"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        daemon.main(["--config", cfg, "--ckpt", pt, "--max_streams", "2",
                     "--listen", f"unix:{sock}"])
    assert not sock.exists()

"""The port's socket daemon (``rtdsd_tpu_torch/engine/netserve.py``) on the
CPU, against the JAX package's (``rtdsd_tpu/engine/netserve.py``), on the
tiny 2-layer XLSR_AASIST of tests/test_torch_serving.py (stride 40,
3200-sample windows, 1600-sample hop).

Weights are made with numpy from a seed on the JAX module's shapes and
carried into the port by ``convert.from_jax_variables``. The same streams
go to both daemons: HELLO, OPENED, CLOSED, PONG and ERROR frames must be
byte-identical, SCORE frames must carry the same handle, start and flags
with scores within tests/test_serving.py's tolerance, and each package's
client must drive the other's daemon. The port's own behaviour follows
tests/test_netserve.py test by test, with direct scoring of the
int16-quantized windows (``engine/steps.py::make_score_step``) as the
oracle. ``test_daemon_from_artifact_matches_ckpt_daemon`` serves a
``cli/export.py`` serving bundle beside the checkpoint-backed engine.

Each daemon runs on a private asyncio loop in a background thread and the
blocking clients talk to it over a Unix socket, as a producer would. A JAX
engine compiles each of its dispatch shapes, so one module-scoped JAX
engine serves every JAX comparison.
"""

import asyncio
import collections
import copy
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from _torch_track import random_variables
from rtdsd_tpu.engine import netserve as jax_netserve
from rtdsd_tpu.engine import serving as jax_serving
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu_torch.engine import netserve
from rtdsd_tpu_torch.engine.netserve import (FLAG_ESCALATED, FLAG_GATED,
                                             ServeClient, ServeDaemon, _frame)
from rtdsd_tpu_torch.engine.serving import MultiStreamScorer, mulaw_encode
from rtdsd_tpu_torch.engine.steps import make_score_step
from rtdsd_tpu_torch.models import convert, registry
from rtdsd_tpu_torch.utils.metrics import platt_prob

W2V = {"conv_layers": [[8, 10, 5], [8, 4, 4], [8, 2, 2]],
       "encoder_embed_dim": 8, "encoder_ffn_dim": 16, "encoder_heads": 2,
       "conv_pos": 4, "conv_pos_groups": 2}
NAME = "My_XLSR_AASIST"
DUR = 80 * 40                 # 3200 samples, 80 frames of stride 40
HOP = DUR // 2
TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_serving.py
GATE = dict(gate_rms_dbfs=-50.0, gate_score=-3.0)


def _pair(seed):
    """(JAX module, params, batch_stats, port module) of one tiny model
    with weights from ``seed``."""
    jax_mod = jax_registry.get_model(NAME, num_layers=2, w2v=W2V).module
    v = random_variables(jax_mod, np.zeros((1, DUR), np.float32), seed=seed,
                         train=False)
    port = registry.get_model(NAME, num_layers=2, w2v=W2V).module
    port.load_state_dict(convert.from_jax_variables(v, NAME), strict=True)
    return jax_mod, v["params"], v["batch_stats"], port.eval()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engine's CPU work is many tiny ops, which run fastest on one
    thread, and far slower with a full thread pool a worker each beside
    the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    return {"primary": _pair(3), "other": _pair(9)}


@pytest.fixture(scope="module")
def jax_module_engine(models):
    """The one JAX engine of the module (int16, 3 slots, the energy gate)."""
    jax_mod, params, stats, _ = models["primary"]
    eng = jax_serving.MultiStreamScorer(
        jax_mod, params, stats, jax_mod.w2v_cfg, duration=DUR, hop=HOP,
        max_streams=3, transport_dtype="int16", **GATE)
    eng.warmup()
    return eng


@pytest.fixture()
def jax_engine(jax_module_engine):
    """The module's JAX engine with no stream open and its free slots in a
    new engine's order, so that it hands out the handles a new port engine
    does."""
    assert not jax_module_engine._slots
    jax_module_engine._free = collections.deque(range(3))
    return jax_module_engine


def _port_engine(models, key="primary", **kw):
    module = models[key][3]
    kw.setdefault("max_streams", 3)
    kw.setdefault("transport_dtype", "int16")
    return MultiStreamScorer(module, module.w2v_cfg, duration=DUR, hop=HOP,
                             **kw)


class _Served:
    """A daemon (either package's ServeDaemon) on its own loop in a
    background thread, on a Unix socket or, with ``tcp``, on 127.0.0.1."""

    def __init__(self, daemon, sock_path=None, tcp=False):
        self.daemon = daemon
        self.sock_path = None if tcp else str(sock_path)
        self.port = None
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def go():
                if tcp:
                    server = await daemon.start(host="127.0.0.1", port=0)
                    self.port = server.sockets[0].getsockname()[1]
                else:
                    await daemon.start(unix_path=self.sock_path)
                started.set()

            self.loop.run_until_complete(go())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(30), "daemon failed to start"

    def client(self, cls=ServeClient):
        if self.port is not None:
            return cls(host="127.0.0.1", port=self.port)
        return cls(unix_path=self.sock_path)

    def call(self, coro):
        """Run a coroutine on the daemon's loop; its result or exception."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(30)

    def stop(self):
        if self.loop.is_closed():
            return
        try:
            self.call(self.daemon.stop())
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=30)
            self.loop.close()


@pytest.fixture()
def serve(tmp_path):
    """serve(daemon, tcp=False) -> a running _Served, stopped after the
    test."""
    running = []

    def start(daemon, tcp=False):
        s = _Served(daemon, tmp_path / f"d{len(running)}.sock", tcp=tcp)
        running.append(s)
        return s

    yield start
    for s in running:
        s.stop()


def _port_daemon(models, tick_sec=0.02, **kw):
    eng_kw = {k: kw.pop(k) for k in list(kw)
              if k not in ("max_pending_sec", "idle_timeout_sec",
                           "score_transform")}
    return ServeDaemon(_port_engine(models, **eng_kw), 16000,
                       tick_sec=tick_sec, **kw)


def _pcm(wave):
    return np.clip(np.rint(wave * 32768.0), -32768, 32767).astype(np.int16)


def _expected(model, wave):
    """Direct scoring of the hop-grid windows of the int16-quantized wave
    (the wire transport quantizes exactly like the engine's own push)."""
    w = _pcm(wave).astype(np.float32) / 32768.0
    windows = np.stack([w[s:s + DUR]
                        for s in range(0, len(w) - DUR + 1, HOP)])
    return make_score_step(model)(torch.from_numpy(windows)).numpy()


def _stream(cli, wave, name="", chunks=(300, 2000), seed=5):
    """Open, push ``wave`` in ragged chunks, flush-close and collect ->
    sorted [(start, score, flags)]."""
    rng = np.random.default_rng(seed)
    h = cli.open(name)
    cur = 0
    while cur < len(wave):
        n = int(rng.integers(*chunks))
        cli.push(h, wave[cur:cur + n])
        cur += n
    cli.close(h, flush=True)
    return sorted(cli.collect({h})[h])


def _wave(seed, n, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(np.float32)


def _check_scores(got, want):
    assert [s for s, _, _ in got] == [k * HOP for k in range(len(want))]
    np.testing.assert_allclose([v for _, v, _ in got], want, **TOL)


# --------------------------------------------------- against the JAX daemon

class _Raw:
    """A raw socket speaking frames, for byte comparisons."""

    def __init__(self, served):
        self.s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.s.connect(served.sock_path)
        self.s.settimeout(30)
        self.buf = b""

    def frame(self) -> bytes:
        while len(self.buf) < 5 or len(self.buf) < 5 + struct.unpack_from(
                "<I", self.buf, 1)[0]:
            data = self.s.recv(1 << 16)
            assert data, "daemon closed the connection"
            self.buf += data
        n = 5 + struct.unpack_from("<I", self.buf, 1)[0]
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def ask(self, data: bytes) -> bytes:
        self.s.sendall(data)
        return self.frame()

    def close(self):
        self.s.close()


def _exchange(served):
    """Every reply frame but SCORE of one scripted connection: HELLO,
    PONG, OPENED x3, the slot-exhaustion ERROR, per-stream and
    connection-level ERRORs, and CLOSED of an unflushed and a flushed
    stream."""
    raw = _Raw(served)
    out = [raw.frame(), raw.ask(_frame(0x04))]
    hs = []
    for name in (b"a", b"b", b"c"):
        f = raw.ask(_frame(0x01, name))
        out.append(f)
        hs.append(struct.unpack_from("<I", f, 5)[0])
    out += [raw.ask(_frame(0x01)),                           # slots busy
            raw.ask(_frame(0x02, b"\x63\x00\x00\x00\x00\x00")),  # foreign
            raw.ask(_frame(0x7F, b"\x01")),                  # unknown type
            raw.ask(_frame(0x03, b"\x07")),                  # short CLOSE
            raw.ask(_frame(0x02, struct.pack("<I", hs[0]) + b"\x01")),  # odd
            raw.ask(_frame(0x03, struct.pack("<I", hs[1]) + b"\x00"))]
    # a flushed stream with one window of samples: its CLOSED follows its
    # SCORE frame, which is compared with the scores below
    raw.s.sendall(_frame(0x02, struct.pack("<I", hs[2])
                         + _pcm(_wave(1, DUR)).tobytes())
                  + _frame(0x03, struct.pack("<I", hs[2]) + b"\x01"))
    frames = [raw.frame(), raw.frame()]
    assert frames[0][0] == 0x82, frames
    out.append(frames[1])
    out.append(raw.ask(_frame(0x03, struct.pack("<I", hs[0]) + b"\x00")))
    raw.close()
    return out


def test_frames_byte_identical_to_jax(models, jax_engine, serve):
    """HELLO, OPENED, CLOSED, PONG and ERROR frames of the port's daemon
    are the JAX daemon's byte for byte, on the same script."""
    got = {}
    for tag, eng in (("jax", jax_engine),
                     ("port", _port_engine(models, **GATE))):
        served = serve(jax_netserve.ServeDaemon(eng, 16000, tick_sec=0.02)
                       if tag == "jax" else ServeDaemon(eng, 16000,
                                                        tick_sec=0.02))
        got[tag] = _exchange(served)
        served.stop()
    assert got["port"] == got["jax"]
    hello = got["port"][0]
    assert hello[0] == 0x80 and struct.unpack("<IIIIBI", hello[5:]) == (
        1, 16000, DUR, HOP, netserve.TRANSPORT_CODES["int16"], 3)
    assert any(f[0] == 0xFF and b"busy" in f for f in got["port"])


def _wire_streams(cli):
    """Two loud streams and one [loud | silence | loud] (gated windows),
    pushed in turns in ragged chunks -> {name: sorted [(start, score,
    flags)]}; handles are compared through the open order."""
    loud = _wave(5, 4 * HOP + DUR)
    waves = {"a": loud, "b": _wave(6, 2 * HOP + DUR + 203),
             "g": np.concatenate([_wave(7, DUR), np.zeros(2 * DUR,
                                                          np.float32),
                                  _wave(8, DUR)])}
    handles = {name: cli.open(name) for name in waves}
    rng = np.random.default_rng(9)
    cursors = dict.fromkeys(waves, 0)
    while any(cursors[n] < len(w) for n, w in waves.items()):
        for name, w in waves.items():
            if cursors[name] < len(w):
                k = int(rng.integers(300, 2000))
                cli.push(handles[name], w[cursors[name]:cursors[name] + k])
                cursors[name] += k
    for h in handles.values():
        cli.close(h, flush=True)
    got = cli.collect(set(handles.values()))
    return handles, {n: sorted(got[h]) for n, h in handles.items()}


def _same_scores(a, b):
    """Same starts and flags, scores within the tolerance."""
    for name in a:
        assert [(s, f) for s, _, f in a[name]] == \
            [(s, f) for s, _, f in b[name]], name
        np.testing.assert_allclose([v for _, v, _ in a[name]],
                                   [v for _, v, _ in b[name]], **TOL)


def test_scores_match_jax_daemon(models, jax_engine, serve):
    """The same streams through the JAX daemon and the port's: the same
    handles, starts and flags (gated windows among them), scores within
    the tolerance."""
    results = {}
    for tag in ("jax", "port"):
        if tag == "jax":
            served = serve(jax_netserve.ServeDaemon(jax_engine, 16000,
                                                    tick_sec=0.02))
            cli = served.client(jax_netserve.ServeClient)
        else:
            served = serve(_port_daemon(models, **GATE))
            cli = served.client()
        results[tag] = _wire_streams(cli)
        cli.close_socket()
        served.stop()
    assert results["port"][0] == results["jax"][0]
    port, jax = results["port"][1], results["jax"][1]
    _same_scores(port, jax)
    assert any(f == FLAG_GATED for _, _, f in port["g"])
    assert not any(f for n in ("a", "b") for _, _, f in port[n])


def test_clients_drive_the_other_daemon(models, jax_engine, serve):
    """The JAX package's ServeClient drives the port's daemon, and the
    port's ServeClient drives the JAX daemon: the same windows as each
    package's own client gets."""
    port_served = serve(_port_daemon(models, **GATE))
    jax_served = serve(jax_netserve.ServeDaemon(jax_engine, 16000,
                                                tick_sec=0.02))
    got = {}
    for tag, served, cls in (
            ("port daemon, jax client", port_served, jax_netserve.ServeClient),
            ("port daemon, port client", port_served, ServeClient),
            ("jax daemon, port client", jax_served, ServeClient),
            ("jax daemon, jax client", jax_served, jax_netserve.ServeClient)):
        cli = served.client(cls)
        got[tag] = _wire_streams(cli)[1]
        cli.close_socket()
    for a, b in (("port daemon, jax client", "port daemon, port client"),
                 ("jax daemon, port client", "jax daemon, jax client"),
                 ("port daemon, port client", "jax daemon, port client")):
        _same_scores(got[a], got[b])


# ------------------------------------------------------ the port's daemon

def test_daemon_scores_match_direct(models, serve):
    """Two concurrent wire streams pushed in uneven chunks score as direct
    window scoring; CLOSED follows the final window and frees the slot."""
    served = serve(_port_daemon(models))
    cli = served.client()
    assert cli.transport == "int16"
    assert (cli.duration, cli.hop, cli.max_streams) == (DUR, HOP, 3)
    waves = [_wave(5, 4 * HOP + DUR), _wave(6, 2 * HOP + DUR)]
    handles = [cli.open(f"wire{i}") for i in range(2)]
    rng = np.random.default_rng(5)
    cursors = [0, 0]
    while any(c < len(w) for c, w in zip(cursors, waves)):
        for i, (h, w) in enumerate(zip(handles, waves)):
            n = int(rng.integers(300, 2000))
            if cursors[i] < len(w):
                cli.push(h, w[cursors[i]:cursors[i] + n])
                cursors[i] += n
    for h in handles:
        cli.close(h, flush=True)
    got = cli.collect(set(handles))
    for h, w in zip(handles, waves):
        _check_scores(sorted(got[h]), _expected(models["primary"][3], w))
    cli.close_socket()
    cli2 = served.client()
    assert len({cli2.open() for _ in range(3)}) == 3
    cli2.close_socket()


def test_daemon_error_paths(models, serve):
    """A foreign handle is refused per stream and the connection lives on;
    slot exhaustion answers ERROR; unflushed closes answer CLOSED at
    once."""
    served = serve(_port_daemon(models))
    cli = served.client()
    cli.ping()
    cli._sock.sendall(_frame(0x02, b"\x63\x00\x00\x00" + b"\x00\x00"))
    with pytest.raises(RuntimeError, match="not an open stream"):
        next(cli.events())
    cli.ping()
    hs = [cli.open() for _ in range(3)]
    with pytest.raises(RuntimeError, match="busy"):
        cli.open()
    for h in hs:
        cli.close(h, flush=False)
    seen = set()
    for ev in cli.events():
        assert ev[0] == "closed"
        seen.add(ev[1])
        if seen == set(hs):
            break
    cli.close_socket()


def test_daemon_survives_malformed_frames(models, serve):
    """No byte sequence takes down the daemon or its ticker: after every
    attack a fresh connection still scores exactly."""
    served = serve(_port_daemon(models))
    attacks = [
        b"\x00" * 5,                                   # unknown type 0
        _frame(0x7F, b"\x01\x02\x03"),                 # unknown type
        b"\x02\xff\xff\xff\xff",                       # 4 GiB PUSH claim
        _frame(0x02, b""),                             # PUSH no handle
        _frame(0x02, b"\x00\x00\x00\x00\x01"),         # odd int16 payload
        _frame(0x03, b"\x07"),                         # CLOSE short
        _frame(0x01, b"\xff" * 300),                   # OPEN garbage name
        b"\x82\x10",                                   # truncated header
        bytes(range(256)) * 8,                         # plain garbage
    ]
    for blob in attacks:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.connect(served.sock_path)
        try:
            s.sendall(blob)
            s.shutdown(socket.SHUT_WR)   # the daemon reads EOF after it
            s.settimeout(10)
            while s.recv(4096):
                pass
        except (BrokenPipeError, ConnectionResetError):
            pass  # the daemon dropped the connection
        finally:
            s.close()
    cli = served.client()
    cli.ping()
    wave = _wave(17, 2 * HOP + DUR)
    _check_scores(_stream(cli, wave, "post-fuzz"),
                  _expected(models["primary"][3], wave))
    cli.close_socket()


def test_daemon_tcp_listener(models, serve):
    """The TCP listener speaks the Unix socket's protocol: a stream shorter
    than a window is repeat-tiled into one window."""
    served = serve(_port_daemon(models, max_streams=2), tcp=True)
    cli = served.client()
    cli.ping()
    got = _stream(cli, _wave(0, HOP), "tcp")
    assert len(got) == 1 and np.isfinite(got[0][1])
    cli.close_socket()


def test_daemon_mulaw8_wire(models, serve):
    """mulaw8 over the wire: the client compands float waves to int8, the
    daemon decodes them on the device; scores equal an engine fed the same
    mu-law samples directly."""
    served = serve(_port_daemon(models, max_streams=2,
                                transport_dtype="mulaw8"))
    cli = served.client()
    assert cli.transport == "mulaw8"
    wave = _wave(9, 2 * HOP + DUR)
    h = cli.open()
    cli.push(h, wave)
    cli.close(h, flush=True)
    got = cli.collect({h})[h]
    cli.close_socket()
    ref = _port_engine(models, max_streams=2, transport_dtype="mulaw8")
    rh = ref.open_stream()
    ref.push(rh, mulaw_encode(wave))
    ref.close_stream(rh, flush=True)
    want = {ws.start_sample: ws.score for ws in ref.drain()}
    assert {s for s, _, _ in got} == set(want)
    for s, v, _ in got:
        assert v == pytest.approx(want[s], rel=TOL["rtol"], abs=TOL["atol"])


def test_daemon_cascade_escalation_over_wire(models, serve):
    """A cascade behind the daemon with an everything-escalates band: the
    wire scores are the flagship's direct scores and carry
    FLAG_ESCALATED."""
    screener = models["other"][3]
    flagship = models["primary"][3]
    eng = MultiStreamScorer(screener, screener.w2v_cfg, duration=DUR,
                            hop=HOP, max_streams=2, transport_dtype="int16",
                            escalate=flagship, escalate_band=1e9)
    served = serve(ServeDaemon(eng, 16000, tick_sec=0.02))
    cli = served.client()
    wave = _wave(13, 2 * HOP + DUR)
    got = _stream(cli, wave)
    cli.close_socket()
    assert len(got) == 3 and all(f == FLAG_ESCALATED for _, _, f in got)
    _check_scores(got, _expected(flagship, wave))


def test_daemon_gated_flag_over_wire(models, serve):
    """An energy-gated engine marks silent windows with FLAG_GATED and the
    gate score; loud windows carry no flag."""
    served = serve(_port_daemon(models, max_streams=2, **GATE))
    cli = served.client()
    wave = np.concatenate([_wave(29, DUR), np.zeros(2 * DUR, np.float32),
                           _wave(30, DUR)])
    got = _stream(cli, wave, "g")
    cli.close_socket()
    n_gated = 0
    for start, score, flags in got:
        if start >= DUR and start + DUR <= 3 * DUR:
            assert flags == FLAG_GATED and score == -3.0, (start, flags)
            n_gated += 1
        else:
            assert flags == 0, (start, flags)
    assert n_gated >= 2


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_daemon_sheds_overrunning_stream(models, serve):
    """Past max_pending_sec of buffered backlog a stream is shed (ERROR
    then CLOSED, slot freed); in-flight frames for it are dropped; the
    connection and its other stream live on."""
    # the ticker parked: the backlog can only grow, so the shed is certain
    served = serve(_port_daemon(models, tick_sec=1e9, max_pending_sec=0.5))
    eng, daemon = served.daemon.engine, served.daemon
    cli = served.client()
    keeper, fast = cli.open("slow"), cli.open("fast")
    wave = np.zeros(4000, np.float32)
    for _ in range(3):  # 12000 samples > the 8000 cap
        cli.push(fast, wave)
    with pytest.raises(RuntimeError, match="overrun"):
        next(cli.events())
    ftype, payload = cli._read_frame()
    assert ftype == 0x83 and struct.unpack("<I", payload)[0] == fast
    _wait(lambda: not eng.is_open(fast), "shed slot was not freed")
    assert daemon.overruns == 1
    cli.push(fast, wave)          # tombstoned: dropped without an ERROR
    cli.close(fast, flush=True)
    cli.ping()
    cli.push(keeper, np.zeros(1000, np.float32))
    assert {keeper, cli.open(), cli.open()} == {0, 1, 2}
    cli.close_socket()


def test_daemon_reaps_idle_streams(models, serve):
    """A stream with no PUSH for idle_timeout_sec is shed by the ticker
    (ERROR + CLOSED); its slot is claimable again and the connection's
    active stream lives on."""
    served = serve(_port_daemon(models, max_streams=2, idle_timeout_sec=0.3))
    cli = served.client()
    silent, active = cli.open("silent"), cli.open("active")
    shed = False
    deadline = time.monotonic() + 10
    while not shed and time.monotonic() < deadline:
        cli.push(active, np.zeros(400, np.float32))
        cli._sock.settimeout(0.1)
        try:
            ftype, payload = cli._read_frame()
        except socket.timeout:
            continue
        finally:
            cli._sock.settimeout(60)
        if ftype == 0xFF:
            assert struct.unpack_from("<I", payload)[0] == silent
            assert b"idle timeout" in payload[4:]
            shed = True
    assert shed, "idle stream was never shed"
    for ev in cli.events():
        if ev == ("closed", silent):
            break
        assert ev[0] == "score"
    assert served.daemon.idle_sheds == 1
    cli.push(active, np.zeros(400, np.float32))
    cli.ping()
    assert cli.open("reclaim") == silent
    cli.close_socket()


def test_daemon_disconnect_releases_slots(models, serve):
    """A vanished producer's streams are abandoned (no flush) and their
    slots return to the pool."""
    served = serve(_port_daemon(models))
    cli = served.client()
    h = cli.open("drop")
    cli.push(h, np.zeros(DUR // 4, np.float32))
    cli.close_socket()
    eng = served.daemon.engine
    _wait(lambda: eng.active_streams == 0, "slots not released")
    cli2 = served.client()
    assert len({cli2.open() for _ in range(3)}) == 3
    cli2.close_socket()


def test_daemon_concurrent_connections_interleaved(models, serve):
    """Eight producer threads on their own connections push in ragged
    chunks at once: every stream scores as direct scoring of its own wave,
    and every slot returns to the pool."""
    served = serve(_port_daemon(models, max_streams=8))
    rng = np.random.default_rng(23)
    waves = [_wave(40 + i, int(rng.integers(2, 5)) * HOP + DUR)
             for i in range(8)]
    results, errors = {}, []

    def producer(i):
        try:
            cli = served.client()
            results[i] = _stream(cli, waves[i], f"conn{i}", (200, 1500),
                                 seed=100 + i)
            cli.close_socket()
        except Exception as e:  # reported by the assertion below
            errors.append((i, e))

    threads = [threading.Thread(target=producer, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, got in results.items():
        _check_scores(got, _expected(models["primary"][3], waves[i]))
    assert len(results) == 8
    eng = served.daemon.engine
    _wait(lambda: eng.active_streams == 0, "slots not released")


def test_ticker_stops_on_executor_shutdown(models, serve):
    """An executor shut down under the ticker ends the ticker task instead
    of spinning on "cannot schedule new futures"."""
    served = serve(_port_daemon(models, max_streams=2, tick_sec=0.01))
    cli = served.client()
    cli.open()   # an owner: the ticker's poll branch runs
    ex = ThreadPoolExecutor(1)
    served.loop.call_soon_threadsafe(served.loop.set_default_executor, ex)
    ex.shutdown(wait=False)
    _wait(lambda: served.daemon._ticker.done(),
          "ticker kept spinning after executor shutdown", 15)
    cli.close_socket()


def test_daemon_score_transform_calibrates_wire_scores(models, serve):
    """score_transform maps every wire score (a Platt probability here)
    while the frame stays the same."""
    cal = {"platt_a": 0.7, "platt_b": -0.3, "eer_threshold": 0.0}
    served = serve(_port_daemon(models, max_streams=2,
                                score_transform=lambda s: platt_prob(s, cal)))
    cli = served.client()
    wave = _wave(9, 2 * HOP + DUR)
    got = _stream(cli, wave, "calstream")
    cli.close_socket()
    _check_scores(got, platt_prob(_expected(models["primary"][3], wave), cal))
    assert all(0.0 <= v <= 1.0 for _, v, _ in got)


def test_daemon_swap_model_between_pushes(models, serve):
    """ServeDaemon.swap_model between pushes: a stream opened before the
    swap, with less than a segment pushed, scores entirely on the new
    weights; the count of reloads rises; a state dict of another shape
    raises and leaves the weights serving."""
    module = copy.deepcopy(models["primary"][3])
    served = serve(ServeDaemon(MultiStreamScorer(
        module, module.w2v_cfg, duration=DUR, hop=HOP, max_streams=3,
        transport_dtype="int16"), 16000, tick_sec=0.02))
    cli = served.client()
    wave = _wave(3, 2 * HOP + DUR)
    _check_scores(_stream(cli, wave, "before"),
                  _expected(models["primary"][3], wave))
    h = cli.open("across")
    cli.push(h, wave[:1000])     # less than one 1605-sample segment
    cli.ping()                   # the push has reached the engine
    other = {k: v.clone() for k, v in models["other"][3].state_dict().items()}
    served.call(served.daemon.swap_model(other))
    assert served.daemon.reloads == 1
    cli.push(h, wave[1000:])
    cli.close(h, flush=True)
    got = sorted(cli.collect({h})[h])
    _check_scores(got, _expected(models["other"][3], wave))
    bad = dict(other)
    bad.pop(next(iter(bad)))
    with pytest.raises(ValueError, match="missing"):
        served.call(served.daemon.swap_model(bad))
    assert served.daemon.reloads == 1
    cli.close_socket()


def test_daemon_from_artifact_matches_ckpt_daemon(models, serve, tmp_path):
    """A daemon on an engine rebuilt from a ``cli.export --serving``
    bundle (no model code) sends the SCORE events of a daemon on the
    checkpoint-backed engine for the same pushed samples: the same starts
    and flags, scores within 1e-5 / 1e-6 (tests/test_netserve.py)."""
    from rtdsd_tpu_torch.cli.export import (_state, export_serving,
                                            load_serving, save_serving)

    module = models["primary"][3]
    ext, sco, esc, meta = export_serving(
        module, module.w2v_cfg, duration=DUR, hop=HOP, max_streams=2,
        transport_dtype="int16", platforms=("cpu",))
    prefix = str(tmp_path / "bundle")
    save_serving(ext, sco, esc, prefix, meta, _state(module), NAME)
    art_eng, _ = load_serving(prefix, device="cpu")
    ckpt_eng = _port_engine(models, max_streams=2)
    wave = _wave(9, 3 * HOP + DUR)
    results = []
    for eng in (art_eng, ckpt_eng):
        cli = serve(ServeDaemon(eng, 16000, tick_sec=0.02)).client()
        results.append(_stream(cli, wave, "wire", chunks=(700, 701)))
        cli.close_socket()
    art, ckpt = results
    assert len(art) == len(ckpt) == 4
    assert [(s, f) for s, _, f in art] == [(s, f) for s, _, f in ckpt]
    np.testing.assert_allclose([v for _, v, _ in art],
                               [v for _, v, _ in ckpt], rtol=1e-5, atol=1e-6)

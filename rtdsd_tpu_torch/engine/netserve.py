"""Network serving of the port: a socket daemon around
:class:`~rtdsd_tpu_torch.engine.serving.MultiStreamScorer`, the port of
``rtdsd_tpu/engine/netserve.py`` with its wire protocol byte for byte.

A long-running daemon accepts live audio over Unix or TCP sockets, so that
external producers (telephony bridges, WebRTC gateways, capture agents)
stream PCM in and receive per-window CM scores as they are computed, with
the engine's fixed-shape batching shared across every connection.

Wire protocol (version 1), little-endian, length-prefixed frames::

    frame := u8 type | u32 payload_len | payload

Client -> server:
    0x01 OPEN   payload = utf-8 stream name (may be empty)
    0x02 PUSH   payload = u32 handle | raw samples (transport dtype)
    0x03 CLOSE  payload = u32 handle | u8 flush
    0x04 PING   payload = empty

Server -> client:
    0x80 HELLO  u32 proto=1 | u32 sample_rate | u32 duration | u32 hop |
                u8 transport (0=float32 1=int16 2=mulaw8) | u32 max_streams
                (sent once on connect; duration/hop in samples)
    0x81 OPENED u32 handle   (replies to OPEN, in order)
    0x82 SCORE  u32 handle | u64 start_sample | f32 score | u8 flags
                (bit0 = escalated by the cascade flagship, bit1 =
                energy-gated: no model ran, score is the configured
                gate_score)
    0x83 CLOSED u32 handle   (slot freed; all windows delivered)
    0x84 PONG   empty
    0xFF ERROR  u32 handle (0xFFFFFFFF = connection-level) | utf-8 message

Design:

- One engine, one asyncio loop. Readers translate frames into engine
  calls under an ``asyncio.Lock``; a single ticker task runs
  ``poll()``/``drain()`` in a worker thread (the blocking device dispatch)
  while holding the same lock, so the engine never sees concurrent
  mutation while the kernel keeps buffering ingest. Grad mode and the
  current CUDA device are thread-local in PyTorch: the engine's dispatches
  enter ``torch.inference_mode()`` themselves and name their device, so
  the worker thread needs no set-up.
- Slot handles are the wire handles. The engine reuses slots, so the
  ticker emits CLOSED (and releases the server-side owner entry) while
  still holding the lock: an OPEN racing a close can never observe a
  recycled handle as someone else's stream.
- Overload shedding: the engine buffers pushed-but-unscored samples in
  host memory without bound (offline replay relies on that), so the daemon
  bounds it per stream: past ``max_pending_sec`` of backlog the stream is
  shed (ERROR then CLOSED, slot freed); the connection and its other
  streams live on.
- Transport bytes on the wire are exactly the engine's transport dtype
  (int16 PCM by default, the bytes a capture card produces; ``mulaw8`` for
  ingest-bound links). No server-side resampling: the daemon announces its
  sample rate in HELLO and producers must comply.
"""

from __future__ import annotations

import asyncio
import struct
import sys
import time
import traceback
from typing import Dict, Optional

import numpy as np

from rtdsd_tpu_torch.engine.serving import mulaw_encode

__all__ = ["ServeDaemon", "ServeClient", "TRANSPORT_CODES",
           "FLAG_ESCALATED", "FLAG_GATED"]

PROTO_VERSION = 1

# frame types
OPEN, PUSH, CLOSE, PING = 0x01, 0x02, 0x03, 0x04
HELLO, OPENED, SCORE, CLOSED, PONG, ERROR = (
    0x80, 0x81, 0x82, 0x83, 0x84, 0xFF)

CONN_HANDLE = 0xFFFFFFFF  # ERROR frames not tied to a stream

# SCORE u8 flags bits
FLAG_ESCALATED = 1  # scored by the cascade flagship (not the screener)
FLAG_GATED = 2  # energy-gated silence: no model ran, score = gate_score

TRANSPORT_CODES = {"float32": 0, "int16": 1, "mulaw8": 2}
_TRANSPORT_DTYPES = {0: np.float32, 1: np.int16, 2: np.int8}

_HDR = struct.Struct("<BI")
_HELLO = struct.Struct("<IIIIBI")
_U32 = struct.Struct("<I")
_SCORE = struct.Struct("<IQfB")

MAX_FRAME = 1 << 26  # 64 MiB, over an hour of int16 per push; a length
# beyond this is a corrupt or foreign client, not audio


def _frame(ftype: int, payload: bytes = b"") -> bytes:
    return _HDR.pack(ftype, len(payload)) + payload


class ServeDaemon:
    """Serve a :class:`MultiStreamScorer` over Unix/TCP sockets.

    ``engine`` must be constructed (and ideally ``warmup()``-ed) by the
    caller; ``sample_rate`` is advertised in HELLO. ``tick_sec`` defaults to
    the engine hop (the natural poll cadence).
    """

    def __init__(self, engine, sample_rate: int,
                 tick_sec: Optional[float] = None,
                 max_pending_sec: Optional[float] = 30.0,
                 idle_timeout_sec: Optional[float] = None,
                 score_transform=None):
        self.engine = engine
        # optional score -> wire-f32 map (a Platt-calibrated P(bonafide),
        # cli/daemon.py --calibration); the frame is unchanged, clients
        # read a probability instead of a raw logit
        self.score_transform = score_transform
        self.sample_rate = int(sample_rate)
        self.tick_sec = (engine.hop / sample_rate if tick_sec is None
                         else tick_sec)
        # ingest-overrun guard: past this many samples of backlog a stream
        # is shed (ERROR + CLOSED, slot freed, connection kept)
        self.max_pending = (int(max_pending_sec * sample_rate)
                            if max_pending_sec else 0)
        self.overruns = 0
        # idle-slot reaper: a producer that keeps its connection open but
        # stops pushing would hold a slot forever (a vanished producer's
        # slots are freed by the disconnect path). Streams with no PUSH
        # for this long are shed by the ticker as overruns are; 0 disables
        self.idle_timeout = float(idle_timeout_sec or 0)
        self.idle_sheds = 0
        self._last_push: Dict[int, float] = {}  # handle -> monotonic ts
        self._lock = asyncio.Lock()
        # handle -> writer of OPEN streams; the ticker owns removal (CLOSED
        # emission) so handle reuse stays race-free
        self._owners: Dict[int, asyncio.StreamWriter] = {}
        self._closing: Dict[int, asyncio.StreamWriter] = {}
        # writer -> handles shed out from under that connection (overrun /
        # idle timeout): the producer keeps sending until it sees the
        # ERROR, so in-flight PUSH/CLOSE for a shed handle are dropped
        # silently; an OPEN re-claiming the handle clears it
        self._shed: Dict[asyncio.StreamWriter, set] = {}
        self._dtype = engine._tdtype
        self._server = None
        self._ticker = None
        self.ticks = 0
        self.scores_sent = 0
        self.reloads = 0  # successful hot checkpoint swaps (SIGHUP)
        # a capped or auto-shrunk batch needs several dispatches per tick
        self._poll = (engine.drain
                      if (engine.score_batch < engine.max_streams
                          or engine.extend_batch < engine.max_streams)
                      else engine.poll)

    async def swap_model(self, state_dict, *, escalate=None):
        """Zero-downtime checkpoint swap: takes the tick lock so the swap
        lands between polls (never during a device dispatch), then
        delegates to :meth:`MultiStreamScorer.swap_model` with what
        ``cli/serve.py::reload_params`` returns. Streams, slots and rings
        are untouched."""
        async with self._lock:
            self.engine.swap_model(state_dict, escalate=escalate)
        self.reloads += 1

    # ------------------------------------------------------------- lifecycle

    async def start(self, *, unix_path: Optional[str] = None,
                    host: Optional[str] = None,
                    port: Optional[int] = None):
        if (unix_path is None) == (host is None):
            raise ValueError("pass exactly one of unix_path or host/port")
        if unix_path is not None:
            self._server = await asyncio.start_unix_server(
                self._handle_conn, path=unix_path)
        else:
            self._server = await asyncio.start_server(
                self._handle_conn, host=host, port=port)
        self._ticker = asyncio.ensure_future(self._tick_loop())
        return self._server

    async def stop(self):
        if self._ticker is not None:
            self._ticker.cancel()
            try:
                await self._ticker
            except asyncio.CancelledError:
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # ---------------------------------------------------------------- ticker

    async def _tick_loop(self):
        loop = asyncio.get_running_loop()
        while True:
            t0 = time.perf_counter()
            async with self._lock:
                if self._owners or self._closing:
                    # the blocking device dispatch runs in a worker thread;
                    # the loop keeps accepting and reading sockets meanwhile
                    # (their engine calls queue on the lock)
                    try:
                        scores = await loop.run_in_executor(None,
                                                            self._poll)
                    except RuntimeError as e:
                        if "cannot schedule new futures" in str(e):
                            # interpreter (or loop executor) shutdown:
                            # retrying every tick would spin forever
                            return
                        traceback.print_exc(file=sys.stderr)
                        scores = []
                    except Exception:
                        # a dying ticker would silently stop all scoring;
                        # report the fault and keep serving the streams
                        # that still work
                        traceback.print_exc(file=sys.stderr)
                        scores = []
                    self.ticks += 1
                    self._route(scores)
                    # CLOSED under the lock: a racing OPEN cannot observe a
                    # recycled slot before its CLOSED went out
                    for h in [h for h in self._closing
                              if not self.engine.is_open(h)]:
                        w = self._closing.pop(h)
                        self._send(w, _frame(CLOSED, _U32.pack(h)))
                    if self.idle_timeout:
                        self._reap_idle()
            dt = time.perf_counter() - t0
            await asyncio.sleep(max(0.0, self.tick_sec - dt))

    def _reap_idle(self):
        """Shed OPEN streams with no PUSH for ``idle_timeout`` seconds
        (ticker side, under the lock): the connection stays up, only the
        silent stream's slot is reclaimed, as an overrun shed does. A
        producer that merely paused re-OPENs."""
        now = time.monotonic()
        for h, w in list(self._owners.items()):
            ts = self._last_push.get(h)
            if ts is None or now - ts <= self.idle_timeout:
                continue
            self.idle_sheds += 1
            self._send(w, _frame(
                ERROR, _U32.pack(h)
                + (f"idle timeout: no audio for {now - ts:.1f}s; "
                   f"stream dropped (re-OPEN to resume)").encode()))
            self.engine.close_stream(h, flush=False)
            del self._owners[h]
            del self._last_push[h]
            if w in self._shed:  # tombstone in-flight frames
                self._shed[w].add(h)
            self._send(w, _frame(CLOSED, _U32.pack(h)))

    def _route(self, scores):
        for ws in scores:
            h = ws.stream_id  # the daemon opens streams with id == handle
            w = self._owners.get(h) or self._closing.get(h)
            if w is None:  # producer vanished mid-drain
                continue
            self.scores_sent += 1
            s = (ws.score if self.score_transform is None
                 else float(self.score_transform(ws.score)))
            flags = ((FLAG_ESCALATED if ws.escalated else 0)
                     | (FLAG_GATED if ws.gated else 0))
            self._send(w, _frame(SCORE, _SCORE.pack(
                h, ws.start_sample, s, flags)))

    @staticmethod
    def _send(writer: asyncio.StreamWriter, data: bytes):
        if not writer.is_closing():
            writer.write(data)

    # ------------------------------------------------------------ connection

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter):
        eng = self.engine
        code = TRANSPORT_CODES[
            {np.float32: "float32", np.int16: "int16",
             np.int8: "mulaw8"}[self._dtype]]
        self._send(writer, _frame(HELLO, _HELLO.pack(
            PROTO_VERSION, self.sample_rate, eng.duration, eng.hop,
            code, eng.max_streams)))
        mine = set()  # handles owned by this connection
        # handles shed out from under this connection: in-flight PUSH/CLOSE
        # frames for them are dropped silently instead of bouncing "not an
        # open stream" ERRORs; a later OPEN that recycles the handle clears
        # it. Registered daemon-wide so the idle reaper can tombstone too.
        shed = self._shed[writer] = set()
        try:
            while True:
                hdr = await reader.readexactly(_HDR.size)
                ftype, ln = _HDR.unpack(hdr)
                if ln > MAX_FRAME:
                    self._send(writer, _frame(ERROR, _U32.pack(CONN_HANDLE)
                                              + b"frame too large"))
                    break
                payload = await reader.readexactly(ln) if ln else b""
                if ftype == PING:
                    self._send(writer, _frame(PONG))
                    continue
                async with self._lock:
                    if ftype == OPEN:
                        try:
                            h = eng.open_stream()
                        except RuntimeError as e:
                            self._send(writer, _frame(
                                ERROR, _U32.pack(CONN_HANDLE)
                                + str(e).encode()))
                            continue
                        # open_stream() defaults stream_id to the slot, so
                        # _route keys scores on the wire handle
                        self._owners[h] = writer
                        mine.add(h)
                        shed.discard(h)  # recycled slot: fresh stream
                        # the idle clock starts at OPEN, so a stream that
                        # never pushes can still be reaped
                        self._last_push[h] = time.monotonic()
                        self._send(writer, _frame(OPENED, _U32.pack(h)))
                    elif ftype in (PUSH, CLOSE):
                        if ln < 4:
                            self._send(writer, _frame(
                                ERROR, _U32.pack(CONN_HANDLE)
                                + b"short frame"))
                            continue
                        h = _U32.unpack_from(payload)[0]
                        if h in shed:  # in-flight frames after a shed
                            continue
                        if h not in mine or h not in self._owners:
                            self._send(writer, _frame(
                                ERROR, _U32.pack(h)
                                + b"not an open stream of this "
                                  b"connection"))
                            continue
                        if ftype == PUSH:
                            body = payload[4:]
                            item = np.dtype(self._dtype).itemsize
                            if len(body) % item:
                                self._send(writer, _frame(
                                    ERROR, _U32.pack(h)
                                    + b"payload not a multiple of the "
                                      b"transport itemsize"))
                                continue
                            eng.push(h, np.frombuffer(body, self._dtype))
                            self._last_push[h] = time.monotonic()
                            if (self.max_pending and
                                    eng.pending_samples(h)
                                    > self.max_pending):
                                backlog = (eng.pending_samples(h)
                                           / self.sample_rate)
                                self.overruns += 1
                                self._send(writer, _frame(
                                    ERROR, _U32.pack(h)
                                    + (f"ingest overrun: {backlog:.1f}s"
                                       f" of unscored audio buffered "
                                       f"(producer outruns the engine);"
                                       f" stream dropped").encode()))
                                eng.close_stream(h, flush=False)
                                mine.discard(h)
                                shed.add(h)
                                del self._owners[h]
                                self._last_push.pop(h, None)
                                self._send(writer,
                                           _frame(CLOSED, _U32.pack(h)))
                        else:
                            flush = bool(payload[4]) if ln > 4 else True
                            eng.close_stream(h, flush=flush)
                            mine.discard(h)
                            del self._owners[h]
                            self._last_push.pop(h, None)
                            if eng.is_open(h):  # flush: windows pending
                                self._closing[h] = writer
                            else:
                                self._send(writer,
                                           _frame(CLOSED, _U32.pack(h)))
                    else:
                        self._send(writer, _frame(
                            ERROR, _U32.pack(CONN_HANDLE)
                            + f"unknown frame type 0x{ftype:02x}"
                            .encode()))
        except (asyncio.IncompleteReadError, OSError):
            # producer vanished (reset, broken pipe mid-_send, timeout): the
            # finally below abandons its streams. OSError is the superset:
            # BrokenPipeError is a sibling of ConnectionResetError
            pass
        finally:
            async with self._lock:
                for h in mine:  # producer vanished: abandon, don't flush
                    # ownership check: a ticker-shed handle may have been
                    # recycled to another connection by now
                    if self._owners.get(h) is writer:
                        del self._owners[h]
                        self._last_push.pop(h, None)
                        if self.engine.is_open(h):
                            self.engine.close_stream(h, flush=False)
                self._shed.pop(writer, None)
            writer.close()


class ServeClient:
    """Minimal blocking client (tests, feeders, health checks).

    Push float waves with :meth:`push` (converted to the daemon's transport
    on this side of the wire); SCORE/CLOSED events arrive via
    :meth:`events`.
    """

    def __init__(self, *, unix_path: Optional[str] = None,
                 host: Optional[str] = None, port: Optional[int] = None,
                 timeout: float = 60.0):
        import socket as _socket

        if unix_path is not None:
            self._sock = _socket.socket(_socket.AF_UNIX,
                                        _socket.SOCK_STREAM)
            self._sock.connect(unix_path)
        else:
            self._sock = _socket.create_connection((host, port),
                                                   timeout=timeout)
        self._sock.settimeout(timeout)
        self._buf = b""
        # SCORE/CLOSED frames read while waiting for an OPENED/PONG reply;
        # drained first by events()
        self._pending = []
        ftype, payload = self._read_frame()
        if ftype != HELLO:
            raise RuntimeError(f"expected HELLO, got 0x{ftype:02x}")
        (self.proto, self.sample_rate, self.duration, self.hop,
         code, self.max_streams) = _HELLO.unpack(payload)
        if self.proto != PROTO_VERSION:
            raise RuntimeError(
                f"daemon speaks protocol v{self.proto}, this client "
                f"v{PROTO_VERSION}")
        self.transport = {v: k for k, v in TRANSPORT_CODES.items()}[code]
        self._dtype = _TRANSPORT_DTYPES[code]

    # --------------------------------------------------------------- framing

    def _read_frame(self):
        while len(self._buf) < _HDR.size:
            self._buf += self._recv()
        ftype, ln = _HDR.unpack_from(self._buf)
        while len(self._buf) < _HDR.size + ln:
            self._buf += self._recv()
        payload = self._buf[_HDR.size:_HDR.size + ln]
        self._buf = self._buf[_HDR.size + ln:]
        return ftype, payload

    def _recv(self):
        data = self._sock.recv(1 << 16)
        if not data:
            raise ConnectionError("daemon closed the connection")
        return data

    def _expect(self, want):
        """Next reply frame of type ``want``; ERROR frames raise.

        SCORE/CLOSED frames the ticker interleaves ahead of the reply
        (routine on a live daemon: another stream scores while this one
        OPENs or PINGs) are queued for :meth:`events`, not errors.
        """
        while True:
            ftype, payload = self._read_frame()
            if ftype in (SCORE, CLOSED):
                self._pending.append((ftype, payload))
                continue
            if ftype == ERROR:
                raise RuntimeError(payload[4:].decode() or "daemon error")
            if ftype != want:
                raise RuntimeError(
                    f"expected 0x{want:02x}, got 0x{ftype:02x}")
            return payload

    # ------------------------------------------------------------------- api

    def open(self, name: str = "") -> int:
        self._sock.sendall(_frame(OPEN, name.encode()))
        return _U32.unpack(self._expect(OPENED))[0]

    def push(self, handle: int, wave: np.ndarray) -> None:
        wave = np.asarray(wave).reshape(-1)
        if wave.dtype != self._dtype:
            if self.transport == "int16":
                if wave.dtype != np.int16:
                    wave = np.clip(np.rint(
                        wave.astype(np.float32) * 32768.0),
                        -32768, 32767).astype(np.int16)
            elif self.transport == "mulaw8":
                if wave.dtype == np.int16:
                    wave = wave.astype(np.float32) / 32768.0
                wave = mulaw_encode(wave)
            else:
                if wave.dtype == np.int16:
                    wave = wave.astype(np.float32) / 32768.0
                wave = wave.astype(np.float32)
        self._sock.sendall(_frame(PUSH, _U32.pack(handle)
                                  + wave.tobytes()))

    def close(self, handle: int, flush: bool = True) -> None:
        self._sock.sendall(_frame(CLOSE, _U32.pack(handle)
                                  + bytes([int(flush)])))

    def ping(self) -> None:
        self._sock.sendall(_frame(PING))
        self._expect(PONG)

    def events(self):
        """Yield ("score", handle, start_sample, score, flags) and
        ("closed", handle) events until the socket times out or closes.
        ``flags``: bitwise OR of FLAG_ESCALATED / FLAG_GATED (0 for a plain
        scored window)."""
        while True:
            if self._pending:
                ftype, payload = self._pending.pop(0)
            else:
                ftype, payload = self._read_frame()
            if ftype == SCORE:
                h, start, score, flags = _SCORE.unpack(payload)
                yield ("score", h, start, score, flags)
            elif ftype == CLOSED:
                yield ("closed", _U32.unpack(payload)[0])
            elif ftype == ERROR:
                raise RuntimeError(payload[4:].decode())

    def collect(self, want_closed: set):
        """Drain events until every handle in ``want_closed`` closed;
        returns {handle: [(start_sample, score, flags), ...]}."""
        out = {h: [] for h in want_closed}
        pending = set(want_closed)
        for ev in self.events():
            if ev[0] == "score" and ev[1] in out:
                out[ev[1]].append((ev[2], ev[3], ev[4]))
            elif ev[0] == "closed":
                pending.discard(ev[1])
                if not pending:
                    return out
        raise RuntimeError("daemon connection ended early")

    def close_socket(self):
        self._sock.close()

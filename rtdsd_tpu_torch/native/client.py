"""ctypes binding of the port's native daemon client (``serve_client.cpp``
beside this file), the port of ``rtdsd_tpu/native/client.py``.

The C library speaks the daemon's wire protocol v1
(``rtdsd_tpu_torch/engine/netserve.py``) with no dependencies, so producers
that are not Python processes can stream audio in; this binding serves
tests and Python deployments that want the C transport encoding, with the
API of :class:`rtdsd_tpu_torch.engine.netserve.ServeClient`:

- ``available() -> bool`` (the library is built and loads);
- ``build() -> str`` (compile the library if it is missing, and load it);
- ``build_feeder() -> str`` (the standalone WAV feeder binary,
  ``-DRTDSD_FEED_MAIN``: ``feeder unix:/path.sock|host:port file.wav
  [--realtime]`` streams a PCM16 mono WAV hop by hop and prints
  ``window @start score s`` lines, then ``file mean``);
- ``NativeServeClient(unix_path=... | host=..., port=...)`` with ``open``,
  ``push`` (C-side transport conversion), ``push_bytes`` (raw transport
  bytes), ``close``, ``ping``, ``events(timeout_ms)`` (("score", h, start,
  score, flags) / ("closed", h) / ("error", h, message)) and ``collect``.

Both outputs are built at first use with the host compiler into
``build/rtdsd_tpu_torch/``, named by a hash of the source and flags as the
native decoder is (``native/flac.py``). A failed build or load raises with
the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from rtdsd_tpu_torch.ops.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "serve_client.cpp")
LIB_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
FEED_FLAGS = ["-O2", "-std=c++17", "-DRTDSD_FEED_MAIN"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _Event(ctypes.Structure):
    _fields_ = [("type", ctypes.c_int32),
                ("handle", ctypes.c_uint32),
                ("start_sample", ctypes.c_uint64),
                ("score", ctypes.c_float),
                ("flags", ctypes.c_uint8)]


def _output_path(stem: str, flags: List[str], suffix: str) -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}{suffix}")


def library_path() -> str:
    return _output_path("librtdsd_client", LIB_FLAGS, ".so")


def feeder_path() -> str:
    return _output_path("rtdsd_feed", FEED_FLAGS, "")


def _compile(flags: List[str], out: str, what: str) -> str:
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        r = subprocess.run(["g++", *flags, SRC, "-o", tmp],
                           capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build the {what}: {e}") \
            from None
    if r.returncode != 0:
        raise RuntimeError(f"{what} build failed (g++ rc {r.returncode}):\n"
                           f"{(r.stdout + r.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    P = ctypes.c_void_p
    lib.rtdsd_connect_unix.restype = P
    lib.rtdsd_connect_unix.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_int]
    lib.rtdsd_connect_tcp.restype = P
    lib.rtdsd_connect_tcp.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int]
    lib.rtdsd_disconnect.restype = None
    lib.rtdsd_disconnect.argtypes = [P]
    for name in ("rtdsd_proto", "rtdsd_sample_rate", "rtdsd_window_samples",
                 "rtdsd_hop_samples", "rtdsd_max_streams"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint32
        fn.argtypes = [P]
    lib.rtdsd_transport.restype = ctypes.c_int
    lib.rtdsd_transport.argtypes = [P]
    lib.rtdsd_last_error.restype = ctypes.c_char_p
    lib.rtdsd_last_error.argtypes = [P]
    lib.rtdsd_open.restype = ctypes.c_int64
    lib.rtdsd_open.argtypes = [P, ctypes.c_char_p]
    lib.rtdsd_push.restype = ctypes.c_int
    lib.rtdsd_push.argtypes = [P, ctypes.c_uint32,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.c_uint32]
    lib.rtdsd_push_bytes.restype = ctypes.c_int
    lib.rtdsd_push_bytes.argtypes = [P, ctypes.c_uint32, ctypes.c_void_p,
                                     ctypes.c_uint32]
    lib.rtdsd_close_stream.restype = ctypes.c_int
    lib.rtdsd_close_stream.argtypes = [P, ctypes.c_uint32, ctypes.c_int]
    lib.rtdsd_ping.restype = ctypes.c_int
    lib.rtdsd_ping.argtypes = [P]
    lib.rtdsd_next_event.restype = ctypes.c_int
    lib.rtdsd_next_event.argtypes = [P, ctypes.POINTER(_Event),
                                     ctypes.c_int]
    return lib


def build() -> str:
    """Compile the client library if it is missing and load it; returns
    its path."""
    global _lib
    with _lock:
        path = _compile(LIB_FLAGS, library_path(), "native daemon client")
        if _lib is None:
            _lib = _bind(path)
    return path


def build_feeder() -> str:
    """Compile the feeder binary if it is missing; returns its path."""
    with _lock:
        return _compile(FEED_FLAGS, feeder_path(), "native daemon feeder")


def available() -> bool:
    """True when the library is built (no build is started) and loads."""
    if _lib is None and os.path.exists(library_path()):
        try:
            build()
        except OSError:
            return False
    return _lib is not None


_TRANSPORT_NAMES = {0: "float32", 1: "int16", 2: "mulaw8"}


class NativeServeClient:
    """Blocking daemon client backed by the C library (built at first
    use)."""

    def __init__(self, *, unix_path: Optional[str] = None,
                 host: Optional[str] = None, port: Optional[int] = None):
        build()
        lib = self._lib = _lib
        self._c = None
        err = ctypes.create_string_buffer(256)
        if unix_path is not None:
            self._c = lib.rtdsd_connect_unix(unix_path.encode(), err, 256)
        else:
            self._c = lib.rtdsd_connect_tcp(host.encode(), int(port),
                                            err, 256)
        if not self._c:
            raise ConnectionError(err.value.decode() or "connect failed")
        self.proto = lib.rtdsd_proto(self._c)
        self.sample_rate = lib.rtdsd_sample_rate(self._c)
        self.duration = lib.rtdsd_window_samples(self._c)
        self.hop = lib.rtdsd_hop_samples(self._c)
        self.transport = _TRANSPORT_NAMES[lib.rtdsd_transport(self._c)]
        self.max_streams = lib.rtdsd_max_streams(self._c)

    # ------------------------------------------------------------------ api

    def _err(self) -> str:
        return self._lib.rtdsd_last_error(self._c).decode()

    def open(self, name: str = "") -> int:
        h = self._lib.rtdsd_open(self._c, name.encode())
        if h < 0:
            raise RuntimeError(self._err())
        return int(h)

    def push(self, handle: int, wave: np.ndarray) -> None:
        wave = np.ascontiguousarray(np.asarray(wave).reshape(-1),
                                    np.float32)
        rc = self._lib.rtdsd_push(
            self._c, handle,
            wave.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(wave))
        if rc != 0:
            raise RuntimeError(self._err())

    def push_bytes(self, handle: int, data: bytes) -> None:
        rc = self._lib.rtdsd_push_bytes(self._c, handle, data, len(data))
        if rc != 0:
            raise RuntimeError(self._err())

    def close(self, handle: int, flush: bool = True) -> None:
        rc = self._lib.rtdsd_close_stream(self._c, handle, int(flush))
        if rc != 0:
            raise RuntimeError(self._err())

    def ping(self) -> None:
        if self._lib.rtdsd_ping(self._c) != 0:
            raise RuntimeError(self._err())

    def events(self, timeout_ms: int = 60000):
        """Yield events until a read times out or the connection drops.

        ERROR frames are yielded as ("error", handle, message): the consumer
        decides whether one bad stream is fatal."""
        ev = _Event()
        while True:
            rc = self._lib.rtdsd_next_event(self._c, ctypes.byref(ev),
                                            timeout_ms)
            if rc == 0:
                return  # timeout
            if rc < 0:
                raise ConnectionError(self._err())
            if ev.type == 1:
                yield ("score", ev.handle, int(ev.start_sample),
                       float(ev.score), int(ev.flags))
            elif ev.type == 2:
                yield ("closed", ev.handle)
            else:
                yield ("error", ev.handle, self._err())

    def collect(self, want_closed, timeout_ms: int = 60000):
        """Drain events until every handle in ``want_closed`` closed;
        returns {handle: [(start_sample, score, flags), ...]}. An ERROR
        event raises."""
        out = {h: [] for h in want_closed}
        pending = set(want_closed)
        for ev in self.events(timeout_ms):
            if ev[0] == "score" and ev[1] in out:
                out[ev[1]].append((ev[2], ev[3], ev[4]))
            elif ev[0] == "closed":
                pending.discard(ev[1])
                if not pending:
                    return out
            elif ev[0] == "error":
                raise RuntimeError(ev[2])
        raise TimeoutError("daemon events timed out before CLOSED")

    def close_socket(self) -> None:
        if self._c:
            self._lib.rtdsd_disconnect(self._c)
            self._c = None

    def __del__(self):
        try:
            self.close_socket()
        except Exception:
            pass

"""ctypes binding of the port's native decoder and batch loader
(``flac_decoder.cpp`` beside this file), with the signatures of the JAX
package's ``rtdsd_tpu/native/flac.py``:

- ``decode(path) -> (float32 (C, T) array, sample_rate)``;
- ``load_batch_status(paths, duration, seed, threads, expected_sr)
  -> ((B, duration) float32 waves, int32 indices of the failed files)``.

The library is built at first use with the host compiler
(``g++ -O2 -std=c++17 -shared -fPIC -pthread``) into
``build/rtdsd_tpu_torch/`` beside the package, named by a hash of the
source and flags as the CUDA kernels are (``ops/build.py``), so a changed
source is rebuilt. A failed build or load raises with the compiler's
message: there is no quiet fall-back to the Python decode path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Tuple

import numpy as np

from rtdsd_tpu_torch.ops.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "flac_decoder.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"librtdsd_native-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                           capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build the native decoder: "
                           f"{e}") from None
    if r.returncode != 0:
        raise RuntimeError(f"native decoder build failed (g++ rc "
                           f"{r.returncode}):\n{(r.stdout + r.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The library, built and bound on the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.rtdsd_decode.restype = ctypes.c_int64
            lib.rtdsd_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.rtdsd_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.rtdsd_load_batch_status.restype = ctypes.c_int
            lib.rtdsd_load_batch_status.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64,
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            _lib = lib
    return _lib


def decode(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC or WAV file -> (float32 (C, T), sample rate)."""
    lib = load()
    out = ctypes.POINTER(ctypes.c_float)()
    channels, sr = ctypes.c_int(), ctypes.c_int()
    n = lib.rtdsd_decode(path.encode(), ctypes.byref(out),
                         ctypes.byref(channels), ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"native decode failed: {path}")
    c = channels.value
    arr = np.ctypeslib.as_array(out, shape=(int(n) * c,)).copy()
    lib.rtdsd_free(out)
    return arr.reshape(-1, c).T.copy(), sr.value


def load_batch_status(paths: List[str], duration: int, seed: int = 0,
                      threads: int = 0, expected_sr: int = 16000
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode, take channel 0, resample linearly to ``expected_sr`` where
    the file's rate differs (0: never), repeat-tile and cut ``duration``
    samples of each file on ``threads`` threads. ``seed`` 0 takes the first
    window, any other seed a random start per (seed, row). Returns
    ((B, duration) float32, (B',) int32 indices of the files that failed,
    whose rows are zero)."""
    lib = load()
    if threads <= 0:
        threads = min(len(paths), os.cpu_count() or 1)
    out = np.empty((len(paths), duration), np.float32)
    status = np.zeros((len(paths),), np.int32)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    lib.rtdsd_load_batch_status(
        c_paths, len(paths), duration, seed,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), threads,
        expected_sr, status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return out, np.where(status != 0)[0].astype(np.int32)

"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface and loaded with ``ctypes``.
Libraries go to ``build/rtdsd_tpu_torch/`` beside the package, named by a
hash of their source and flags, so a changed source is rebuilt and an
unchanged one is reused. The first kernel call builds every missing library
at once, one ``nvcc`` process per source, all started together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception, so a refused launch
(too much shared memory, a bad configuration) never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "rtdsd_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Kernel source stems, e.g. ``["gat", "mha_small_t"]``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def library_path(stem: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(CSRC, stem + ".cu"), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (on PATH or under "
                           "/usr/local/cuda/bin)")
    return path


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, in parallel.

    Returns ``{stem: seconds}`` for the sources built now; the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills) is kept in
    ``<library>.log``. Raises if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for stem in sources():
        out = library_path(stem)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(out + ".log", "w")
        procs[stem] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, stem + ".cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, out, log,
            time.perf_counter())
    took, failed = {}, []
    for stem, (proc, tmp, out, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        took[stem] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            with open(out + ".log") as f:
                failed.append(f"{stem}.cu (nvcc rc {rc}):\n{f.read()[-4000:]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def library(stem: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Load ``csrc/<stem>.cu``'s library (building it first if needed) and
    declare its entry points: ``signatures`` maps each C function to its
    ``argtypes``; every one returns a CUDA error code as ``int``."""
    with _lock:
        lib = _loaded.get(stem)
        if lib is None:
            if not os.path.exists(library_path(stem)):
                build_all()
            lib = ctypes.CDLL(library_path(stem))
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[stem] = lib
    return lib


def check(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")

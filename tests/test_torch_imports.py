"""The port stands alone: no module of ``rtdsd_tpu_torch`` and no line of
``chip_smoke.py`` imports JAX, flax, optax, msgpack, safetensors, orbax,
transformers or the JAX package (the GPU machine has none of them), and its
entry points pick the GPU unless told otherwise."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from rtdsd_tpu_torch.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "safetensors",
             "orbax", "transformers", "rtdsd_tpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_files():
    files = sorted(glob.glob(os.path.join(REPO, "rtdsd_tpu_torch", "**", "*.py"),
                             recursive=True))
    return files + [os.path.join(REPO, "chip_smoke.py")]


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 20 and all(os.path.exists(f) for f in files)
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, f"forbidden imports: {bad}"


def test_cli_import_loads_no_jax():
    code = ("import sys, rtdsd_tpu_torch.cli.main, rtdsd_tpu_torch.ops.gat, "
            "rtdsd_tpu_torch.cli.stream, rtdsd_tpu_torch.cli.serve, "
            "rtdsd_tpu_torch.engine.serving, rtdsd_tpu_torch.cli.daemon, "
            "rtdsd_tpu_torch.engine.netserve, rtdsd_tpu_torch.native.client, "
            "rtdsd_tpu_torch.cli.convert, rtdsd_tpu_torch.ops.augment, "
            "rtdsd_tpu_torch.data.host_augment, rtdsd_tpu_torch.cli.main_kd, "
            "rtdsd_tpu_torch.engine.kd, rtdsd_tpu_torch.models.taps; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_device_defaults_to_cuda():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("mps")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()

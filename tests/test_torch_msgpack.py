"""flax's msgpack bytes read and written by the port
(``rtdsd_tpu_torch/utils/flax_msgpack.py``) against flax, on the CPU.

Files the JAX package writes (``save_ssl_params``, ``save_params_only``,
``save_checkpoint`` with its optax state) read by the port give flax's
``msgpack_restore`` tree, every leaf bit for bit and of the same dtype;
the port's files read by ``msgpack_restore`` give the tree written, and
without tensor leaves the port writes ``msgpack_serialize``'s bytes.
bfloat16 leaves come back as ``torch.bfloat16`` tensors with the same
bits, arrays over ``MAX_CHUNK_SIZE`` in flax's chunked form (the limit
patched small on both sides), numpy scalars as numpy scalars.
"""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization as ser

from rtdsd_tpu_torch.utils import flax_msgpack

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, path=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            yield from _flat(v, f"{path}/{k}")
    else:
        yield path, tree


def _bits(x):
    """(dtype name, shape, raw bytes) of a leaf from either side."""
    if isinstance(x, torch.Tensor):
        name = {torch.bfloat16: "bfloat16"}.get(x.dtype, str(x.dtype))
        return name, tuple(x.shape), x.view(torch.int16).numpy().tobytes() \
            if x.dtype == torch.bfloat16 else x.numpy().tobytes()
    if isinstance(x, (np.ndarray, np.generic)):
        a = np.asarray(x)
        return a.dtype.name, a.shape, a.tobytes()
    return type(x).__name__, (), x


def assert_same_tree(got, want):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert g.keys() == w.keys()
    for k in w:
        assert _bits(g[k]) == _bits(w[k]), k


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX package's three writers on a tiny My_XLSR_AASIST's seeded
    variables (and an AdamW state on them)."""
    from rtdsd_tpu.cli.common import save_ssl_params
    from rtdsd_tpu.engine import checkpoint as jax_ckpt
    from rtdsd_tpu.engine.steps import TrainState, make_optimizer
    from rtdsd_tpu.models.registry import get_model
    from _torch_track import random_variables

    root = tmp_path_factory.mktemp("msgpack")
    spec = get_model("My_XLSR_AASIST", num_layers=2, w2v=W2V)
    v = random_variables(spec.module, np.zeros((2, 8000), np.float32),
                         train=False)
    tx = make_optimizer(1e-3, 1e-4)
    params = jax.tree_util.tree_map(jax.numpy.asarray, v["params"])
    state = TrainState(step=jax.numpy.asarray(7, jax.numpy.int32),
                       params=params, batch_stats=v["batch_stats"],
                       opt_state=tx.init(params))
    save_ssl_params(str(root / "ssl"), v["params"]["ssl_model"])
    jax_ckpt.save_params_only(str(root / "weights"), v["params"],
                              v["batch_stats"])
    jax_ckpt.save_checkpoint(str(root / "state"), state, meta={"epoch": 3})
    return {"ssl": root / "ssl" / "weights.msgpack",
            "weights": root / "weights" / "weights.msgpack",
            "state": root / "state" / "state.msgpack"}


@pytest.mark.parametrize("which", ["ssl", "weights", "state"])
def test_port_reads_jax_files(jax_files, which):
    path = jax_files[which]
    got = flax_msgpack.read(str(path))
    want = ser.msgpack_restore(path.read_bytes())
    assert_same_tree(got, want)
    assert flax_msgpack.restore(path.read_bytes()).keys() == want.keys()
    if which == "state":
        assert int(got["step"]) == 7 and "opt_state" in got
        leaf = got["params"]["backend"]["LL"]["kernel"]
        assert leaf.flags.writeable and not leaf.flags.owndata


def test_jax_reads_port_files(jax_files, tmp_path):
    """The port rewrites each JAX file's tree: flax reads it back equal,
    and the bytes are ``msgpack_serialize``'s."""
    for path in jax_files.values():
        tree = ser.msgpack_restore(path.read_bytes())
        out = tmp_path / path.name
        flax_msgpack.write(str(out), tree)
        assert_same_tree(ser.msgpack_restore(out.read_bytes()), tree)
        assert out.read_bytes() == ser.msgpack_serialize(tree)


def _mixed_tree():
    rng = np.random.default_rng(3)
    bf = rng.standard_normal((5, 3)).astype(ml_dtypes.bfloat16)
    return bf, {
        "f32": rng.standard_normal((4, 6)).astype(np.float32),
        "i8": rng.integers(-128, 127, (3, 2), dtype=np.int8),
        "empty": np.zeros((0, 4), np.float32),
        "flags": np.array([True, False]),
        "scalars": {"f": np.float32(2.5), "i": np.int64(-3),
                    "zero_d": np.asarray(1.5, np.float64)},
        "python": {"int": 70000, "neg": -40, "big": 2 ** 40, "float": 0.125,
                   "bool": True, "none": None, "str": "x" * 40},
        "list": [np.ones(2, np.float32), 3]}


def test_bf16_and_scalar_leaves_both_ways(tmp_path):
    bf, tree = _mixed_tree()
    # JAX-written: bfloat16 comes back as a torch bfloat16 tensor
    blob = ser.msgpack_serialize({**tree, "bf16": bf})
    got = flax_msgpack.restore(blob)
    assert got["bf16"].dtype == torch.bfloat16
    assert got["bf16"].view(torch.int16).numpy().tobytes() == bf.tobytes()
    assert isinstance(got["scalars"]["f"], np.float32)
    assert isinstance(got["scalars"]["i"], np.int64)
    assert isinstance(got["list"], list) and got["list"][1] == 3
    # port-written from a torch bfloat16 tensor: flax reads ml_dtypes bf16
    t = torch.from_numpy(bf.view(np.int16).copy()).view(torch.bfloat16)
    flax_msgpack.write(str(tmp_path / "w.msgpack"), {**tree, "bf16": t})
    back = ser.msgpack_restore((tmp_path / "w.msgpack").read_bytes())
    assert back["bf16"].dtype == ml_dtypes.bfloat16
    assert back["bf16"].tobytes() == bf.tobytes()
    assert_same_tree(flax_msgpack.restore(blob), back)


def test_chunked_arrays_both_ways(monkeypatch):
    monkeypatch.setattr(ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(4)
    bf = rng.standard_normal((9, 7)).astype(ml_dtypes.bfloat16)
    tree = {"big": rng.standard_normal((10, 7)).astype(np.float32),
            "small": np.arange(3, dtype=np.int32)}
    blob = ser.msgpack_serialize({**tree, "bf": bf})
    assert b"__msgpack_chunked_array__" in blob
    got = flax_msgpack.restore(blob)
    assert np.array_equal(got["big"], tree["big"])
    assert got["bf"].view(torch.int16).numpy().tobytes() == bf.tobytes()
    mine = flax_msgpack.packb(tree)
    assert mine == ser.msgpack_serialize(tree)
    assert np.array_equal(ser.msgpack_restore(mine)["big"], tree["big"])


def test_malformed_bytes_raise():
    blob = ser.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(blob[:-2])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.restore(blob + b"\x00")
    with pytest.raises(TypeError, match="not all str"):
        flax_msgpack.packb({1: 2})

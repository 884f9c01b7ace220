"""int8 scoring of the port (``ops/quant.py``, ``W8Linear`` /
``W8A8Linear``, ``models/quantize.py``, ``--w8`` / ``--w8a8``) against the
JAX package, on the CPU.

Off the TPU the JAX quantizer rounds to nearest, and so does the port's
plain version on a CPU tensor: the two must agree bit for bit. The port's
stochastic rounding (the CUDA kernel's mode) is checked here through its
plain version, which reproduces the kernel's random bits; tests marked
``gpu`` hold the kernel against it on the card. Inputs are made with
``numpy.random.default_rng``.

Tolerances. W8 in float32 differs from JAX by summation order only. W8A8
rounds every activation to int8, so where an input sits within float32
noise of a rounding tie the two frameworks may round it one step apart:
its comparisons allow a small share of such flips, bounded against JAX's
own w8a8-vs-w8 gap. bf16 is held within twice JAX's own bf16-vs-f32 gap
plus 0.02, as ``tests/test_torch_models.py`` holds the float model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu.models.quantize import (quantize_encoder_params,
                                       quantize_variables)
from rtdsd_tpu.models.quantize import w8_bytes_saved as jax_bytes_saved
from rtdsd_tpu.models.wav2vec2 import (W8A8Dense, W8Dense, Wav2Vec2Config,
                                       Wav2Vec2Encoder as JaxEncoder)
from rtdsd_tpu.ops.pallas.quant import quantize_int8 as jax_quantize_int8
from rtdsd_tpu_torch.models import convert, quantize, wav2vec2
from rtdsd_tpu_torch.ops import quant

from _torch_track import make_track

TINY = Wav2Vec2Config(          # tests/test_quantize.py's encoder
    conv_layers=((64, 10, 5), (64, 3, 2), (64, 2, 2)),
    encoder_embed_dim=64, encoder_ffn_dim=128, encoder_heads=4,
    encoder_layers=3, conv_pos=16, conv_pos_groups=4)
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


def _matrix(seed, shape):
    """Columns of different magnitudes, as a weight matrix has."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            * rng.uniform(0.01, 3.0, shape[1])).astype(np.float32)


# ------------------------------------------------------------ quantize_int8

@pytest.mark.parametrize("shape", [(64, 32), (100, 130), (257, 384)])
def test_quantize_rtn_matches_jax_bit_exact(shape):
    x = _matrix(0, shape)
    jv, js = jax_quantize_int8(jnp.asarray(x), interpret=True)
    before = quant.quantize_int8.launches
    pv, ps = quant.quantize_int8(torch.from_numpy(x))
    assert quant.quantize_int8.launches == before       # plain version
    assert pv.dtype == torch.int8 and ps.dtype == torch.float32
    assert ps.shape == (1, shape[1])
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def _mix32(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    return x ^ (x >> 16)


@pytest.mark.parametrize("seed", [0, 7919 * 144, 2 ** 31 + 5, -3])
def test_random_bits_match_python_integers(seed):
    """The int64 tensor version of the kernel's hash equals the same hash
    on Python integers (no product overflows)."""
    bits = quant.random_bits(seed, 5, 7)
    key = _mix32(seed & 0xFFFFFFFF)
    want = [[_mix32((_mix32((key + r) & 0xFFFFFFFF) + c) & 0xFFFFFFFF)
             for c in range(7)] for r in range(5)]
    assert bits.tolist() == want


def test_stochastic_plain_is_seeded_bounded_and_unbiased():
    x = torch.from_numpy(_matrix(1, (2048, 64)))
    v1, s1 = quant.quantize_int8(x, seed=3, stochastic=True)
    v2, s2 = quant.quantize_int8(x, seed=3, stochastic=True)
    v3, _ = quant.quantize_int8(x, seed=4, stochastic=True)
    rtn, s_rtn = quant.quantize_int8(x)
    assert torch.equal(v1, v2) and torch.equal(s1, s2)
    assert torch.equal(s1, s_rtn)            # scales do not depend on rounding
    assert (v1 != v3).float().mean() > 0.2   # another seed, other roundings
    assert (v1 != rtn).any()
    scaled = x.double() / s1.double()
    err = v1.double() - scaled
    assert err.abs().max() < 1.0             # |dequant - x| < scale
    frac = scaled - scaled.floor()
    # E[err] = 0 with variance frac (1 - frac) per element: each column's
    # mean error within 6 standard errors, and the whole matrix's too
    se_col = (frac * (1 - frac)).sum(0).sqrt() / x.shape[0]
    assert (err.mean(0).abs() < 6 * se_col).all()
    se_all = (frac * (1 - frac)).sum().sqrt() / err.numel()
    assert err.mean().abs() < 6 * se_all


def test_dequantize_and_quantized_matmul():
    x = torch.from_numpy(_matrix(2, (16, 24)))
    w = torch.from_numpy(_matrix(3, (24, 8)))
    vals, scales = quant.quantize_int8(w)
    deq = quant.dequantize_int8(vals, scales)
    assert (deq - w).abs().max() <= 0.5 * scales.max() * (1 + 1e-6)
    torch.testing.assert_close(quant.quantized_matmul(x, vals, scales),
                               x @ deq, rtol=1e-5, atol=1e-5)


def _layouts():
    """(name, x, read in place, transposed) for kernel_operand."""
    w = torch.from_numpy(_matrix(5, (12, 8)))             # a (out, in) weight
    return [("row_major", w, True, False),
            ("weight_t", w.t(), True, True),
            ("weight_t_rows", w[:5].t(), True, True),
            ("single_row", w[:1], True, False),
            ("column_slice", w[:, ::2], False, False),
            ("row_slice_t", w.t()[::2], False, False),
            ("broadcast", w[:1].expand(4, 8), False, False),
            ("bf16_weight_t", w.bfloat16().t(), False, False)]


@pytest.mark.parametrize("case", range(len(_layouts())),
                         ids=[c[0] for c in _layouts()])
def test_quantize_kernel_operand_layouts(case):
    """The kernel reads a row-major float32 matrix and the transposed view
    of one (a model's weight.t()) in place; any other layout or dtype is
    made a row-major float32 copy first."""
    _, x, in_place, transposed = _layouts()[case]
    got, trans = quant.kernel_operand(x)
    assert trans == transposed and got.dtype == torch.float32
    assert torch.equal(got, x.float())
    if in_place:
        assert got.data_ptr() == x.data_ptr() and got.stride() == x.stride()
    else:
        assert got.is_contiguous() and got.data_ptr() != x.data_ptr()


def test_quantizer_passes_weights_without_a_copy(tiny_encoder, monkeypatch):
    """quantize_state_dict hands every matrix to the kernel as the
    transposed view of its weight, which the kernel reads in place."""
    _, sd = tiny_encoder
    seen = []

    def record(x, seed=0, stochastic=None):
        operand, transposed = quant.kernel_operand(x)
        seen.append((operand.data_ptr() == x.data_ptr(), transposed))
        return quant.quantize_int8(x, seed, stochastic)

    monkeypatch.setattr(quantize, "quantize_int8", record)
    quantize.quantize_state_dict({k: t.contiguous() for k, t in sd.items()})
    assert seen == [(True, True)] * 18


# ------------------------------------------------------- W8 / W8A8 layers

def _layer_inputs(seed, rows=5, k=16, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, rows, k)).astype(np.float32)
    vals = rng.integers(-128, 128, (k, n)).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, (1, n)).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    return x, vals, scales, bias


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_layers_match_jax(a8, dtype):
    x, vals, scales, bias = _layer_inputs(4)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jax_cls, port_cls = ((W8A8Dense, wav2vec2.W8A8Linear) if a8
                         else (W8Dense, wav2vec2.W8Linear))
    want = np.asarray(jax_cls(8, dtype=jdt).apply(
        {"params": {"vals": vals, "scales": scales, "bias": bias}},
        jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    layer = port_cls(16, 8)
    layer.load_state_dict({"vals": torch.from_numpy(vals),
                           "scales": torch.from_numpy(scales),
                           "bias": torch.from_numpy(bias)}, strict=True)
    got = layer(torch.from_numpy(x).to(tdt), tdt)
    assert got.dtype == tdt
    if dtype == "float32":
        # same int8 operands, summation order only
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        # bf16 outputs of magnitude ~10: the two frameworks may round the
        # product or the epilogue at other places, a step or two of
        # 2^-8 relative
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("rows", [1, 5, 17, 199])
def test_int8_matmul_pads_rows_exactly(rows):
    rng = np.random.default_rng(rows)
    a = torch.from_numpy(rng.integers(-128, 128, (rows, 32)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (32, 16)).astype(np.int8))
    got = wav2vec2.int8_matmul(a[None], b)
    assert got.dtype == torch.int32 and got.shape == (1, rows, 16)
    assert torch.equal(got[0], a.int() @ b.int())


# ----------------------------------------------------------- the quantizer

@pytest.fixture(scope="module")
def tiny_encoder():
    """JAX float params of tests/test_quantize.py's TINY encoder and the
    port's state dict of the same weights."""
    params = JaxEncoder(TINY).init(jax.random.key(0),
                                   jnp.zeros((1, 3200), jnp.float32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, convert._w2v(params, "")


def test_quantizer_matches_jax_tree(tiny_encoder):
    params, sd = tiny_encoder
    want = quantize_encoder_params(params)["layers"]["layer"]
    got = quantize.quantize_state_dict(sd)
    names = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
             "fc1": "fc1", "fc2": "fc2"}
    for jax_name, port_name in names.items():
        for i in range(TINY.encoder_layers):
            base = f"encoder.layers.{i}.{port_name}."
            assert base + "weight" not in got
            np.testing.assert_array_equal(
                got[base + "vals"].numpy(), np.asarray(want[jax_name]["vals"][i]))
            np.testing.assert_array_equal(
                got[base + "scales"].numpy(),
                np.asarray(want[jax_name]["scales"][i]))
    # everything else passes through untouched
    for k, t in sd.items():
        if k in got:
            assert got[k] is t
    assert quantize.w8_bytes_saved(sd) == jax_bytes_saved(params) \
        == 3 * (4 * 64 * 64 + 2 * 64 * 128)
    assert quantize.w8_bytes_saved(got) == 0


def test_quantizer_seed_schedule(tiny_encoder, monkeypatch):
    """seed + 7919 n for the n-th matrix, taken as the JAX package takes
    them: all layers of q_proj, then k_proj, ..., fc2."""
    _, sd = tiny_encoder
    seen = []

    def record(x, seed=0, stochastic=None):
        seen.append((x.shape, seed))
        return quant.quantize_int8(x, seed, stochastic)

    monkeypatch.setattr(quantize, "quantize_int8", record)
    quantize.quantize_state_dict(sd, seed=11)
    assert [s for _, s in seen] == [11 + 7919 * n for n in range(1, 19)]
    d, f = TINY.encoder_embed_dim, TINY.encoder_ffn_dim
    assert [shape for shape, _ in seen] == [(d, d)] * 12 + [(d, f)] * 3 \
        + [(f, d)] * 3


def test_quantizer_rejects_state_dict_without_matmuls():
    with pytest.raises(ValueError, match="no transformer matmul"):
        quantize.quantize_state_dict({"backend.fc1.weight": torch.zeros(4, 4)})


@pytest.fixture(scope="module")
def tiny_model():
    """A tiny My_XLSR_AASIST: numpy variables, JAX-quantized variables, and
    input waves."""
    spec = jax_registry.get_model("My_XLSR_AASIST", num_layers=2, w2v=W2V)
    waves = (np.random.default_rng(0).standard_normal((2, 8000)) * 0.3
             ).astype(np.float32)
    v = jax.jit(lambda w: spec.module.init(jax.random.key(0), w, train=False))(
        jnp.asarray(waves))
    v = jax.tree_util.tree_map(np.asarray, v)
    qv = jax.tree_util.tree_map(np.asarray, quantize_variables(v))
    return spec.module.w2v_cfg, v, qv, waves


def _jax_encoder(cfg, variables, waves, dtype, **over):
    enc = JaxEncoder(dataclasses.replace(cfg, **over), dtype=dtype)
    out = jax.jit(lambda p, w: enc.apply({"params": p}, w))(
        variables["params"]["ssl_model"], jnp.asarray(waves))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("a8", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_tree_into_port_encoder(tiny_model, a8, dtype):
    cfg, v, qv, waves = tiny_model
    sd = convert.from_jax_variables(qv, "My_XLSR_AASIST")
    prefix = "ssl_model.model."
    enc = wav2vec2.Wav2Vec2Encoder(
        wav2vec2.make_w2v_cfg(2, **W2V, w8=True, a8=a8),
        dtype=getattr(torch, dtype))
    enc.load_state_dict({k[len(prefix):]: t for k, t in sd.items()
                         if k.startswith(prefix)}, strict=True)
    assert isinstance(enc.encoder.layers[0].fc1,
                      wav2vec2.W8A8Linear if a8 else wav2vec2.W8Linear)
    with torch.inference_mode():
        got = enc(torch.from_numpy(waves)).float().numpy()
    want = _jax_encoder(cfg, qv, waves, getattr(jnp, dtype), w8=True, a8=a8)
    diff = np.abs(got - want)
    if dtype == "bfloat16":
        gap = np.abs(want - _jax_encoder(cfg, qv, waves, jnp.float32,
                                         w8=True, a8=a8)).max()
        assert diff.max() <= 2 * gap + 0.02, (diff.max(), gap)
    elif not a8:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        # rounding-tie flips only: nearly every element agrees to summation
        # order, and the worst stays well inside JAX's own w8a8-vs-w8 gap
        gap = np.abs(want - _jax_encoder(cfg, qv, waves, jnp.float32,
                                         w8=True, a8=False)).max()
        assert np.median(diff) < 1e-5 and (diff > 1e-4).mean() < 0.01
        assert diff.max() < 0.5 * gap, (diff.max(), gap)


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def track(tmp_path_factory):
    """The synthetic LA21 track and tiny reference .pt of the CLI tests."""
    return make_track(tmp_path_factory.mktemp("torch_quant_cli"))


def _scores(path):
    lines = path.read_text().splitlines()
    return ([l.split(" ")[0] for l in lines],
            np.array([float(l.split(" ")[1]) for l in lines]))


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_cli_int8_scores_match_jax(track, mode):
    from rtdsd_tpu.cli import main as jax_main
    from rtdsd_tpu_torch.cli import main as port_main

    root, cfg, pt = track
    args = ["--config", cfg, "--is_eval", "--is_score", "--ckpt", pt,
            "--tracks", "LA21", f"--{mode}"]
    jax_main.main(args + ["--comment", f"jax_{mode}"])
    port_main.main(args + ["--comment", f"port_{mode}", "--device", "cpu"])
    ids_j, s_j = _scores(root / f"scores_la21_jax_{mode}.txt")
    ids_p, s_p = _scores(root / f"scores_la21_port_{mode}.txt")
    assert ids_p == ids_j and len(ids_p) == 10
    if mode == "w8":
        # same int8 weights (round-to-nearest on both), float32 throughout
        np.testing.assert_allclose(s_p, s_j, rtol=1e-4, atol=1e-4)
    else:
        # activation rounding ties may flip: within a tenth of JAX's own
        # w8a8-vs-float score gap
        jax_main.main(args[:-1] + ["--comment", "jax_float"])
        _, s_f = _scores(root / "scores_la21_jax_float.txt")
        gap = np.abs(s_j - s_f).max()
        assert np.abs(s_p - s_j).max() <= 0.1 * gap + 1e-4, (
            np.abs(s_p - s_j).max(), gap)

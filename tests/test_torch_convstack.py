"""The port's fused front-end ops (``ops/convstack.py``) against the JAX
package's Pallas functions run in interpret mode, on the CPU.

The JAX kernels return frame counts rounded up to their block with garbage
tails; the port returns the valid frames only, so the comparisons cut the
JAX output to them. Inputs are made with ``numpy.random.default_rng``.

Tolerances. float32: rtol 1e-4 / atol 1e-5 for one layer (summation order
only); 5e-4 for the fused front-end against the unfused module, the
rational-vs-exact erf GELU of ``tests/test_pallas.py``. bfloat16: one
output rounding step (2^-8 of the value, ulp(1) = 7.8e-3), rtol and atol
1e-2; the chained front-end, whose layers see inputs already a step apart,
2e-2.

Tests marked ``gpu`` hold each CUDA kernel against its plain version on the
card (float32 with TF32 off) and skip without one; the conv layer's bf16
tensor-core body is held to the bf16 tolerance at the edges of its tiles.
JAX is imported by a fixture, so that they also collect on a machine
without it.
"""

import numpy as np
import pytest
import torch

from rtdsd_tpu_torch.models import wav2vec2
from rtdsd_tpu_torch.ops import convstack

TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-2, 1e-2)}
THREE = ((128, 10, 5), (128, 3, 2), (128, 2, 2))
SEVEN = ((128, 10, 5),) + ((128, 3, 2),) * 4 + ((128, 2, 2),) * 2
FLAGSHIP = ((512, 10, 5),) + ((512, 3, 2),) * 4 + ((512, 2, 2),) * 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jx():
    jax = pytest.importorskip("jax")
    from rtdsd_tpu.models import wav2vec2 as jw2v
    from rtdsd_tpu.ops.pallas import convstack as jconv

    return jax, jax.numpy, jconv, jw2v


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _ln_params(seed, c):
    return 1.0 + _np(seed, (c,), 0.1), _np(seed + 1, (c,), 0.1)


def _jax(jnp, fn, *arrays, **kw):
    out = fn(*(jnp.asarray(a) for a in arrays), interpret=True, **kw)
    return np.asarray(out.astype(jnp.float32))


def _cast(jnp, x, dtype):
    """f32 numpy -> (jax array, torch tensor) holding the same dtype values."""
    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


# ------------------------------------------------------------------ ln_gelu

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_gelu_matches_jax(jx, dtype):
    _, jnp, jconv, _ = jx
    jx_, tx = _cast(jnp, _np(0, (2, 37, 128), 2.0), dtype)  # F=37: ragged
    gamma, beta = _ln_params(1, 128)
    want = _jax(jnp, jconv.ln_gelu, jx_, gamma, beta)[:, :37]
    before = convstack.ln_gelu.launches
    got = convstack.ln_gelu(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert convstack.ln_gelu.launches == before          # plain version
    assert got.shape == (2, 37, 128) and got.dtype == tx.dtype
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


# ----------------------------------------------------- conv_ln_gelu_grouped

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,s,t,t_valid", [(3, 2, 64, 64), (3, 2, 64, 61),
                                           (2, 2, 40, 40), (4, 2, 48, 47),
                                           (2, 1, 30, 30)])
def test_conv_layer_matches_jax(jx, dtype, k, s, t, t_valid):
    _, jnp, jconv, _ = jx
    jx_, tx = _cast(jnp, _np(2, (2, t, 128)), dtype)
    w = _np(3, (k, 128, 128), (k * 128) ** -0.5)
    b = _np(4, (128,), 0.1)
    gamma, beta = _ln_params(5, 128)
    f_out = (t_valid - k) // s + 1
    want = _jax(jnp, jconv.conv_ln_gelu_grouped, jx_, w, b, gamma, beta,
                k=k, s=s, t_valid=t_valid)[:, :f_out]
    got = convstack.conv_ln_gelu_grouped(
        tx, *(torch.from_numpy(a) for a in (w, b, gamma, beta)), k=k, s=s,
        t_valid=t_valid)
    assert got.shape == (2, f_out, 128) and got.dtype == tx.dtype
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


# ---------------------------------------------------------- the front-end

def _frontend(jx, layers, n, conv_bias=True, seed=0):
    """A JAX extractor's ``layer_params`` (numpy and torch) and a wave."""
    jax, jnp, _, jw2v = jx
    cfg = jw2v.Wav2Vec2Config(conv_layers=layers, conv_bias=conv_bias)
    wave = _np(seed, (2, n), 0.3)
    v = jw2v.ConvFeatureExtractor(cfg, jnp.float32).init(
        jax.random.key(seed), jnp.asarray(wave))
    v = jax.tree_util.tree_map(np.asarray, v)
    lp = [{"conv": dict(v["params"][f"conv_{i}"]),
           "ln": dict(v["params"][f"ln_{i}"])} for i in range(len(layers))]
    lp_t = [{part: {name: torch.from_numpy(np.array(a))
                    for name, a in d.items()}
             for part, d in p.items()} for p in lp]
    return lp, lp_t, wave


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,n,conv_bias", [(THREE, 4000, True),
                                                (SEVEN, 8000, True),
                                                (THREE[:2], 2000, False)])
def test_fused_frontend_matches_jax(jx, dtype, layers, n, conv_bias):
    _, jnp, jconv, _ = jx
    lp, lp_t, wave = _frontend(jx, layers, n, conv_bias)
    want = np.asarray(jconv.fused_conv_frontend(
        jnp.asarray(wave), lp, layers, dtype=getattr(jnp, dtype),
        interpret=True).astype(jnp.float32))
    got = convstack.fused_conv_frontend(torch.from_numpy(wave), lp_t, layers,
                                        dtype=getattr(torch, dtype))
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _port_extractor(layers, seed=0):
    """The port's unfused ConvFeatureExtractor with seeded random weights
    (LayerNorm affine away from identity), and the same weights as the
    fused op's ``layer_params``."""
    torch.manual_seed(seed)
    fe = wav2vec2.ConvFeatureExtractor(
        wav2vec2.make_w2v_cfg(1, conv_layers=layers), torch.float32)
    lp = []
    for block in fe.conv_layers:
        conv, ln = block[0], block[2][1]
        with torch.no_grad():
            ln.weight.uniform_(0.8, 1.2)
            ln.bias.uniform_(-0.1, 0.1)
        lp.append({"conv": {"kernel": conv.weight.detach().permute(2, 1, 0),
                            "bias": conv.bias.detach()},
                   "ln": {"scale": ln.weight.detach(),
                          "bias": ln.bias.detach()}})
    return fe, lp


def test_fused_frontend_matches_port_extractor():
    """The fused op against the port's own unfused front-end (exact-erf GELU
    in float32), as tests/test_pallas.py holds the JAX op to its module."""
    fe, lp = _port_extractor(THREE)
    wave = torch.from_numpy(_np(12, (2, 4000), 0.3))
    want = fe(wave)
    got = convstack.fused_conv_frontend(wave, lp, THREE, dtype=torch.float32)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("layers,mode", [
    (((512, 10, 5), (512, 3, 2)), "layer_norm"),
    (((512, 10, 5), (512, 3, 2)), "group_norm"),
    (((512, 10, 5), (512, 5, 2)), "layer_norm"),      # k > 2 s
    (((100, 10, 5), (100, 3, 2)), "layer_norm"),      # Cin not 128-aligned
    (((640, 10, 5), (640, 5, 5)), "layer_norm"),      # s does not divide 8
    (((128, 10, 5), (128, 3, 2)), "layer_norm"),
    (((512, 10, 5), (512, 1, 2)), "layer_norm"),      # k < s
    (FLAGSHIP, "layer_norm"), (SEVEN, "layer_norm"),
])
def test_supports_fused_gives_jax_answers(jx, layers, mode):
    assert convstack.supports_fused(layers, mode) == \
        jx[2].supports_fused(layers, mode)


# ------------------------------------------------- the conv body rule

def _taken_before(cin, cout):
    """The wrapper's shape rule before the bf16 tensor-core body came in:
    the FFMA body's Cout set, Cin a multiple of 4, and its frame tile (16
    frames a thread row, 256 threads of Cout / 4 columns) of max(Cin, Cout)
    floats within shared memory."""
    frames = 16 * (256 // (cout // 4)) if cout >= 4 else 0
    return (cout in (128, 256, 512, 1024) and cin % 4 == 0
            and 4 * frames * max(cin, cout) <= 232448)


@pytest.mark.parametrize("cout", [64, 128, 256, 512, 1024])
@pytest.mark.parametrize("cin", [4, 60, 64, 100, 128, 192, 512, 1536, 2048])
def test_conv_body_rule(cin, cout):
    # the wrapper takes exactly the shapes it took before; bf16 with Cin a
    # multiple of 64 and Cout in {128, 256, 512} goes to the tensor cores,
    # everything else (float32 always) to the FFMA body
    assert convstack.conv_supported(cin, cout) == _taken_before(cin, cout)
    mma = cin % 64 == 0 and cout in (128, 256, 512)
    assert convstack.conv_body(torch.bfloat16, cin, cout) == (
        "mma" if mma else "ffma")
    assert convstack.conv_body(torch.float32, cin, cout) == "ffma"


def test_flagship_layers_take_the_tensor_core_body():
    for i, (cout, k, s) in enumerate(FLAGSHIP[1:]):
        cin = FLAGSHIP[i][0]
        assert convstack.conv_supported(cin, cout)
        assert convstack.conv_body(torch.bfloat16, cin, cout) == "mma"


# ------------------------------------------------- kernels on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = flags


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 12799, 512), (2, 37, 128),
                                   (3, 5, 1024)])
def test_ln_gelu_kernel_matches_plain(cuda, dtype, shape):
    x = torch.from_numpy(_np(6, shape, 2.0)).to(cuda, getattr(torch, dtype))
    gamma, beta = (torch.from_numpy(a).to(cuda)
                   for a in _ln_params(7, shape[-1]))
    before = convstack.ln_gelu.launches
    got = convstack.ln_gelu(x, gamma, beta)
    torch.cuda.synchronize()
    assert convstack.ln_gelu.launches == before + 1
    want = convstack.ln_gelu_reference(x, gamma, beta)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,cin,cout,k,s", [
    (2, 12799, 512, 512, 3, 2), (2, 799, 512, 512, 3, 2),
    (2, 399, 512, 512, 2, 2), (2, 61, 128, 128, 3, 2),
    (3, 47, 128, 256, 4, 2), (2, 30, 128, 1024, 2, 1)])
def test_conv_kernel_matches_plain(cuda, dtype, b, t, cin, cout, k, s):
    x = torch.from_numpy(_np(8, (b, t, cin))).to(cuda, getattr(torch, dtype))
    w, bias = (torch.from_numpy(a).to(cuda) for a in
               (_np(9, (k, cin, cout), (k * cin) ** -0.5),
                _np(10, (cout,), 0.1)))
    gamma, beta = (torch.from_numpy(a).to(cuda) for a in _ln_params(11, cout))
    before = convstack.conv_ln_gelu_grouped.launches
    got = convstack.conv_ln_gelu_grouped(x, w, bias, gamma, beta, k=k, s=s,
                                         t_valid=t - 1)
    torch.cuda.synchronize()
    assert convstack.conv_ln_gelu_grouped.launches == before + 1
    want = convstack.conv_ln_gelu_grouped_reference(x, w, bias, gamma, beta,
                                                    k=k, s=s, t_valid=t - 1)
    assert got.shape == want.shape == (b, (t - 1 - k) // s + 1, cout)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_fused_frontend_kernels_match_port_extractor(cuda):
    fe, lp = _port_extractor(SEVEN)
    wave = torch.from_numpy(_np(13, (2, 8000), 0.3)).to(cuda)
    want = fe.to(cuda)(wave)
    lp = [{part: {n: a.to(cuda) for n, a in d.items()}
           for part, d in p.items()} for p in lp]
    before = (convstack.ln_gelu.launches,
              convstack.conv_ln_gelu_grouped.launches)
    got = convstack.fused_conv_frontend(wave, lp, SEVEN, dtype=torch.float32)
    torch.cuda.synchronize()
    assert (convstack.ln_gelu.launches,
            convstack.conv_ln_gelu_grouped.launches) == (before[0] + 1,
                                                        before[1] + 6)
    torch.testing.assert_close(got, want, rtol=0, atol=5e-4)


# (b, t, cin, cout, k, s, t_valid, body): batch 1 and 16, frame counts that
# are no multiple of the 128- / 256-frame tiles (and fewer frames than
# one tile), t_valid < T, k 2 and 3, Cin 128 and 512, every Cout the rule
# sends to the tensor cores ("mma", a cluster pair at Cout 512; None: the
# rule's choice); the last two the rule sends to the FFMA body
_MMA_CASES = [
    (1, 12799, 512, 512, 3, 2, 12799, None),
    (16, 799, 512, 512, 2, 2, 790, None),
    (16, 399, 512, 512, 2, 2, 399, "mma"),
    (2, 97, 512, 512, 3, 2, 97, "mma"),
    (2, 130, 128, 128, 3, 2, 127, "mma"),
    (3, 200, 128, 256, 3, 2, 200, "mma"),
    (3, 200, 128, 512, 3, 2, 199, "mma"),
    (2, 301, 512, 256, 2, 2, 300, "mma"),
    (2, 61, 96, 512, 3, 2, 60, "ffma"),
    (2, 30, 128, 1024, 2, 1, 30, "ffma"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,cin,cout,k,s,t_valid,body", _MMA_CASES)
def test_conv_mma_body_matches_plain(cuda, b, t, cin, cout, k, s, t_valid,
                                     body):
    x = torch.from_numpy(_np(14, (b, t, cin))).to(cuda, torch.bfloat16)
    w, bias = (torch.from_numpy(a).to(cuda) for a in
               (_np(15, (k, cin, cout), (k * cin) ** -0.5),
                _np(16, (cout,), 0.1)))
    gamma, beta = (torch.from_numpy(a).to(cuda) for a in _ln_params(17, cout))
    rule = convstack.conv_body(torch.bfloat16, cin, cout)
    assert (rule == "ffma") == (body == "ffma")
    before = convstack.conv_ln_gelu_grouped.launches
    got = convstack.conv_ln_gelu_grouped(x, w, bias, gamma, beta, k=k, s=s,
                                         t_valid=t_valid, body=body)
    torch.cuda.synchronize()
    assert convstack.conv_ln_gelu_grouped.launches == before + 1
    want = convstack.conv_ln_gelu_grouped_reference(x, w, bias, gamma, beta,
                                                    k=k, s=s, t_valid=t_valid)
    assert got.shape == want.shape == (b, (t_valid - k) // s + 1, cout)
    rtol, atol = TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)

"""The port's kernel functions against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX Pallas functions run in interpret mode (as
``tests/test_pallas.py`` runs them) and against ``jax.nn.dot_product_attention``.
Inputs are made with ``numpy.random.default_rng``.

Tests marked ``gpu`` hold each CUDA kernel against its plain version on the
card; without a CUDA device they skip (``python -m pytest -m gpu
tests/test_torch_ops.py`` on the GPU machine runs them). The convstack
kernels' are in tests/test_torch_convstack.py; ``quantize_int8``'s and the
int8 product's are here, as the rest of their tests need JAX. The
rational-erf GELU (``ops/fastgelu.py``) has no Pallas counterpart: its
kernel is held to its plain version, bit for bit.
"""

import numpy as np
import pytest
import torch

from rtdsd_tpu_torch.models.wav2vec2 import int8_matmul
from rtdsd_tpu_torch.ops import attention, build, fastgelu, gat, quant


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
    """The JAX side, imported here so that the gpu tests of this file also
    collect on a machine without JAX."""
    jax = pytest.importorskip("jax")
    from rtdsd_tpu.ops.pallas import attention as jattn, gat as jgat

    return jax, jax.numpy, jattn.mha_small_t, jgat


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(dtype) for _ in range(3)]


# ------------------------------------------------------------- attention

# T=37: not a multiple of 16; at D=64 also T=65, one row past a 64-row
# query tile and one key past two 32-key strips of the float32 tiled kernel
@pytest.mark.parametrize("shape", [(2, 37, 4, 16), (2, 37, 4, 64), (2, 65, 4, 64)])
@pytest.mark.parametrize("scale", [None, 0.3])
def test_mha_plain_matches_jax_f32(jx, scale, shape):
    jax, jnp, jax_mha, _ = jx
    q, k, v = _qkv(0, shape)
    got = attention.mha_small_t(*(torch.from_numpy(a) for a in (q, k, v)),
                                scale=scale).numpy()
    want = np.asarray(jax_mha(*(jnp.asarray(a) for a in (q, k, v)),
                              scale=scale, interpret=True))
    dpa = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)), scale=scale))
    # f32 softmax attention, summation order only
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, dpa, rtol=1e-4, atol=1e-5)


def test_mha_plain_matches_jax_bf16(jx):
    _, jnp, jax_mha, _ = jx
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in _qkv(1, (2, 37, 4, 16)))
    want = np.asarray(jax_mha(q, k, v, interpret=True).astype(jnp.float32))
    got = attention.mha_small_t(
        *(torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    # bf16 output: one rounding of p and of the output, |out| <~ 1.5, so a
    # couple of bf16 steps (ulp(1) = 7.8e-3)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-2)


def test_mha_cpu_path_launches_nothing():
    before = attention.mha_small_t.launches
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, (1, 5, 2, 16)))
    torch.testing.assert_close(attention.mha_small_t(q, k, v),
                               attention.mha_small_t_reference(q, k, v))
    assert attention.mha_small_t.launches == before


def _cuda_core_limit(d, size):
    """The longest T the CUDA-core kernel took in either dtype: K and V rows
    padded by a 32-bit word, plus one f32 score row for each of 8 warps."""
    return attention.SMEM_LIMIT // (2 * (d + 4 // size) * size + 8 * 4)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", attention.HEAD_DIMS)
def test_mha_supports_every_t_the_cuda_core_kernel_took(dtype, d):
    size = torch.empty((), dtype=dtype).element_size()
    limit = attention.max_seq(d, dtype)
    # no narrowing: every T the CUDA-core kernel took is still taken
    assert limit >= _cuda_core_limit(d, size)
    assert all(attention.supports(t, d, dtype) for t in range(1, limit + 1))
    assert not attention.supports(limit + 1, d, dtype)
    assert not attention.supports(0, d, dtype)
    assert not attention.supports(8, d + 8, dtype)
    if dtype == torch.float32:        # long T still runs that kernel
        assert limit == _cuda_core_limit(d, size)


@pytest.mark.parametrize("d,limit", [(16, 512), (32, 384), (64, 256), (128, 128)])
def test_mha_f32_tiled_rule(d, limit):
    # the rule on the shape that picks the float32 kernel: the tiled one up
    # to the stated limit (its shared memory fits a block), the
    # one-warp-per-row one past it, up to max_seq; the XLSR shape is tiled
    assert attention.f32_tiled_max_seq(d) == limit
    assert all(attention.f32_tiled(t, d) for t in range(1, limit + 1))
    assert attention.smem_bytes(limit, d, torch.float32) <= attention.SMEM_LIMIT
    assert attention.smem_bytes(limit, d, torch.float32) == \
        attention.f32_tiled_smem_bytes(limit, d)
    assert attention.supports(limit + 1, d, torch.float32)
    assert attention.smem_bytes(limit + 1, d, torch.float32) == \
        2 * (limit + 1) * (d + 1) * 4 + 8 * (limit + 1) * 4
    assert attention.f32_tiled(199, 64)


# ------------------------------------------------------------------ GAT

def _gat_inputs(seed, b, n, d, do):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, d)).astype(np.float32)
    w = (rng.standard_normal((d, do)) * 0.3).astype(np.float32)
    bias = (rng.standard_normal(do) * 0.1).astype(np.float32)
    vecs = [(rng.standard_normal((do, 1)) * 0.3).astype(np.float32)
            for _ in range(3)]
    return x, w, bias, vecs


@pytest.mark.parametrize("n", [13, 16])          # 13: not a multiple of 8
def test_gat_plain_matches_jax(jx, n):
    _, jnp, _, jgat = jx
    x, w, bias, (a, _, _) = _gat_inputs(3, 2, n, 16, 8)
    got = gat.fused_gat_aggregate(*(torch.from_numpy(t) for t in (x, w, bias, a)),
                                  temperature=2.0).numpy()
    want = np.asarray(jgat.fused_gat_aggregate(*(jnp.asarray(t) for t in (x, w, bias, a)),
                              temperature=2.0, interpret=True))
    # the tolerance of tests/test_pallas.py's f32 GAT checks
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n1", [7, 8, 9])         # both sides of a block edge
def test_htrg_plain_matches_jax(jx, n1):
    _, jnp, _, jgat = jx
    x, w, bias, (w11, w22, w12) = _gat_inputs(4, 2, 19, 16, 8)
    args = (x, w, bias, w11, w22, w12)
    got = gat.fused_htrg_gat_aggregate(*(torch.from_numpy(t) for t in args),
                                       n1=n1, temperature=100.0).numpy()
    want = np.asarray(jgat.fused_htrg_gat_aggregate(*(jnp.asarray(t) for t in args), n1=n1,
                               temperature=100.0, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,d,do,want", [(66, 64, 64, True), (54, 64, 32, True),
                                         (26, 32, 32, True), (50, 64, 33, False),
                                         (50, 64, 512, False), (50, 128, 256, True),
                                         (704, 64, 64, True), (705, 64, 64, False)])
def test_gat_tiled_rule(n, d, do, want):
    # the tiled body takes Do in {8, ..., 256} where its shared memory fits;
    # the rows body takes the rest up to its own limit, so the set of
    # shapes the wrapper accepts did not narrow
    assert gat.tiled(n, d, do) == want
    assert gat.max_nodes(64, 64, "tiled") == 704
    assert gat.max_nodes(64, 33, "tiled") == 0


def test_kernel_sources_and_build_dir():
    assert build.sources() == ["convstack", "fastgelu", "gat", "mha_small_t",
                               "quant"]
    path = build.library_path("gat")
    assert path.startswith(build.BUILD_DIR) and path.endswith(".so")


# ------------------------------------------------- kernels on the card

_MHA_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 1e-2)}
# bf16, besides _MHA_TOL: |got - want| / |want| over the whole output, which
# rounding keeps near 1e-3 and a dropped 16-key tile at long T moves by ~0.1
_MHA_REL_NORM = 1e-2
# (dtype, b, t, h, d, layout): the main shape and the edges of the bf16
# kernels' tiling (T around 16-key tiles, 64-key groups and the 256-key
# register chunk, the two-pass paths past it, the longest T at every head
# dim) and of the float32 kernels' (T around 32-key strips and 64-row query
# tiles, both sides of the tiled kernel's limit, the longest T); "stack"
# takes q, k, v from a (3, B, ...) stack, "proj" slices them from one
# (B, T, 3 H D) projection; at (16, 257, 16, 64) a bf16 block, and at
# (16, 199, 16, 64) a float32 tiled block, walks several query tiles
_MHA_CASES = (
    [(dt, 2, t, h, d, "stack") for dt in (torch.float32, torch.bfloat16)
     for t, h, d in ((199, 16, 64), (37, 4, 16), (50, 2, 128))]
    + [(torch.bfloat16, 2, t, 4, 64, "stack") for t in (1, 17, 37, 208, 256, 257)]
    + [(torch.bfloat16, 2, t, 4, d, "stack")
       for t, d in ((50, 16), (50, 32), (300, 16), (300, 32), (200, 128))]
    + [(torch.bfloat16, 2, attention.max_seq(d, torch.bfloat16), 4, d, "stack")
       for d in attention.HEAD_DIMS]
    + [(torch.bfloat16, 2, 199, 16, 64, "proj"), (torch.bfloat16, 2, 37, 2, 16, "proj"),
       (torch.bfloat16, 16, 257, 16, 64, "proj")]
    + [(torch.float32, 2, t, 4, 64, "stack") for t in (1, 17, 63, 64, 65, 199, 256, 257)]
    + [(torch.float32, 2, 50, 4, d, "stack") for d in (16, 32, 128)]
    + [(torch.float32, 2, attention.f32_tiled_max_seq(d) + e, 4, d, "stack")
       for d in (16, 32, 128) for e in (0, 1)]
    + [(torch.float32, 2, attention.max_seq(d, torch.float32), 4, d, "stack")
       for d in attention.HEAD_DIMS]
    + [(torch.float32, b, t, 16, 64, "proj") for b, t in ((2, 199), (16, 199), (16, 257))])


def _assert_mha_close(got, want, dtype):
    # f32: summation order; bf16: the output may round one step apart
    # (a bf16 step is 2^-8 of the value, 7.8e-3 at 1)
    got, want = got.float(), want.float()
    rtol, atol = _MHA_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if dtype == torch.bfloat16:
        assert ((got - want).norm() / want.norm()).item() <= _MHA_REL_NORM


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,t,h,d,layout", _MHA_CASES)
def test_mha_kernel_matches_plain(cuda, dtype, b, t, h, d, layout):
    g = torch.Generator(device="cuda").manual_seed(0)
    if layout == "stack":
        # strided views of one stacked tensor, as a caller may pass
        qkv = torch.randn((3, t, h, d), generator=g, device=cuda, dtype=dtype)
        qkv = qkv.expand(b, 3, t, h, d).clone().transpose(0, 1)
        q, k, v = qkv[0] * 0.5, qkv[1], qkv[2]
    else:
        x = torch.randn((b, t, 3 * h * d), generator=g, device=cuda, dtype=dtype)
        q, k, v = (x[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
                   for i in range(3))
    before = attention.mha_small_t.launches
    got = attention.mha_small_t(q, k, v)
    torch.cuda.synchronize()
    assert attention.mha_small_t.launches == before + 1
    _assert_mha_close(got, attention.mha_small_t_reference(q, k, v), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64])          # bf16: the mma.sync and wgmma kernels
@pytest.mark.parametrize("scale", [-0.3, 0.0])
def test_mha_kernel_any_scale(cuda, dtype, d, scale):
    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 50, 4, d), generator=g, device=cuda,
                           dtype=dtype) for _ in range(3))
    got = attention.mha_small_t(q, k, v, scale=scale)
    want = attention.mha_small_t_reference(q, k, v, scale=scale)
    _assert_mha_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [199, 300])        # the tiled and the rows kernel
def test_mha_f32_kernel_takes_unaligned_rows(cuda, t):
    # float32 rows may start anywhere: the tiled kernel then copies 4 bytes
    # at a time
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, t, 3 * 4 * 64 + 1), generator=g, device=cuda)
    q, k, v = (x[..., 1 + i * 256:1 + (i + 1) * 256].unflatten(-1, (4, 64))
               for i in range(3))
    assert q.data_ptr() % 16 != 0
    _assert_mha_close(attention.mha_small_t(q, k, v),
                      attention.mha_small_t_reference(q, k, v), torch.float32)


@pytest.mark.gpu
def test_mha_bf16_kernel_refuses_unaligned_rows(cuda):
    x = torch.zeros((1, 9, 4 * 16 + 1), device=cuda, dtype=torch.bfloat16)
    q = x[..., 1:].unflatten(-1, (4, 16))       # rows start 2 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        attention.mha_small_t(q, q, q)
    with pytest.raises(ValueError, match="too long"):
        big = torch.zeros((1, attention.max_seq(16, torch.bfloat16) + 1, 1, 16),
                          device=cuda, dtype=torch.bfloat16)
        attention.mha_small_t(big, big, big)


# (b, n, d, do): the main path's shapes, then the edges of the tiled body
# (N at 1, at one 4-key group and one past it, at a query-tile boundary and
# one past it, the largest N it takes and one past, which the rows body
# takes), D 16/32/128, Do 8 and 256 (one and 32 lanes a key group), an odd
# Do (the rows body, up to its largest N) and batch 1
_GAT_CASES = [(16, 42, 64, 64), (16, 66, 64, 64), (3, 13, 16, 8),
              (2, 1, 64, 64), (2, 4, 64, 64), (2, 5, 64, 64), (2, 8, 64, 64),
              (2, 9, 64, 64), (2, gat.max_nodes(64, 64, "tiled"), 64, 64),
              (2, gat.max_nodes(64, 64, "tiled") + 1, 64, 64),
              (2, 50, 16, 64), (2, 50, 32, 32), (2, 50, 128, 64),
              (2, 30, 128, 256), (2, 50, 64, 33),
              (2, gat.max_nodes(64, 33, "rows"), 64, 33), (1, 66, 64, 64),
              (1, 42, 64, 64)]
# (b, n, d, do, n1): the main path's shapes, n1 at 0, at a key-group and a
# query-tile boundary and at N, batch 1
_HTRG_CASES = [(16, 54, 64, 32, 33), (16, 26, 32, 32, 16), (2, 19, 16, 8, 9),
               (2, 26, 32, 32, 0), (2, 26, 32, 32, 4), (2, 26, 32, 32, 8),
               (2, 26, 32, 32, 26), (1, 54, 64, 32, 33)]


def _gat_case(cuda, seed, b, n, d, do):
    x, w, bias, vecs = _gat_inputs(seed, b, n, d, do)
    to = lambda t: torch.from_numpy(t).to(cuda)
    return to(x), to(w), to(bias), [to(t) for t in vecs]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,do", _GAT_CASES)
def test_gat_kernel_matches_plain(cuda, b, n, d, do):
    x, w, bias, (a, _, _) = _gat_case(cuda, 5, b, n, d, do)
    before = gat.fused_gat_aggregate.launches
    got = gat.fused_gat_aggregate(x, w, bias, a, temperature=2.0)
    torch.cuda.synchronize()
    assert gat.fused_gat_aggregate.launches == before + 1
    want = gat.fused_gat_aggregate_reference(x, w, bias, a, temperature=2.0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d,do,n1", _HTRG_CASES)
def test_htrg_kernel_matches_plain(cuda, b, n, d, do, n1):
    x, w, bias, vecs = _gat_case(cuda, 6, b, n, d, do)
    got = gat.fused_htrg_gat_aggregate(x, w, bias, *vecs, n1=n1,
                                       temperature=100.0)
    torch.cuda.synchronize()
    want = gat.fused_htrg_gat_aggregate_reference(x, w, bias, *vecs, n1=n1,
                                                  temperature=100.0)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("htrg", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_gat_kernel_takes_model_layouts(cuda, htrg, dtype):
    """As the model calls it: x a transposed view in the compute dtype, the
    kernel ``att_proj.weight.t()``. The tiled body reads both as they are
    and gives, bit for bit, what it gives on contiguous float32 copies."""
    b, n, d, do, n1 = (16, 54, 64, 32, 33) if htrg else (16, 66, 64, 64, 66)
    x, _, bias, vecs = _gat_case(cuda, 7, b, n, d, do)
    x = x.transpose(1, 2).contiguous().transpose(1, 2).to(dtype)   # view
    weight = torch.randn((do, d), device=cuda) * 0.3     # nn.Linear layout
    w = weight.t()
    assert not x.is_contiguous() and not w.is_contiguous()
    if htrg:
        run = lambda *a: gat.fused_htrg_gat_aggregate(*a, bias, *vecs, n1, 100.0)
        ref = gat.fused_htrg_gat_aggregate_reference(x, w, bias, *vecs, n1, 100.0)
    else:
        run = lambda *a: gat.fused_gat_aggregate(*a, bias, vecs[0], 2.0)
        ref = gat.fused_gat_aggregate_reference(x, w, bias, vecs[0], 2.0)
    got = run(x, w)
    assert torch.equal(got, run(x.float().contiguous(), w.contiguous()))
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_gat_tanh_against_tanhf(cuda):
    """The tiled body's ex2.approx tanh against tanhf on the card."""
    x = torch.linspace(-12, 12, 1 << 20, device=cuda)
    fast, ref = torch.empty_like(x), torch.empty_like(x)
    lib = build.library("gat", gat._SIGNATURES)
    rc = lib.gat_tanh_check(x.data_ptr(), fast.data_ptr(), ref.data_ptr(),
                            x.numel(), torch.cuda.current_stream().cuda_stream)
    build.check(rc, "gat_tanh_check")
    assert (fast - ref).abs().max().item() < 1e-6
    assert (fast - x.double().tanh()).abs().max().item() < 1e-6


def _quant_input(shape, seed, transposed, scale=None):
    """An (R, C) float32 matrix on the card, row-major or as the transposed
    view of a row-major (C, R) one (a model's weight.t())."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    r, c = shape
    scale = r ** -0.5 if scale is None else scale
    if transposed:
        return (torch.randn((c, r), generator=g, device="cuda") * scale).t()
    return torch.randn((r, c), generator=g, device="cuda") * scale


# the flagship's three (in, out) shapes, then shapes whose R and C are no
# multiple of the kernel's 512-row / 32-column tile or of 16, a single row,
# R past the largest cluster's 4096 rows (blocks that hold two row tiles)
@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("shape", [(1024, 1024), (1024, 4096), (4096, 1024),
                                   (37, 130), (3, 5), (1, 7), (100, 130),
                                   (257, 384), (4095, 1000), (9000, 40)])
def test_quantize_kernel_matches_plain(cuda, stochastic, shape, transposed):
    x = _quant_input(shape, 7, transposed)
    before = quant.quantize_int8.launches
    vals, scales = quant.quantize_int8(x, seed=7919 * 3, stochastic=stochastic)
    torch.cuda.synchronize()
    assert quant.quantize_int8.launches == before + 1
    want_v, want_s = quant.quantize_int8_reference(x, 7919 * 3, stochastic)
    # the same float32 arithmetic and the same random bits: bit for bit
    assert torch.equal(scales, want_s) and torch.equal(vals, want_v)


@pytest.mark.gpu
@pytest.mark.parametrize("transposed", [False, True])
def test_quantize_kernel_default_is_stochastic_and_unbiased(cuda, transposed):
    x = _quant_input((4096, 1024), 8, transposed, scale=1.0)
    vals, scales = quant.quantize_int8(x, seed=5)
    assert torch.equal(vals, quant.quantize_int8_reference(x, 5, True)[0])
    scaled = x.double() / scales.double()
    err = vals.double() - scaled
    assert err.abs().max() < 1.0                 # |dequant - x| < scale
    var = (scaled - scaled.floor()) * (scaled.floor() + 1 - scaled)
    # per-column mean error within 6 standard errors of 0, and the whole
    # matrix's, as chip_smoke.py's check_quant holds it
    assert (err.mean(0).abs() < 6 * var.sum(0).sqrt() / x.shape[0]).all()
    assert err.mean().abs() < 6 * var.sum().sqrt() / err.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 16, 199, 3184])
def test_int8_matmul_on_card_is_exact(cuda, rows):
    g = torch.Generator(device="cuda").manual_seed(rows)
    a = torch.randint(-128, 128, (rows, 1024), generator=g, device=cuda,
                      dtype=torch.int8)
    b = torch.randint(-128, 128, (1024, 4096), generator=g, device=cuda,
                      dtype=torch.int8)
    got = int8_matmul(a, b)
    # |sums| < 2^24 * 1024 < 2^53: exact in float64
    assert torch.equal(got.double(), a.double() @ b.double())


# ------------------------------------------------------------ fast GELU

_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
        torch.float16: torch.int16}


def _gelu_input(dtype, device="cpu", shape=(4099,)):
    """Normal values over the clamp's edge, with +-0, +-inf and NaN."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g) * 3
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan")])[:x.numel()]
    x.view(-1)[:len(special)] = special
    return x.to(dtype).to(device)


def _assert_same_bits(got, want):
    """Bit for bit, NaN as NaN (its payload aside), same layout."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.stride() == want.stride()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    bits = _INT[want.dtype]
    assert torch.equal(got.masked_fill(nan, 0).view(bits),
                       want.masked_fill(nan, 0).view(bits))


# (B, 512, frames) as the front-end's LayerNorm leaves it, the transpose of
# a contiguous tensor; (B, T, D) as the positional conv's even-kernel trim
# leaves it, the transpose of a slice (not dense); the FFN hidden, contiguous
_GELU_LAYOUTS = {
    "frontend": lambda x: x.reshape(2, 23, 16).transpose(1, 2),
    "positional": lambda x: x.reshape(2, 16, 23)[:, :, :-1].transpose(1, 2),
    "ffn": lambda x: x.reshape(46, 16),
}


@pytest.mark.parametrize("dtype", list(_INT))
def test_gelu_fast_cpu_path_is_the_plain_chain(dtype):
    x = _gelu_input(dtype)
    before = fastgelu.gelu_fast.launches
    _assert_same_bits(fastgelu.gelu_fast(x), fastgelu.gelu_fast_reference(x))
    assert fastgelu.gelu_fast.launches == before


@pytest.mark.parametrize("layout", list(_GELU_LAYOUTS))
def test_gelu_fast_fake_gives_the_plain_layout(layout):
    from torch._subclasses.fake_tensor import FakeTensorMode

    x = _GELU_LAYOUTS[layout](_gelu_input(torch.bfloat16, shape=(736,)))
    want = fastgelu.gelu_fast_reference(x)
    with FakeTensorMode() as mode:
        got = torch.ops.rtdsd.gelu_fast(mode.from_tensor(x))
    assert (got.shape, got.dtype, got.stride()) == (want.shape, want.dtype,
                                                    want.stride())


def test_gelu_fast_exports_as_one_node():
    class Tiny(torch.nn.Module):
        def forward(self, x):
            return fastgelu.gelu(x) + 1

    ep = torch.export.export(Tiny(), (_gelu_input(torch.bfloat16)[:64],))
    ops = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert ops.count(torch.ops.rtdsd.gelu_fast.default) == 1
    assert len(ops) == 2                   # and the add


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_fast_gradient_is_the_plain_chains(dtype):
    x = _gelu_input(dtype)[5:].requires_grad_()         # finite values
    g = _gelu_input(dtype, shape=(4094,)).nan_to_num(0.0, 1.0, -1.0)
    got, = torch.autograd.grad(fastgelu.gelu_fast(x), x, g)
    want, = torch.autograd.grad(fastgelu.gelu_fast_reference(x), x, g)
    _assert_same_bits(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_gelu_kernel_every_16_bit_pattern(cuda, dtype):
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32, device=cuda
                     ).to(torch.int16).view(dtype)
    _assert_same_bits(fastgelu.gelu_fast(x), fastgelu.gelu_fast_reference(x))


@pytest.mark.gpu
def test_gelu_kernel_float32(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(1 << 20, generator=g, device=cuda) * 3
    # and values over every exponent, subnormals included
    x[: 1 << 16] = torch.randint(-2 ** 31, 2 ** 31 - 1, (1 << 16,),
                                 generator=g, device=cuda,
                                 dtype=torch.int32).view(torch.float32)
    _assert_same_bits(fastgelu.gelu_fast(x), fastgelu.gelu_fast_reference(x))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", list(_GELU_LAYOUTS))
@pytest.mark.parametrize("dtype", list(_INT))
def test_gelu_kernel_takes_model_layouts(cuda, layout, dtype):
    x = _GELU_LAYOUTS[layout](_gelu_input(dtype, cuda, (736,)))
    _assert_same_bits(fastgelu.gelu_fast(x), fastgelu.gelu_fast_reference(x))


# lengths around whole 16-byte vectors and whole blocks, views that start
# off a 16-byte boundary (read one element a thread)
@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 8, 9, 4095, 4097, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_kernel_ragged_and_unaligned(cuda, n, offset, dtype):
    x = _gelu_input(dtype, cuda, (n + offset,))[offset:]
    _assert_same_bits(fastgelu.gelu_fast(x), fastgelu.gelu_fast_reference(x))


@pytest.mark.gpu
def test_gelu_kernel_counts_and_refuses(cuda):
    x = _gelu_input(torch.bfloat16, cuda)
    before = fastgelu.gelu_fast.launches
    fastgelu.gelu_fast(x)
    fastgelu.gelu_fast(x[:100])
    assert fastgelu.gelu_fast.launches == before + 2
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        fastgelu.gelu_fast(x.double())


@pytest.mark.gpu
def test_gelu_kernel_in_bf16_encoder(cuda, monkeypatch):
    """A tiny bf16 encoder gives the plain chain's output bit for bit, with
    one launch per conv layer, one for the positional conv and one a
    layer."""
    from rtdsd_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder

    cfg = Wav2Vec2Config(
        conv_layers=((32, 10, 5),) + ((32, 3, 2),) * 4 + ((32, 2, 2),) * 2,
        encoder_embed_dim=64, encoder_ffn_dim=128, encoder_heads=4,
        encoder_layers=2, conv_pos=16, conv_pos_groups=4)
    torch.manual_seed(0)
    model = Wav2Vec2Encoder(cfg, torch.bfloat16).to(cuda).eval()
    wave = torch.randn(3, 16000, device=cuda)
    before = fastgelu.gelu_fast.launches
    with torch.inference_mode():
        got = model(wave)
    assert fastgelu.gelu_fast.launches - before == 7 + 1 + 2
    monkeypatch.setattr(fastgelu, "gelu_fast", fastgelu.gelu_fast_reference)
    with torch.inference_mode():
        want = model(wave)
    _assert_same_bits(got, want)

"""The port's Conformer head and XLSR-Conformer models against the JAX
package's, on the CPU, at a tiny size.

Weights are made with numpy from a seed on the shapes of the JAX modules
(``jax.eval_shape`` of their init, so no init is compiled) and carried into
the port by ``convert.from_jax_variables``; inputs are seeded numpy too.
The JAX side runs jitted. Float32 agreement: a block or the head alone to
(2e-5, 1e-5), as tests/test_conformer_oracle.py holds JAX against its
torch oracle; whole models to 1e-4, as tests/test_torch_models.py holds
XLSR-AASIST. bf16 takes that file's yardstick: twice JAX's own
bf16-vs-f32 gap, plus 0.02.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdsd_tpu.models import conformer as jax_conformer
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu.models.export_reference import export_reference_model
from _torch_track import random_variables
from rtdsd_tpu_torch.models import conformer, convert, dropout, registry

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
HEAD = {"emb_size": 16, "heads": 4, "n_encoders": 2}
PRUNED = {"num_layers": 2, "order": "custom", "custom_order": [3, 0]}
SAMPLES = 8000                     # 199 frames, 200 rows with the class token
BLOCK_TOL = dict(rtol=1e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _apply(module, variables, *args, **kw):
    out = jax.jit(lambda v, *a: module.apply(v, *a, **kw))(
        variables, *(jnp.asarray(a) for a in args))
    return np.asarray(out.astype(jnp.float32))


def _kwargs(kernel_size, pruned=False):
    kw = {"w2v": dict(W2V), "kernel_size": kernel_size, **HEAD}
    return {**kw, **PRUNED} if pruned else kw


def _name(pruned):
    return "My_XLSR_Conformer" if pruned else "XLSR_Conformer"


@pytest.fixture(scope="module")
def waves():
    return (np.random.default_rng(1).standard_normal((2, SAMPLES)) * 0.3
            ).astype(np.float32)


@pytest.fixture(scope="module")
def model_variables(waves):
    """(kernel_size, pruned) -> one weight tree per model shape, shared by
    every test of the file."""
    trees = {}

    def get(kernel_size, pruned=False):
        if (kernel_size, pruned) not in trees:
            spec = jax_registry.get_model(_name(pruned),
                                          **_kwargs(kernel_size, pruned))
            trees[kernel_size, pruned] = random_variables(
                spec.module, waves, seed=kernel_size, train=False)
        return trees[kernel_size, pruned]

    return get


def _jax_logits(v, waves, kernel_size, pruned=False, dtype=jnp.float32):
    spec = jax_registry.get_model(_name(pruned), dtype=dtype,
                                  **_kwargs(kernel_size, pruned))
    return _apply(spec.module, v, waves, train=False)


def _port(v, kernel_size, pruned=False, dtype=torch.float32):
    spec = registry.get_model(_name(pruned), dtype=dtype,
                              **_kwargs(kernel_size, pruned))
    spec.module.load_state_dict(convert.from_jax_variables(v, _name(pruned)),
                                strict=True)
    return spec.module.eval()


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("dim,t,kernel_size", [(24, 37, 16), (24, 37, 31),
                                               (8, 600, 31)])
def test_block_matches_jax(dim, t, kernel_size):
    """One block in f32. At T = 600 the relative distance i - j reaches
    599, so the +-512 clip fires; kernel 16 pads asymmetrically."""
    heads = 4 if dim == 24 else 2
    x = np.random.default_rng(dim + t).standard_normal((2, t, dim)
                                                       ).astype(np.float32)
    mod = jax_conformer.ConformerBlock(dim, heads, dim // heads,
                                       conv_kernel_size=kernel_size)
    v = random_variables(mod, x, seed=t, train=False)
    want = _apply(mod, v, x, train=False)
    sd = {}
    convert.conformer_block(sd, "b", v["params"], v["batch_stats"])
    block = conformer.ConformerBlock(dim, heads, dim // heads,
                                     conv_kernel_size=kernel_size)
    block.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    with torch.inference_mode():
        got = block.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


def test_backend_matches_jax():
    feats = (np.random.default_rng(5).standard_normal((2, 199, 32)) * 0.5
             ).astype(np.float32)
    mod = jax_conformer.ConformerBackend(emb_size=16, heads=4, kernel_size=31,
                                         n_encoders=2)
    v = random_variables(mod, feats, seed=5, train=False)
    want = _apply(mod, v, feats, train=False)
    head = conformer.ConformerBackend(feat_dim=32, emb_size=16, heads=4,
                                      kernel_size=31, n_encoders=2)
    head.load_state_dict(convert.conformer_backend(v["params"], v["batch_stats"]),
                         strict=True)
    with torch.inference_mode():
        got = head.eval()(torch.from_numpy(feats))
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), want, **BLOCK_TOL)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("pruned", [False, True])
def test_model_logits_match_jax_f32(waves, model_variables, pruned):
    v = model_variables(31, pruned)
    want = _jax_logits(v, waves, 31, pruned)
    with torch.inference_mode():
        got = _port(v, 31, pruned)(torch.from_numpy(waves))
    np.testing.assert_allclose(got.numpy(), want, **MODEL_TOL)


@pytest.mark.parametrize("kernel_size", [16, 31])
def test_model_logits_match_jax_bf16(waves, model_variables, kernel_size):
    """bf16 at an even (the CPU workaround's case) and an odd depthwise
    kernel, against the JAX package's own bf16 noise; the 2-layer student,
    as bf16 runs slowly on the CPU."""
    v = model_variables(kernel_size, True)
    want = _jax_logits(v, waves, kernel_size, True, dtype=jnp.bfloat16)
    want_f32 = _jax_logits(v, waves, kernel_size, True)
    with torch.inference_mode():
        got = _port(v, kernel_size, True, dtype=torch.bfloat16)(
            torch.from_numpy(waves)).float()
    tol = 2 * float(np.abs(want - want_f32).max()) + 0.02
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_reference_pt_loads_strict(model_variables):
    """Both weight routes give one state dict: ``from_jax_variables``, and
    the JAX export to a ``module.``-prefixed .pt read back by
    ``load_reference_state_dict``; the latter loads with strict=True."""
    v = model_variables(31)
    direct = convert.from_jax_variables(v, "XLSR_Conformer")
    exported = export_reference_model(v, "XLSR_Conformer")
    buf = io.BytesIO()
    torch.save({"module." + k: torch.from_numpy(np.array(a))
                for k, a in exported.items()}, buf)
    buf.seek(0)
    sd = convert.load_reference_state_dict(torch.load(buf, weights_only=True))
    assert set(sd) == set(direct)
    assert "conformer.encoder_blocks.1.conv.net.4.conv.weight" in sd
    pos = "ssl_model.model.encoder.pos_conv.0.weight"
    for k, t in direct.items():
        if k == pos:        # weight norm folded back: f32 rounding only
            np.testing.assert_allclose(sd[k].numpy(), t.numpy(), atol=1e-6)
        else:
            np.testing.assert_array_equal(sd[k].numpy(), t.numpy())
    model = registry.get_model("XLSR_Conformer", **_kwargs(31)).module
    model.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("name,spec_name,n_layers", [
    ("Model", "XLSR_Conformer", 24), ("ConformerModel", "XLSR_Conformer", 24),
    ("XLSR_Conformer", "XLSR_Conformer", 24),
    ("MyModel", "My_XLSR_Conformer", 2),
    ("My_XLSR_Conformer", "My_XLSR_Conformer", 2)])
def test_registry_names(name, spec_name, n_layers):
    spec = registry.get_model(name, **_kwargs(16, pruned=True))
    ref = jax_registry.get_model(name, **_kwargs(16, pruned=True))
    assert spec.name == ref.name == spec_name
    assert spec.layer_indices == ref.layer_indices
    assert len(spec.module.ssl_model.model.encoder.layers) == n_layers
    blocks = spec.module.conformer.encoder_blocks
    assert len(blocks) == 2 and blocks[0].conv.net[4].conv.kernel_size == (16,)
    # train mode: a forward with batch statistics, which moves first_bn's
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, SAMPLES)).astype(np.float32))
    out = spec.module.train()(x, src=dropout.source(0))
    assert out.shape == (2, 2) and torch.isfinite(out).all()
    assert int(spec.module.first_bn.num_batches_tracked) == 1

"""The port's modules against the JAX package's, on the CPU, at a tiny size.

One tiny ``My_XLSR_AASIST`` (2 layers, width 32, 4 heads, the verify
config) is initialised in JAX, its BatchNorm running statistics randomised,
and its weights carried into the port by ``from_jax_variables``. A 0.5 s
input gives 199 frames, so the graph back-end sees the flagship's node
counts (42 spectral, 66 temporal nodes). Inputs are made with
``numpy.random.default_rng``. Float32 agreement is held to about 1e-4: the
two frameworks sum in different orders, and a 2-layer encoder plus the
graph back-end compound that to a few 1e-5.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtdsd_tpu.models import aasist as jax_aasist
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu.models.export_reference import export_reference_model
from rtdsd_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from rtdsd_tpu_torch.models import aasist, convert, registry, wav2vec2

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
SAMPLES = 8000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kwargs(**over):
    kw = {"num_layers": 2, "w2v": dict(W2V)}
    kw["w2v"].update(over.pop("w2v", {}))
    kw.update(over)
    return kw


def _randomize_stats(tree, rng):
    """Non-trivial BN running statistics (JAX init leaves 0 / 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_stats(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def tiny():
    """(numpy variables, port state dict, waves) of one tiny model."""
    spec = jax_registry.get_model("My_XLSR_AASIST", **_kwargs())
    rng = np.random.default_rng(0)
    waves = (rng.standard_normal((2, SAMPLES)) * 0.3).astype(np.float32)
    v = jax.jit(lambda w: spec.module.init(jax.random.key(0), w, train=False))(
        jnp.asarray(waves))
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {"params": v["params"],
         "batch_stats": _randomize_stats(v["batch_stats"], rng)}
    return v, convert.from_jax_variables(v, "My_XLSR_AASIST"), waves


def _sub(sd, prefix):
    return {k[len(prefix):]: t for k, t in sd.items() if k.startswith(prefix)}


def _apply(module, variables, *args, **kw):
    """A flax eval forward, jitted (one compile instead of op-by-op)."""
    out = jax.jit(lambda v, *a: module.apply(v, *a, **kw))(
        variables, *(jnp.asarray(a) for a in args))
    return jax.tree_util.tree_map(lambda o: np.asarray(o.astype(jnp.float32)),
                                  out)


def _jax_logits(v, waves, dtype=jnp.float32, **kw):
    spec = jax_registry.get_model("My_XLSR_AASIST", dtype=dtype, **_kwargs(**kw))
    return _apply(spec.module, v, waves, train=False)


def _port(sd, dtype=torch.float32, **kw):
    spec = registry.get_model("My_XLSR_AASIST", dtype=dtype, **_kwargs(**kw))
    spec.module.load_state_dict(sd, strict=True)
    return spec.module.eval()


def test_encoder_matches_jax(tiny):
    v, sd, waves = tiny
    cfg_j = jax_registry.get_model("My_XLSR_AASIST", **_kwargs()).module.w2v_cfg
    want = _apply(JaxEncoder(cfg_j), {"params": v["params"]["ssl_model"]},
                  waves)
    enc = wav2vec2.Wav2Vec2Encoder(wav2vec2.make_w2v_cfg(2, **W2V))
    enc.load_state_dict(_sub(sd, "ssl_model.model."), strict=True)
    got = enc(torch.from_numpy(waves))
    assert got.shape == (2, 199, 32)
    # f32, summation order only: 2 layers + pos conv stay within 1e-4
    np.testing.assert_allclose(got.detach().numpy(), want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_gat_layer_matches_jax(tiny, fused):
    v, sd, _ = tiny
    x = np.random.default_rng(1).standard_normal((2, 42, 64)).astype(np.float32)
    name = "GAT_layer_S"
    want = _apply(jax_aasist.GraphAttentionLayer(64, 2.0, fused=fused),
                  {"params": v["params"]["backend"][name],
                   "batch_stats": v["batch_stats"]["backend"][name]},
                  x, train=False)
    layer = aasist.GraphAttentionLayer(64, 64, 2.0, fused=fused).eval()
    layer.load_state_dict(_sub(sd, name + "."), strict=True)
    got = layer(torch.from_numpy(x))
    # f32 GAT: the tolerance of tests/test_pallas.py's fused-vs-einsum checks
    np.testing.assert_allclose(got.detach().numpy(), want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_htrg_layer_matches_jax(tiny, fused):
    v, sd, _ = tiny
    rng = np.random.default_rng(2)
    x1 = rng.standard_normal((2, 33, 64)).astype(np.float32)
    x2 = rng.standard_normal((2, 21, 64)).astype(np.float32)
    master = rng.standard_normal((1, 1, 64)).astype(np.float32)
    name = "HtrgGAT_layer_ST11"
    want = _apply(jax_aasist.HtrgGraphAttentionLayer(64, 32, 100.0, fused=fused),
                  {"params": v["params"]["backend"][name],
                   "batch_stats": v["batch_stats"]["backend"][name]},
                  x1, x2, master, train=False)
    layer = aasist.HtrgGraphAttentionLayer(64, 32, 100.0, fused=fused).eval()
    layer.load_state_dict(_sub(sd, name + "."), strict=True)
    got = layer(*(torch.from_numpy(a) for a in (x1, x2, master)))
    for g, w in zip(got, want):   # type-1 nodes, type-2 nodes, master
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_backend_matches_jax(tiny, fused):
    v, sd, _ = tiny
    feats = (np.random.default_rng(3).standard_normal((2, 199, 32)) * 0.5
             ).astype(np.float32)
    want = _apply(jax_aasist.AASISTBackend(fused_gat=fused),
                  {"params": v["params"]["backend"],
                   "batch_stats": v["batch_stats"]["backend"]},
                  feats, train=False)
    be = aasist.AASISTBackend(feat_dim=32, fused_gat=fused).eval()
    be.load_state_dict({k: t for k, t in sd.items()
                        if not k.startswith("ssl_model.")}, strict=True)
    got = be(torch.from_numpy(feats))
    # six residual convs, four graph layers and top-k pools: ~1e-4 in f32
    np.testing.assert_allclose(got.detach().numpy(), want,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", [False, True])
def test_model_logits_match_jax_f32(tiny, fused):
    v, sd, waves = tiny
    want = _jax_logits(v, waves, fused_gat=fused)
    got = _port(sd, fused_gat=fused)(torch.from_numpy(waves))
    # whole tiny model in f32: encoder + back-end, ~1e-4
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fast_softmax", [False, True])
def test_model_logits_match_jax_bf16(tiny, fast_softmax):
    v, sd, waves = tiny
    kw = {"fused_gat": True, "w2v": {"fast_softmax": fast_softmax}}
    want = _jax_logits(v, waves, jnp.bfloat16, **kw)
    want_f32 = _jax_logits(v, waves)
    with torch.inference_mode():
        got = _port(sd, torch.bfloat16, **kw)(torch.from_numpy(waves)).float()
    # bf16 keeps 8 mantissa bits and the two frameworks round at different
    # places (fused bias adds, softmax internals), so the yardstick is the
    # JAX package's own bf16 noise: the port's bf16 logits must lie within
    # twice JAX's bf16-vs-f32 gap (+0.02) of JAX's bf16 logits
    tol = 2 * float(np.abs(want - want_f32).max()) + 0.02
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


# ------------------------------------------------------------ weight bridge

def _reference_pt(v):
    """The JAX export as a reference-format .pt, plus the keys a real
    reference checkpoint carries that the eval graph ignores."""
    sd = export_reference_model(v, "My_XLSR_AASIST")
    sd["ssl_model.model.mask_emb"] = np.zeros(32, np.float32)
    sd["ssl_model.model.quantizer.vars"] = np.zeros((1, 4, 8), np.float32)
    sd["ssl_model.model.project_q.weight"] = np.zeros((8, 8), np.float32)
    sd["ssl_model.model.final_proj.weight"] = np.zeros((8, 32), np.float32)
    buf = io.BytesIO()
    torch.save({"module." + k: torch.from_numpy(np.array(a))
                for k, a in sd.items()}, buf)
    buf.seek(0)
    return sd, torch.load(buf, weights_only=True)


def test_reference_pt_loads_strict(tiny):
    v, sd_port, _ = tiny
    exported, loaded = _reference_pt(v)
    assert any(".bn1." in k for k in exported)       # dead keys are present
    sd = convert.load_reference_state_dict(loaded)
    model = _port(sd)                                # strict=True inside
    assert set(sd) == set(model.state_dict())
    for k, t in sd_port.items():
        if k != "ssl_model.model.encoder.pos_conv.0.weight":
            np.testing.assert_array_equal(sd[k].numpy(), t.numpy())


def test_pos_conv_weight_norm_fold(tiny):
    v, sd_port, _ = tiny
    _, loaded = _reference_pt(v)
    key = "ssl_model.model.encoder.pos_conv.0.weight"
    assert "module." + key + "_g" in loaded
    folded = convert.load_reference_state_dict(loaded)[key]
    # g * v / ||v|| reproduces the plain kernel to f32 rounding
    np.testing.assert_allclose(folded.numpy(), sd_port[key].numpy(),
                               rtol=0, atol=1e-6)


def test_select_layers_renumbers():
    sd = {f"ssl_model.model.encoder.layers.{i}.fc1.weight": torch.full((1,), i)
          for i in range(4)}
    sd["LL.weight"] = torch.zeros(1)
    out = wav2vec2.select_layers(sd, wav2vec2.resolve_layer_indices(
        4, 2, "custom", [3, 1]))
    assert out["ssl_model.model.encoder.layers.0.fc1.weight"].item() == 3
    assert out["ssl_model.model.encoder.layers.1.fc1.weight"].item() == 1
    assert "ssl_model.model.encoder.layers.2.fc1.weight" not in out
    assert "LL.weight" in out
    assert wav2vec2.resolve_layer_indices(24, 3, "middle") == [10, 11, 12]
    with pytest.raises(ValueError, match="out of range"):
        wav2vec2.select_layers(sd, [5])

"""The port's remat policies and the mixed-remat layout
(``rtdsd_tpu_torch/models/wav2vec2.py``, ``models/convert.py``) on the
CPU: the counterparts of tests/test_integration.py's two remat-policy
tests and tests/test_models.py::test_mixed_remat_matches_uniform.

A policy (``remat_policy`` full / hidden / dots) and ``remat_save_every``
change only what the backward keeps and recomputes, never the arithmetic:
on the CPU, in float32, every gradient of a train step equals the
``full`` step's bit for bit, with dropout on (its seeds drawn outside the
recomputed region) and in train mode. The mixed layout of a JAX model
built with ``remat_save_every`` reads and writes as the JAX package's
``to_mixed_remat`` / ``from_mixed_remat`` lay it out, and such a model's
weights score in the port as in JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_track import random_variables
from rtdsd_tpu.models.convert_fairseq import from_mixed_remat, to_mixed_remat
from rtdsd_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from rtdsd_tpu.models.wav2vec2 import Wav2Vec2Encoder as JaxEncoder
from rtdsd_tpu_torch.models import convert, dropout, registry
from rtdsd_tpu_torch.models.wav2vec2 import Wav2Vec2Config, Wav2Vec2Encoder
from rtdsd_tpu_torch.models.zoo import init_weights

NAME = "My_XLSR_AASIST"
W2V = {"encoder_embed_dim": 16, "encoder_ffn_dim": 32, "encoder_heads": 2,
       "conv_pos": 8, "conv_pos_groups": 2,
       "conv_layers": [[16, 10, 5], [16, 3, 2], [16, 2, 2]],
       "dropout": 0.1, "activation_dropout": 0.1}
LAYERS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    model = registry.get_model(NAME, num_layers=LAYERS, w2v=W2V).module
    init_weights(model, 0)
    waves = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4000)).astype(np.float32) * 0.1)
    return model.state_dict(), waves


def _grads(weights, **w2v):
    """Parameter gradients of one train step (CE on fixed labels, dropout
    seeded from 0) of the remat model with ``w2v`` overrides."""
    sd, waves = weights
    model = registry.get_model(NAME, remat=True, num_layers=LAYERS,
                               w2v={**W2V, **w2v}).module
    model.load_state_dict(sd, strict=True)
    logits = model.train()(waves, src=dropout.source(0))
    torch.nn.functional.cross_entropy(
        logits, torch.tensor([0, 1]), weight=torch.tensor([0.9, 0.1])
    ).backward()
    return {k: p.grad for k, p in model.named_parameters()
            if p.grad is not None}


@pytest.fixture(scope="module")
def full(weights):
    return _grads(weights)


@pytest.mark.parametrize("w2v", [
    {"remat_policy": "hidden"},
    {"remat_policy": "dots"},
    {"remat_policy": "dots", "attention_dropout": 0.1},
    {"remat_save_every": 2},
    {"remat_save_every": 4, "remat_policy": "hidden"},
], ids=["hidden", "dots", "dots-attention-dropout", "save_every-2",
        "save_every-4-hidden"])
def test_remat_gradients_equal_full(weights, full, w2v):
    """Each policy and chunking changes only the schedule: every gradient
    equals the full-recompute step's, bit for bit on the CPU."""
    got = _grads(weights, **w2v)
    want = full if "attention_dropout" not in w2v \
        else _grads(weights, attention_dropout=0.1)
    assert sorted(got) == sorted(want) and len(got) > 200
    for k, g in want.items():
        assert torch.equal(got[k], g), k


@pytest.mark.parametrize("policy,saved", [
    ("hidden", {"rtdsd.checkpoint_name.default": 2 * LAYERS}),
    ("dots", {"aten.addmm.default": 6 * LAYERS,
              "rtdsd.mha_small_t.default": LAYERS}),
])
def test_remat_policy_keeps_what_it_names(weights, monkeypatch, policy,
                                          saved):
    """``hidden`` keeps the two tensors tagged per layer (attn_out,
    ffn_hidden), ``dots`` every matmul output and the attention
    operator's: what the selective checkpoint's policy is asked to keep
    in one forward."""
    from rtdsd_tpu_torch.models import wav2vec2

    kept = {}
    real = wav2vec2.create_selective_checkpoint_contexts

    def spy(policy_fn):
        def counted(ctx, op, *args, **kwargs):
            decision = policy_fn(ctx, op, *args, **kwargs)
            if decision == wav2vec2.CheckpointPolicy.MUST_SAVE:
                kept[str(op)] = kept.get(str(op), 0) + 1
            return decision
        return real(counted)

    monkeypatch.setattr(wav2vec2, "create_selective_checkpoint_contexts", spy)
    _grads(weights, remat_policy=policy)
    assert kept == saved


def test_remat_errors():
    """An unknown policy and a chunk that does not divide the depth raise,
    as the JAX encoder does (only when remat is on)."""
    with pytest.raises(ValueError, match="remat_policy.*full, hidden, dots"):
        registry.get_model(NAME, remat=True, num_layers=2,
                           w2v={**W2V, "remat_policy": "bogus"})
    with pytest.raises(ValueError, match="must divide encoder_layers"):
        registry.get_model(NAME, remat=True, num_layers=LAYERS,
                           w2v={**W2V, "remat_save_every": 3})
    registry.get_model(NAME, num_layers=2, w2v={**W2V, "remat_save_every": 3})


def test_mixed_remat_matches_uniform():
    """remat_save_every = m is a schedule change: outputs, per-layer
    hiddens and gradients equal the uniform per-layer remat's."""
    cfg = Wav2Vec2Config(conv_layers=((8, 10, 5), (8, 4, 4)),
                         encoder_embed_dim=8, encoder_ffn_dim=16,
                         encoder_heads=2, encoder_layers=4, conv_pos=4,
                         conv_pos_groups=2)
    wave = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 2000)).astype(np.float32) * 0.1)
    runs = []
    torch.manual_seed(0)
    sd = Wav2Vec2Encoder(cfg).state_dict()
    for m in (0, 2):
        enc = Wav2Vec2Encoder(dataclasses.replace(cfg, remat_save_every=m),
                              remat=True)
        enc.load_state_dict(sd, strict=True)
        out, hid = enc.train()(wave, return_hiddens=True)
        (out.square().sum() + hid.sum()).backward()
        runs.append((out, hid, {k: p.grad for k, p in enc.named_parameters()}))
    (out, hid, g), (out_m, hid_m, g_m) = runs
    assert hid_m.shape == hid.shape == (4, 2, out.shape[1], 8)
    assert torch.equal(out_m, out) and torch.equal(hid_m, hid)
    for k in g:
        assert torch.equal(g_m[k], g[k]), k


def test_mixed_layout_reads_and_writes_as_jax():
    """A JAX encoder built with remat_save_every = 2 (its layers under
    layers/layer_save and layers/layers_r/layer): the port reads its tree
    and scores as JAX does; the port's writer gives that tree back leaf
    for leaf, and its layout helpers are JAX's to_mixed_remat /
    from_mixed_remat on the same arrays."""
    jcfg = JaxConfig(conv_layers=((8, 10, 5), (8, 4, 4)),
                     encoder_embed_dim=8, encoder_ffn_dim=16,
                     encoder_heads=2, encoder_layers=4, conv_pos=4,
                     conv_pos_groups=2, remat_save_every=2)
    wave = np.random.default_rng(5).standard_normal((2, 2000)) \
        .astype(np.float32) * 0.1
    enc_m = JaxEncoder(jcfg, remat=True)
    params = random_variables(enc_m, wave, seed=3, train=False)["params"]
    assert set(params["layers"]) == {"layer_save", "layers_r"}

    sd = convert.from_jax_ssl_params(params)
    port = Wav2Vec2Encoder(Wav2Vec2Config(**{
        f.name: getattr(jcfg, f.name)
        for f in dataclasses.fields(Wav2Vec2Config)}))
    port.load_state_dict(sd, strict=True)
    want = jax.jit(lambda w: enc_m.apply({"params": params}, w))(
        jnp.asarray(wave))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(wave))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)

    back = convert.to_jax_ssl_params(sd, remat_save_every=2)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    assert [p for p, _ in flat(back)] == [p for p, _ in flat(params)]
    for (p, a), (_, b) in zip(flat(back), flat(params)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))

    standard = from_mixed_remat(params)["layers"]["layer"]
    ours = convert.standard_layers(params["layers"])
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), ours,
        standard)
    mixed = to_mixed_remat({"layers": {"layer": ours}}, 2)["layers"]
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
        convert.mixed_layers(ours, 2), mixed)
    with pytest.raises(ValueError, match="not divisible"):
        convert.mixed_layers(ours, 3)

"""The port's train and eval steps against the JAX package's, on the CPU.

One tiny ``My_XLSR_AASIST`` (2 layers, width 32, the verify config, 0.5 s
clips: the flagship's 199 frames and node counts) is initialised in JAX,
its BatchNorm statistics randomised, and carried into the port by
``from_jax_variables``. One float32 train step with remat on runs on both
sides with dropout made the identity (``flax.linen.intercept_methods`` on
``nn.Dropout`` in JAX, a patch of ``rtdsd_tpu_torch.models.dropout.drop``
in the port; nothing of ``rtdsd_tpu`` changes) and without RawBoost (its
draws cannot match across frameworks; tests/test_torch_rawboost.py holds
its pieces). Held: the loss, every gradient, the BatchNorm running
statistics (flax's biased-variance update), the parameters after AdamW,
the eval step's outputs; AdamW with freeze masks for three steps on
identical gradients; ``reinit_params``; ``mha_small_t``'s autograd
function against ``jax.grad`` of ``jax.nn.dot_product_attention``;
dropout's statistics and its masks under rematerialisation; pre-emphasis.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtdsd_tpu.engine import steps as jax_steps
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu.ops.preemphasis import pre_emphasis as jax_pre_emphasis
from rtdsd_tpu_torch.engine import steps
from rtdsd_tpu_torch.models import convert, dropout, registry
from rtdsd_tpu_torch.ops import attention
from rtdsd_tpu_torch.ops.preemphasis import pre_emphasis

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
KWARGS = {"num_layers": 2, "w2v": W2V}
SAMPLES = 8000
LR, WD = 1e-3, 1e-4
CE_WEIGHT = (0.9, 0.1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize_stats(tree, rng):
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
    """(numpy variables, port state dict, waves, labels)."""
    spec = jax_registry.get_model("My_XLSR_AASIST", **KWARGS)
    rng = np.random.default_rng(0)
    waves = (rng.standard_normal((4, SAMPLES)) * 0.3).astype(np.float32)
    labels = np.array([0, 1, 1, 0], np.int32)
    v = jax.jit(lambda w: spec.module.init(jax.random.key(0), w, train=False))(
        jnp.asarray(waves))
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {"params": v["params"],
         "batch_stats": _randomize_stats(v["batch_stats"], rng)}
    return v, convert.from_jax_variables(v, "My_XLSR_AASIST"), waves, labels


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _port_model(sd, remat=True, **kw):
    spec = registry.get_model("My_XLSR_AASIST", remat=remat,
                              **{**KWARGS, **kw})
    spec.module.load_state_dict(sd, strict=True)
    return spec.module


def _to_port(tree, stats):
    """A JAX params-shaped tree -> the port's names (numpy)."""
    sd = convert.from_jax_variables({"params": tree, "batch_stats": stats},
                                    "My_XLSR_AASIST")
    return {k: t.numpy() for k, t in sd.items()}


@pytest.fixture(scope="module")
def step_pair(tiny):
    """One f32 train step, dropout off, on both sides: JAX (loss, grads,
    new stats, new params, all in port names) and the port's model after
    its step, with its loss and gradients."""
    v, sd, waves, labels = tiny
    model_j = jax_registry.get_model("My_XLSR_AASIST", remat=True,
                                     **KWARGS).module
    tx = jax_steps.make_optimizer(LR, WD)

    def loss_fn(params, stats, w, y):
        out, mutated = model_j.apply(
            {"params": params, "batch_stats": stats},
            jax_pre_emphasis(w, 0.97), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(1)})
        return jax_steps.weighted_cross_entropy(out, y, CE_WEIGHT), \
            mutated["batch_stats"]

    def step(params, stats, w, y):
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, stats, w, y)
        updates, opt_state = tx.update(grads, tx.init(params), params)
        return (loss, grads, new_stats, optax.apply_updates(params, updates),
                opt_state)

    with fnn.intercept_methods(_no_dropout):
        loss, grads, stats, params, opt_state = jax.jit(step)(
            v["params"], v["batch_stats"], jnp.asarray(waves),
            jnp.asarray(labels))
    want = {"loss": float(loss),
            "grads": _to_port(grads, v["batch_stats"]),
            "params": _to_port(params, stats),
            "moments": {k: _to_port(optax.tree_utils.tree_get(opt_state, k),
                                    v["batch_stats"]) for k in ("mu", "nu")}}

    model = _port_model(sd)
    state = steps.TrainState(model, steps.make_optimizer(model, LR, WD))
    train = steps.make_train_step(ce_weight=CE_WEIGHT, preemph=0.97)
    mp = pytest.MonkeyPatch()
    mp.setattr(dropout, "drop", lambda x, p, src: x)
    try:
        metrics = train(state, torch.from_numpy(waves),
                        torch.from_numpy(labels).long(), 1024)
    finally:
        mp.undo()
    got = {"loss": float(metrics["loss"]), "step": state.step,
           "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
           "params": {k: t.numpy() for k, t in model.state_dict().items()},
           "moments": {k: {n: state.optimizer.state[p][key].numpy()
                           for n, p in model.named_parameters()}
                       for k, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))}}
    return want, got


def test_weighted_cross_entropy_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((7, 2)).astype(np.float32) * 3
    labels = rng.integers(0, 2, 7).astype(np.int32)
    for weight in (None, CE_WEIGHT, (0.3, 0.7)):
        want = jax_steps.weighted_cross_entropy(jnp.asarray(logits),
                                                jnp.asarray(labels), weight)
        got = steps.weighted_cross_entropy(torch.from_numpy(logits),
                                           torch.from_numpy(labels), weight)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_step_loss_matches_jax(step_pair):
    want, got = step_pair
    assert got["step"] == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-5)


def _assert_held_per_tensor(got: dict, want: dict, rel: float) -> None:
    """Each tensor within ``rel`` of its max |want|, except tensors whose
    max is at most 1e-6 of the largest one's: those are held under 1e-6 of
    the largest."""
    assert set(got) <= set(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        w = want[name]
        scale = float(np.abs(w).max())
        if scale <= 1e-6 * top:
            assert float(np.abs(g).max()) <= 1e-6 * top, name
            continue
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (name, err, scale)


def test_train_step_gradients_match_jax(step_pair):
    """Each gradient within 1e-3 of its tensor's max |g|: JAX's own float32
    gradients of this step differ by up to 4.7e-4 of it between the jitted
    and the op-by-op (``jax.disable_jit``) runs (first_bn1.bias; the
    residual blocks' conv2 weights 2.3e-4 to 3.0e-4), summation order
    through six BatchNorm backwards. Gradients that are zero in exact
    arithmetic (biases feeding a BatchNorm, the key projection's bias under
    the softmax) are float32 noise on both sides: held under 1e-6 of the
    largest gradient."""
    want, got = step_pair
    _assert_held_per_tensor(got["grads"], want["grads"], 1e-3)


def test_train_step_bn_statistics_match_jax(step_pair):
    """flax moves running_var with the biased batch variance; an unbiased
    update would miss by var / (n - 1) on the small BatchNorms."""
    want, got = step_pair
    stats = [k for k in got["params"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert len(stats) == 2 * 15
    for k in stats:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   rtol=0, atol=1e-5, err_msg=k)


def test_train_step_adamw_update_matches_jax(step_pair):
    """AdamW's moments after the step against optax's at the gradients'
    rule: the first, 0.1 g, and the square root of the second, sqrt(1e-3)
    |g|. The parameters only within 2 lr: Adam's first step
    moves each by about lr times the sign of its gradient, and a gradient
    near zero may take either sign, so that bound shows that lr and the
    decay were applied, not that the two updates agree."""
    want, got = step_pair
    _assert_held_per_tensor(got["moments"]["mu"], want["moments"]["mu"], 1e-3)
    _assert_held_per_tensor(
        {k: np.sqrt(a) for k, a in got["moments"]["nu"].items()},
        {k: np.sqrt(a) for k, a in want["moments"]["nu"].items()}, 1e-3)
    for k, p in got["params"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(p, want["params"][k], rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=k)


def test_eval_step_matches_jax(tiny):
    v, sd, waves, labels = tiny
    model_j = jax_registry.get_model("My_XLSR_AASIST", **KWARGS).module
    want = jax.jit(jax_steps.make_eval_step(model_j, ce_weight=CE_WEIGHT))(
        v["params"], v["batch_stats"], jnp.asarray(waves), jnp.asarray(labels))
    model = _port_model(sd, remat=False)
    got = steps.make_eval_step(model, ce_weight=CE_WEIGHT)(
        torch.from_numpy(waves), torch.from_numpy(labels).long())
    assert not model.training
    for k in ("loss", "loss_terms", "loss_weights", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["correct"].numpy(),
                                  np.asarray(want["correct"]))


# ------------------------------------------------------------ optimizer

FREEZE_CASES = {
    "plain": (["feature_extractor"], []),
    "layer_indexed": (["layers.1"], []),
    "plain_with_exception": (["feature_extractor", "post_extract_proj"],
                             ["post_extract_proj"]),
    "indexed_exception_under_plain": (["fc1"], ["layers.0"]),
}


@pytest.mark.parametrize("case", sorted(FREEZE_CASES))
def test_adamw_with_freeze_masks_matches_optax(tiny, case):
    """The same gradients through optax and the port for three steps."""
    freeze, unfreeze = FREEZE_CASES[case]
    v, sd, _, _ = tiny
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    tx = jax_steps.make_optimizer(LR, WD, freeze, unfreeze)
    opt_j = tx.init(params)
    model = _port_model(sd, remat=False)
    opt = steps.make_optimizer(model, LR, WD, freeze, unfreeze)
    rng = np.random.default_rng(7)
    frozen = []
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), v["params"])
        updates, opt_j = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   opt_j, params)
        params = optax.apply_updates(params, updates)
        g_port = _to_port(grads, v["batch_stats"])
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g_port[name]) if p.requires_grad else None
        opt.step()
        frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    want = _to_port(jax.tree_util.tree_map(np.asarray, params), v["batch_stats"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-6, err_msg=name)
    assert frozen and all(np.array_equal(dict(model.named_parameters())[n]
                                         .detach().numpy(), sd[n].numpy())
                          for n in frozen)


def test_reinit_params_matches_jax(tiny):
    v, sd, _, _ = tiny
    patterns = ["pos_conv", "layers.1"]
    ssl_j = jax_steps.reinit_params(
        jax.tree_util.tree_map(jnp.asarray, v["params"]["ssl_model"]),
        patterns, jax.random.key(3))
    after = _to_port({**v["params"], "ssl_model": jax.tree_util.tree_map(
        np.asarray, ssl_j)}, v["batch_stats"])
    changed_j = {k for k, a in after.items()
                 if not np.array_equal(a, sd[k].numpy())}
    model = _port_model(sd, remat=False)
    done = steps.reinit_params(model.ssl_model, patterns, seed=3)
    changed = {k for k, t in model.state_dict().items()
               if not torch.equal(t, sd[k])}
    assert changed == changed_j == {"ssl_model." + n for n in done}
    assert len(changed) == 7       # pos conv + 6 matmuls of layer 1
    for name, p in model.ssl_model.named_parameters():
        if "ssl_model." + name in changed:
            fan_out, fan_in = p.shape[0], p[0].numel()
            rf = p[0, 0].numel()
            bound = (6.0 / (fan_in + fan_out * rf)) ** 0.5
            assert float(p.detach().abs().max()) <= bound


# ------------------------------------------------------------ attention

def test_mha_autograd_matches_jax_grad():
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
                   for _ in range(4))

    def f(q, k, v):
        return jnp.sum(jax.nn.dot_product_attention(q, k, v) * do)

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention.mha_small_t(qt, kt, vt)
    assert out.grad_fn is not None and "MhaSmallT" in type(out.grad_fn).__name__
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(jax.nn.dot_product_attention(q, k, v)),
        rtol=0, atol=1e-5)
    (out * torch.from_numpy(do)).sum().backward()
    for t, w in zip((qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    with torch.no_grad():               # no graph: the plain call
        assert attention.mha_small_t(qt, kt, vt).grad_fn is None


def test_attention_projections_get_gradients(tiny):
    """Through the encoder's attention (the kernel's path, fast_softmax
    off), q/k/v projections receive non-zero gradients."""
    _, sd, waves, _ = tiny
    model = _port_model(sd, w2v=dict(W2V, fast_softmax=False)).train()
    model(torch.from_numpy(waves), src=dropout.source(0)).sum().backward()
    for i in range(2):
        for proj in ("q_proj", "k_proj", "v_proj"):
            lin = getattr(model.ssl_model.model.encoder.layers[i].self_attn, proj)
            assert float(lin.weight.grad.abs().max()) > 0, (i, proj)


# ------------------------------------------------------------ dropout

def test_dropout_statistics():
    x = torch.ones(400, 500)
    for p in (0.2, 0.5):
        y = dropout.drop(x, p, dropout.source(1))
        kept = y != 0
        assert abs(float(kept.float().mean()) - (1 - p)) < 0.005
        torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
    assert dropout.drop(x, 0.0, None) is x
    a = dropout.drop(x, 0.3, dropout.source(4))
    assert torch.equal(a, dropout.drop(x, 0.3, dropout.source(4)))
    assert not torch.equal(a, dropout.drop(x, 0.3, dropout.source(5)))


def test_dropout_masks_under_remat_equal_plain(tiny):
    """A rematerialised encoder draws the same masks in the recompute:
    outputs and gradients equal those of the encoder without remat."""
    _, sd, waves, _ = tiny
    w2v = dict(W2V, dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)
    runs = []
    for remat in (False, True):
        model = _port_model(sd, remat=remat, w2v=w2v).train()
        out = model(torch.from_numpy(waves), src=dropout.source(9))
        out.sum().backward()
        runs.append((out.detach(), {n: p.grad.clone() for n, p in
                                    model.named_parameters()}))
    (o1, g1), (o2, g2) = runs
    torch.testing.assert_close(o2, o1, rtol=0, atol=0)
    for n in g1:
        torch.testing.assert_close(g2[n], g1[n], rtol=1e-6, atol=1e-7,
                                   msg=n)


# ------------------------------------------------------------ pre-emphasis

def test_pre_emphasis_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 1000)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax_pre_emphasis(a, 0.97))(x))
    got = pre_emphasis(torch.from_numpy(x).requires_grad_(), 0.97)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(), want)


def test_gat_kernels_only_in_eval(tiny, monkeypatch):
    """As the JAX package gates them (fused and not train), a fused_gat
    model trains through the einsum path and calls the kernels in eval."""
    from rtdsd_tpu_torch.models import aasist

    _, sd, waves, _ = tiny
    calls = []

    def spy(fn):
        def call(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return call
    for name in ("fused_gat_aggregate", "fused_htrg_gat_aggregate"):
        monkeypatch.setattr(aasist, name, spy(getattr(aasist, name)))
    model = _port_model(sd, fused_gat=True).train()
    model(torch.from_numpy(waves), src=dropout.source(0)).sum().backward()
    assert calls == []
    with torch.inference_mode():
        model.eval()(torch.from_numpy(waves))
    assert sorted(set(calls)) == ["fused_gat_aggregate",
                                  "fused_htrg_gat_aggregate"]
    assert len(calls) == 6


# ------------------------------------------------------------ deferred

DEFERRED = {
    "remat_hidden": lambda m: registry.get_model(
        "My_XLSR_AASIST", remat=True, num_layers=2,
        w2v=dict(W2V, remat_policy="hidden")),
    "remat_dots": lambda m: registry.get_model(
        "My_XLSR_AASIST", remat=True, num_layers=2,
        w2v=dict(W2V, remat_policy="dots")),
    "remat_save_every": lambda m: registry.get_model(
        "My_XLSR_AASIST", remat=True, num_layers=2,
        w2v=dict(W2V, remat_save_every=2)),
}


@pytest.mark.parametrize("option", sorted(DEFERRED))
def test_deferred_options_raise_with_a_pointer(tiny, option):
    _, sd, _, _ = tiny
    model = _port_model(sd, remat=False)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1, item 7"):
        DEFERRED[option](model)


def test_rawboost_keeps_priority_over_mul_augment():
    assert steps.pick_rawboost_algo(["mul_augment", "RawBoost4"]) == 4
    assert steps.pre_device_augs(["mul_augment", "RawBoost4"]) == ()
    assert steps.post_device_augs(["ACN"], allow=False) == ()
    assert steps.post_device_augs(["GAN", "ACN"], True) == \
        jax_steps.post_device_augs(["GAN", "ACN"], True)


def test_train_step_is_a_function_of_seed_and_step(tiny):
    """RawBoost and dropout draws depend on (seed, step) only: two models
    stepped from the same state with the same seed stay equal."""
    _, sd, waves, labels = tiny
    states = []
    for _ in range(2):
        model = _port_model(sd)
        states.append(steps.TrainState(model, steps.make_optimizer(model, LR, WD)))
    train = steps.make_train_step(ce_weight=CE_WEIGHT, rawboost_algo=4)
    w, y = torch.from_numpy(waves), torch.from_numpy(labels).long()
    losses = [[float(train(s, w, y, 1024)["loss"]) for _ in range(2)]
              for s in states]
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]
    for (n, a), b in zip(states[0].model.state_dict().items(),
                         states[1].model.state_dict().values()):
        assert torch.equal(a, b), n

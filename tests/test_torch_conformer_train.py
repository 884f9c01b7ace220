"""The port's XLSR-Conformer in training against the JAX package's, on the
CPU, and the train CLI on a tiny copy of ``configs/xlsr_conformer.yaml``.

A tiny ``My_XLSR_Conformer`` (2 encoder layers of width 32, emb 16, 2
blocks, an even depthwise kernel) gets seeded numpy weights on the JAX
module's shapes and non-trivial BatchNorm statistics, carried into the port
by ``from_jax_variables``. One float32 train step with remat on runs on
both sides without augmentation and with dropout made the identity
(``flax.linen.intercept_methods`` on ``nn.Dropout`` in JAX, a patch of
``rtdsd_tpu_torch.models.dropout.drop`` in the port; the Conformer's own
dropout rate is 0 on both sides). Held at tests/test_torch_train.py's
tolerances: the loss (1e-5), every gradient (1e-3 of its tensor's max;
those zero in exact arithmetic under 1e-6 of the largest), the BatchNorm
running statistics of ``first_bn`` and both blocks' conv modules (1e-5),
AdamW's moments (1e-3 of their max) and the parameters after it (2 lr);
then the eval step (1e-5). The CLI trains two epochs from an
``ssl_pytree_path`` written by ``rtdsd_tpu_torch.cli.convert`` and scores
from ``last/``.
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
from _torch_track import (random_variables, run_cli_epochs,
                          tiny_shipped_config, write_ssl_pytree)
from rtdsd_tpu_torch.engine import steps
from rtdsd_tpu_torch.models import convert, dropout, registry
from test_torch_train import _assert_held_per_tensor, _no_dropout

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
NAME = "My_XLSR_Conformer"
KWARGS = {"num_layers": 2, "w2v": W2V, "emb_size": 16, "heads": 4,
          "kernel_size": 16, "n_encoders": 2}
SAMPLES = 8000
LR, WD = 1e-3, 1e-4
CE_WEIGHT = (0.9, 0.1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(numpy variables, port state dict, waves, labels)."""
    spec = jax_registry.get_model(NAME, **KWARGS)
    rng = np.random.default_rng(4)
    waves = (rng.standard_normal((4, SAMPLES)) * 0.3).astype(np.float32)
    labels = np.array([0, 1, 1, 0], np.int32)
    v = random_variables(spec.module, waves, seed=4, train=False)
    return v, convert.from_jax_variables(v, NAME), waves, labels


def _port_model(sd, remat=True):
    spec = registry.get_model(NAME, remat=remat, **KWARGS)
    spec.module.load_state_dict(sd, strict=True)
    return spec.module


def _to_port(tree, stats):
    sd = convert.from_jax_variables({"params": tree, "batch_stats": stats},
                                    NAME)
    return {k: t.numpy() for k, t in sd.items()}


@pytest.fixture(scope="module")
def step_pair(tiny):
    v, sd, waves, labels = tiny
    model_j = jax_registry.get_model(NAME, remat=True, **KWARGS).module
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


def test_conformer_train_step_loss_matches_jax(step_pair):
    want, got = step_pair
    assert got["step"] == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=1e-5)


def test_conformer_train_step_gradients_match_jax(step_pair):
    want, got = step_pair
    _assert_held_per_tensor(got["grads"], want["grads"], 1e-3)


def test_conformer_train_step_bn_statistics_match_jax(step_pair):
    """``first_bn`` and each block's conv-module BatchNorm move their
    running statistics with the batch's biased variance, as flax does."""
    want, got = step_pair
    stats = [k for k in got["params"] if k.endswith(("running_mean",
                                                     "running_var"))]
    assert len(stats) == 2 * (1 + KWARGS["n_encoders"])
    for k in stats:
        np.testing.assert_allclose(got["params"][k], want["params"][k],
                                   rtol=0, atol=1e-5, err_msg=k)


def test_conformer_train_step_adamw_update_matches_jax(step_pair):
    want, got = step_pair
    _assert_held_per_tensor(got["moments"]["mu"], want["moments"]["mu"], 1e-3)
    nu = got["moments"]["nu"]
    _assert_held_per_tensor({k: np.sqrt(a) for k, a in nu.items()},
                            {k: np.sqrt(want["moments"]["nu"][k]) for k in nu},
                            1e-3)
    for k, p in got["params"].items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(p, want["params"][k], rtol=0,
                                   atol=2 * LR + 1e-6, err_msg=k)


def test_conformer_eval_step_matches_jax(tiny):
    v, sd, waves, labels = tiny
    model_j = jax_registry.get_model(NAME, **KWARGS).module
    want = jax.jit(jax_steps.make_eval_step(model_j, ce_weight=CE_WEIGHT))(
        v["params"], v["batch_stats"], jnp.asarray(waves), jnp.asarray(labels))
    model = _port_model(sd, remat=False)
    got = steps.make_eval_step(model, ce_weight=CE_WEIGHT)(
        torch.from_numpy(waves), torch.from_numpy(labels).long())
    for k in ("loss", "loss_terms", "loss_weights", "scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5, err_msg=k)


def test_conformer_specs_match_jax():
    """No freeze or re-init patterns for any Conformer name, as the JAX
    registry builds them."""
    for name in ("XLSR_Conformer", "ConformerModel", "Model", "MyModel",
                 NAME):
        spec = registry.get_model(name, **KWARGS)
        ref = jax_registry.get_model(name, **KWARGS)
        assert (spec.freeze_patterns, spec.reinit_patterns,
                spec.unfreeze_patterns) == ([], [], [])
        assert (ref.freeze_patterns, ref.reinit_patterns,
                ref.unfreeze_patterns) == ([], [], [])


# ------------------------------------------------------------- CLI

def test_cli_trains_conformer_from_ssl_pytree(tmp_path):
    """configs/xlsr_conformer.yaml's recipe (bf16, RawBoost4) at a tiny
    size, the encoder from a pytree directory: two epochs, then scoring."""
    _, pytree = write_ssl_pytree(tmp_path, W2V)
    cfg = tiny_shipped_config(tmp_path, "xlsr_conformer.yaml", NAME,
                              {**KWARGS, "order": "custom",
                               "custom_order": [2, 0]}, pytree,
                              np.random.default_rng(8))
    run_cli_epochs(tmp_path, cfg, epochs=2)

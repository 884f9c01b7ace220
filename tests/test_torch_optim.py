"""The port's optimizer knobs against optax, and its checkpoint writers.

``optimizer: adafactor`` (the port's ``Adafactor``) and ``adam_mu_dtype``
(``AdamWLowPrecisionMu``) are held to the JAX package's ``make_optimizer``
(optax 0.2.6) on a tiny ``My_XLSR_AASIST`` whose widths (128 and 256) make
optax factor the second moment of the transformer's matrices, the
post-extraction projection and ``LL``: the same random gradients for three
steps, with no freeze, a plain freeze and a layer-indexed freeze (whose
frozen layer's gradient enters its stacked leaf's block RMS in JAX). Both
optimizers round-trip through ``state.pt`` (save, restore, resume equal to
an unbroken run, bit for bit). ``save_checkpoint_async`` snapshots before
it returns, surfaces a writer's error, and writes what the synchronous
writer writes.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtdsd_tpu.engine import steps as jax_steps
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu_torch.engine import checkpoint, steps
from rtdsd_tpu_torch.models import convert, registry

from _torch_track import random_variables

W2V = {"encoder_embed_dim": 128, "encoder_ffn_dim": 256, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
KWARGS = {"num_layers": 2, "w2v": W2V}
LR, WD = 1e-2, 1e-2
FREEZE_CASES = {"none": ([], []), "plain": (["feature_extractor"], []),
                "layer_indexed": (["layers.1"], [])}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(numpy variables, port state dict)."""
    module = jax_registry.get_model("My_XLSR_AASIST", **KWARGS).module
    v = random_variables(module, np.zeros((2, 8000), np.float32), seed=4,
                         train=False)
    return v, convert.from_jax_variables(v, "My_XLSR_AASIST")


def _model(sd):
    model = registry.get_model("My_XLSR_AASIST", **KWARGS).module
    model.load_state_dict(sd, strict=True)
    return model


def _to_port(tree, stats):
    sd = convert.from_jax_variables({"params": tree, "batch_stats": stats},
                                    "My_XLSR_AASIST")
    return {k: t.numpy() for k, t in sd.items()}


def _run_both(v, sd, freeze, opt_kw, n_steps=3):
    """The same random gradients through optax and the port for
    ``n_steps``; -> (optax params in port names, port model, optax state)."""
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    tx = jax_steps.make_optimizer(LR, WD, freeze, (), **opt_kw)
    opt_j = tx.init(params)
    update = jax.jit(tx.update)     # as the JAX step: it sets bf16 rounding
    model = _model(sd)
    opt = steps.make_optimizer(model, LR, WD, freeze, (), **opt_kw)
    rng = np.random.default_rng(7)
    for _ in range(n_steps):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            v["params"])
        updates, opt_j = update(jax.tree_util.tree_map(jnp.asarray, grads),
                                opt_j, params)
        params = optax.apply_updates(params, updates)
        g_port = _to_port(grads, v["batch_stats"])
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g_port[name]) if p.requires_grad else None
        opt.step()
    return _to_port(jax.tree_util.tree_map(np.asarray, params),
                    v["batch_stats"]), model, opt, opt_j


@pytest.mark.parametrize("case", sorted(FREEZE_CASES))
def test_adafactor_matches_optax(tiny, case):
    v, sd = tiny
    freeze, _ = FREEZE_CASES[case]
    want, model, opt, _ = _run_both(v, sd, freeze, {"optimizer": "adafactor"})
    assert isinstance(opt, steps.Adafactor)
    factored = [n for n, p in model.named_parameters()
                if "v_row" in opt.state.get(p, {})]
    assert "ssl_model.model.encoder.layers.0.fc1.weight" in factored
    assert "LL.weight" in factored
    moved = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=2e-6, err_msg=name)
        moved += not np.array_equal(p.detach().numpy(), sd[name].numpy())
    frozen = [n for n in want
              if n in dict(model.named_parameters())
              and not steps.is_trainable(n, freeze)]
    assert bool(frozen) == (case != "none")
    for n in frozen:
        np.testing.assert_array_equal(dict(model.named_parameters())[n]
                                      .detach().numpy(), sd[n].numpy())
    assert moved > 0


def test_adafactor_frozen_layer_enters_block_rms(tiny):
    """With ``layers.1`` frozen, JAX's block RMS of layer 0's stacked
    leaves includes layer 1's gradients. Holding layer 1 out of the
    statistics would move layer 0's parameters measurably (the size of the
    difference the port avoids), which the port does not."""
    v, sd = tiny
    want, model, opt, _ = _run_both(v, sd, ["layers.1"],
                                    {"optimizer": "adafactor"})
    # the same run with layer 1 left out of the statistics altogether
    alone = _model(sd)
    for n, p in alone.named_parameters():
        p.requires_grad_(not n.startswith("ssl_model.model.encoder.layers.1."))
    blocks = {}
    for n, p in alone.named_parameters():
        if p.requires_grad:
            blocks.setdefault(steps._block_of(n), []).append((p, True))
    ref = steps.Adafactor(list(blocks.values()), LR, WD)
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = _to_port(jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32),
            v["params"]), v["batch_stats"])
        for n, p in alone.named_parameters():
            p.grad = torch.from_numpy(grads[n]) if p.requires_grad else None
        ref.step()
    name = "ssl_model.model.encoder.layers.0.fc1.weight"
    got = dict(model.named_parameters())[name].detach().numpy()
    other = dict(alone.named_parameters())[name].detach().numpy()
    assert np.abs(other - want[name]).max() > 1e-5
    assert np.abs(got - want[name]).max() <= 2e-6


def test_adam_mu_dtype_matches_optax(tiny):
    v, sd = tiny
    want, model, opt, opt_j = _run_both(v, sd, [], {"mu_dtype": "bfloat16"})
    assert isinstance(opt, steps.AdamWLowPrecisionMu)
    mu_j = _to_port(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        optax.tree_utils.tree_get(opt_j, "mu")), v["batch_stats"])
    past = total = 0
    for name, p in model.named_parameters():
        # a float32 moment on a rounding tie of the stored bf16 may round
        # either way, which moves the next update by up to one bf16 step of
        # the moment: lr 2^-8; everything else within float32 rounding
        d = np.abs(p.detach().numpy() - want[name])
        assert d.max() <= LR * 2 ** -8, (name, d.max())
        past, total = past + int((d > 1e-6).sum()), total + d.size
        mu = opt.state[p]["mu"]
        assert mu.dtype == torch.bfloat16
        # both round the same float32 moment to bf16: one bf16 step, two
        # where an earlier step's tie rounded the other way
        np.testing.assert_allclose(mu.float().numpy(), mu_j[name],
                                   rtol=2 ** -6, atol=1e-30, err_msg=name)
    assert past <= 1e-4 * total, (past, total)


def test_default_adamw_is_torch_adamw(tiny):
    _, sd = tiny
    opt = steps.make_optimizer(_model(sd), LR, WD)
    assert type(opt) is torch.optim.AdamW
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    with pytest.raises(ValueError, match="unknown optimizer"):
        steps.make_optimizer(_model(sd), LR, WD, optimizer="sgd")


@pytest.mark.parametrize("opt_kw", [{"optimizer": "adafactor"},
                                    {"mu_dtype": "bfloat16"}],
                         ids=["adafactor", "adam_mu_dtype"])
def test_optimizer_state_round_trips(tiny, tmp_path, opt_kw):
    """Two steps, save, restore into a fresh model and optimizer, one step:
    bit-equal to three unbroken steps."""
    _, sd = tiny
    rng = np.random.default_rng(3)
    grads = [{n: torch.from_numpy(rng.standard_normal(t.shape)
                                  .astype(np.float32))
              for n, t in sd.items()} for _ in range(3)]

    def state():
        model = _model(sd)
        return steps.TrainState(model, steps.make_optimizer(
            model, LR, WD, ["layers.1"], **opt_kw))

    def run(st, gs):
        for g in gs:
            for n, p in st.model.named_parameters():
                p.grad = g[n].clone() if p.requires_grad else None
            st.optimizer.step()
            st.step += 1

    straight, first = state(), state()
    run(straight, grads)
    run(first, grads[:2])
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, first, epoch=0)
    resumed = checkpoint.restore_checkpoint(path, state())
    assert resumed.step == 2
    run(resumed, grads[2:])
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = (s.optimizer.state_dict() for s in (straight, resumed))
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, t in st.items():
            other = sb["state"][i][k]
            assert (torch.equal(t, other) if torch.is_tensor(t)
                    else t == other), (i, k)
            if k == "mu":
                assert other.dtype == torch.bfloat16


# ------------------------------------------------------------ async writer

def _small_state():
    model = torch.nn.Linear(4, 3)
    return steps.TrainState(model, torch.optim.AdamW(model.parameters(),
                                                     lr=1e-3))


def test_async_save_snapshots_before_returning(tmp_path):
    """A parameter changed after ``save_checkpoint_async`` returns is not
    in the file, which holds what the synchronous writer writes."""
    st = _small_state()
    st.model(torch.ones(2, 4)).sum().backward()
    st.optimizer.step()
    st.step = 1
    want = {k: v.clone() for k, v in st.model.state_dict().items()}
    handle = checkpoint.save_checkpoint_async(str(tmp_path / "a"), st,
                                              epoch=3, meta={"epoch": 3})
    with torch.no_grad():
        st.model.weight.add_(1.0)
    handle.wait_until_finished()
    checkpoint.save_checkpoint(str(tmp_path / "s"), _restored(tmp_path / "a"),
                               epoch=3, meta={"epoch": 3})
    for sub in ("a", "s"):
        assert sorted(os.listdir(tmp_path / sub)) == ["meta.json", "state.pt"]
    got = torch.load(str(tmp_path / "a" / "state.pt"), weights_only=True)
    sync = torch.load(str(tmp_path / "s" / "state.pt"), weights_only=True)
    assert got["step"] == sync["step"] == 1 and got["epoch"] == 3
    for k, t in want.items():
        assert torch.equal(got["model"][k], t) and torch.equal(
            sync["model"][k], t), k
    assert got["optimizer"]["param_groups"] == sync["optimizer"]["param_groups"]
    assert json.loads((tmp_path / "a" / "meta.json").read_text()) == \
        {"epoch": 3}
    assert not torch.equal(st.model.weight.detach(), want["weight"])


def _restored(path):
    st = _small_state()
    return checkpoint.restore_checkpoint(str(path), st)


def test_async_save_error_surfaces(tmp_path, monkeypatch):
    """A failing write raises from ``wait_until_finished`` and, when not
    waited for, from the next save, which first waits for it."""
    st = _small_state()

    def boom(obj, path):
        raise OSError("disk full")
    monkeypatch.setattr(checkpoint.torch, "save", boom)
    handle = checkpoint.save_checkpoint_async(str(tmp_path / "a"), st)
    with pytest.raises(OSError, match="disk full"):
        handle.wait_until_finished()
    checkpoint.save_checkpoint_async(str(tmp_path / "b"), st)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint_async(str(tmp_path / "c"), st)
    monkeypatch.undo()
    checkpoint.save_checkpoint_async(str(tmp_path / "d"), st
                                     ).wait_until_finished()
    assert checkpoint.is_checkpoint(str(tmp_path / "d"))
    assert not os.path.exists(tmp_path / "a" / "state.pt")

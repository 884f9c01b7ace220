"""The port's knowledge distillation against the JAX package's, on the CPU.

Held: every ``KD_CRITERIA`` entry on seeded arrays; ``normalize_tap_path``
on a table through every branch; every kind of tap of a tiny
``My_XLSR_AASIST`` and ``My_XLSR_Conformer`` (eval mode, float32) against
JAX's ``resolve_tap`` on ``capture_intermediates``; ``copy_teacher_weights``
with a custom order against JAX's (BatchNorm statistics left at the
student's, fresh storage, an out-of-range order raising); two distillation
steps against ``make_kd_train_step`` with dropout the identity and no
augmentation (every metric, the student's parameters after AdamW, the
teacher untouched). tests/test_torch_kd_cli.py holds the CLI.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rtdsd_tpu.engine import kd as jax_kd
from rtdsd_tpu.engine import steps as jax_steps
from rtdsd_tpu.models import registry as jax_registry
from rtdsd_tpu.models.wav2vec2 import \
    resolve_layer_indices as jax_resolve_layer_indices
from rtdsd_tpu_torch.engine import kd, steps
from rtdsd_tpu_torch.models import convert, dropout, registry, taps
from rtdsd_tpu_torch.models.wav2vec2 import resolve_layer_indices

from _torch_track import random_variables

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
CONFORMER = {"emb_size": 16, "heads": 4, "kernel_size": 16, "n_encoders": 2}
SAMPLES = 8000
LR, WD = 1e-5, 1e-4
CE_WEIGHT = (0.9, 0.1)
# the shipped recipe's criteria (configs/kd_xlsr6_aasist.yaml) on a 3-layer
# teacher and a 2-layer student, plus attention transfer on a back-end tap
KD_KWARGS = {
    "ce_loss_weight": 1.0,
    "kd_criterions": [
        {"key": "KDLoss", "kwargs": {"student_module_path": "logits",
                                     "teacher_module_path": "logits",
                                     "temperature": 4.0}},
        {"key": "MSELoss", "kwargs": {
            "student_module_path": "ssl_model.model.encoder.layers.1",
            "teacher_module_path": "ssl_model.model.encoder.layers.2"}},
        {"key": "ATLoss", "kwargs": {"student_module_path": "GAT_layer_S",
                                     "teacher_module_path": "GAT_layer_S"}}],
    "kd_criterion_weights": [0.5, 1.0, 2.0]}
ORDER = [2, 0]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ criteria

@pytest.mark.parametrize("key", sorted(jax_kd.KD_CRITERIA))
def test_criteria_match_jax(key):
    assert set(kd.KD_CRITERIA) == set(jax_kd.KD_CRITERIA)
    rng = np.random.default_rng(len(key))
    labels = np.array([0, 1, 1], np.int32)
    for shape in ((3, 2), (3, 7, 5)):
        s, t = (rng.standard_normal(shape).astype(np.float32) * 2
                for _ in range(2))
        for kw in ({}, {"temperature": 4.0, "beta": 0.5}):
            want = float(jax_kd.KD_CRITERIA[key](jnp.asarray(s), jnp.asarray(t),
                                                 labels, **kw))
            got = float(kd.KD_CRITERIA[key](torch.from_numpy(s),
                                            torch.from_numpy(t),
                                            torch.from_numpy(labels), **kw))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{key} {shape} {kw}")


def test_get_mid_level_loss_raises_as_jax():
    fn, kw = kd.get_mid_level_loss({"key": "KDLoss",
                                    "kwargs": {"temperature": 2.0}})
    assert fn is kd.kl_div_loss and kw == {"temperature": 2.0}
    assert kd.get_mid_level_loss({})[0] is kd.mse_loss
    for mod in (kd, jax_kd):
        with pytest.raises(ValueError, match="Unknown KD criterion"):
            mod.get_mid_level_loss({"key": "NoSuchLoss"})


TAP_PATHS = [
    "ssl_model.model.encoder.layers.5", "module.ssl_model.model.encoder.layers.11",
    "model.encoder.layers.3", "encoder.layers.0", "ssl_model", "ssl_model.model",
    "ssl_model.model.encoder", "", ".", "logits", "out_layer", "fc5", "output",
    "backend.out_layer", "conformer.fc5", "backend.conformer.fc5",
    "encoder_blocks.1", "encoder_blocks.1.attn", "conformer.encoder_blocks.2",
    "conformer.encoder_blocks.2.ff1", "module.conformer.encoder_blocks.0.conv",
    "encoder.3", "backend.encoder.0", "encoder", "backend.encoder",
    "attention", "backend.attention", "LL", "first_bn", "first_bn1",
    "GAT_layer_T", "HtrgGAT_layer_ST22", "pool_hS1", "pool_T.proj",
    "conformer", "backend/pool_S", "some.other.path"]


def test_normalize_tap_path_matches_jax():
    for p in TAP_PATHS:
        assert kd.normalize_tap_path(p) == jax_kd.normalize_tap_path(p), p


# ------------------------------------------------------------ taps

AASIST_TAPS = ["ssl_model.model.encoder.layers.1", "ssl_model", "logits",
               "out_layer", "LL", "first_bn", "first_bn1", "encoder.3",
               "encoder", "attention", "GAT_layer_S", "GAT_layer_T",
               "HtrgGAT_layer_ST11", "HtrgGAT_layer_ST22", "pool_S",
               "pool_hT2"]
CONFORMER_TAPS = ["ssl_model.model.encoder.layers.0", "ssl_model", "fc5",
                  "LL", "first_bn", "conformer", "conformer.encoder_blocks.0",
                  "conformer.encoder_blocks.1.ff1",
                  "conformer.encoder_blocks.1.attn",
                  "conformer.encoder_blocks.0.conv",
                  "conformer.encoder_blocks.0.ff2",
                  "conformer.encoder_blocks.1.post_norm"]


@pytest.mark.parametrize("name,paths,extra", [
    ("My_XLSR_AASIST", AASIST_TAPS, {}),
    ("My_XLSR_Conformer", CONFORMER_TAPS, CONFORMER)],
    ids=["aasist", "conformer"])
def test_taps_match_jax_resolve_tap(name, paths, extra):
    kwargs = {"num_layers": 2, "w2v": W2V, **extra}
    module_j = jax_registry.get_model(name, **kwargs).module
    waves = (np.random.default_rng(0).standard_normal((2, SAMPLES)) * 0.3
             ).astype(np.float32)
    v = random_variables(module_j, waves, seed=1, train=False)
    needed = sorted({jax_kd.normalize_tap_path(p) for p in paths})
    fltr = jax_kd._capture_filter(needed)
    logits_j, mut = jax.jit(lambda v, w: module_j.apply(
        v, w, train=False, capture_intermediates=fltr,
        mutable=["intermediates"]))(v, jnp.asarray(waves))
    model = registry.get_model(name, **kwargs).module.eval()
    model.load_state_dict(convert.from_jax_variables(v, name), strict=True)
    with torch.no_grad(), taps.capture(needed) as got:
        logits = model(torch.from_numpy(waves))
    assert set(got) == set(needed) - {"logits"}
    for tp in needed:
        want = np.asarray(jax_kd.resolve_tap(tp, logits_j,
                                             mut["intermediates"]))
        have = kd.resolve_tap(tp, logits, got).numpy()
        assert have.shape == want.shape, (tp, have.shape, want.shape)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(have, want, rtol=0, atol=2e-5 * scale,
                                   err_msg=tp)
    with pytest.raises(KeyError, match="not found"):
        kd.resolve_tap("backend/nowhere", logits, got)
    assert not taps.active()


# ------------------------------------------------------------ weight copy

@pytest.fixture(scope="module")
def pair():
    """(teacher numpy variables, student numpy variables, inputs): a
    3-layer teacher and a 2-layer student of the tiny width, their
    BatchNorm statistics non-trivial."""
    waves = (np.random.default_rng(2).standard_normal((4, SAMPLES)) * 0.3
             ).astype(np.float32)
    t = random_variables(jax_registry.get_model(
        "My_XLSR_AASIST", num_layers=3, w2v=W2V).module, waves, seed=3,
        train=False)
    s = random_variables(jax_registry.get_model(
        "My_XLSR_AASIST", num_layers=2, w2v=W2V).module, waves, seed=4,
        train=False)
    return t, s, waves, np.array([0, 1, 1, 0], np.int32)


def _to_port(tree, stats):
    """A JAX params-shaped tree -> the port's names (numpy)."""
    sd = convert.from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, tree),
         "batch_stats": stats}, "My_XLSR_AASIST")
    return {k: t.numpy() for k, t in sd.items()}


def _port(v, layers, remat=False):
    model = registry.get_model("My_XLSR_AASIST", num_layers=layers, w2v=W2V,
                               remat=remat).module
    model.load_state_dict(convert.from_jax_variables(v, "My_XLSR_AASIST"),
                          strict=True)
    return model


def test_copy_teacher_weights_matches_jax(pair):
    t, s, _, _ = pair
    want = jax_kd.copy_teacher_weights(
        jax.tree_util.tree_map(jnp.asarray, s["params"]),
        jax.tree_util.tree_map(jnp.asarray, t["params"]), ORDER)
    want = convert.from_jax_variables(
        {"params": jax.tree_util.tree_map(np.asarray, want),
         "batch_stats": s["batch_stats"]}, "My_XLSR_AASIST")
    teacher, student = _port(t, 3), _port(s, 2)
    before = {k: v.clone() for k, v in student.state_dict().items()}
    copied = kd.copy_teacher_weights(student, teacher, ORDER)
    assert len(copied) == len(list(student.parameters()))
    for k, v in student.state_dict().items():
        assert torch.equal(v, want[k]), k
        if "running" in k or "num_batches" in k:      # statistics not copied
            assert torch.equal(v, before[k]), k
    sd_t = teacher.state_dict()
    assert torch.equal(
        student.state_dict()["ssl_model.model.encoder.layers.0.fc1.weight"],
        sd_t["ssl_model.model.encoder.layers.2.fc1.weight"])
    # fresh storage: changing the teacher leaves the student as it was
    ptrs = {p.data_ptr() for p in teacher.parameters()}
    assert not any(p.data_ptr() in ptrs for p in student.parameters())
    snap = {k: v.clone() for k, v in student.state_dict().items()}
    with torch.no_grad():
        for p in teacher.parameters():
            p.add_(1.0)
    assert all(torch.equal(v, snap[k]) for k, v in student.state_dict().items())


def test_copy_order_out_of_range_raises(pair):
    t, s, _, _ = pair
    with pytest.raises(ValueError, match="out of range"):
        kd.copy_teacher_weights(_port(s, 2), _port(t, 3), [0, 3])
    for resolve in (resolve_layer_indices, jax_resolve_layer_indices):
        with pytest.raises(ValueError, match="out of range"):
            resolve(3, 2, "custom", [0, 3])
    # without an order, layers copy only between equal depths (JAX's
    # stacked leaf shapes must agree)
    student = _port(s, 2)
    copied = kd.copy_teacher_weights(student, _port(t, 3))
    assert not any(".encoder.layers." in n for n in copied)
    assert "LL.weight" in copied


# ------------------------------------------------------------ KD step

def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def test_kd_step_rejects_weight_count():
    bad = dict(KD_KWARGS, kd_criterion_weights=[1.0])
    for make in (lambda: kd.make_kd_train_step(bad),
                 lambda: jax_kd.make_kd_train_step(None, None, None, bad)):
        with pytest.raises(ValueError, match="kd_criterion_weights has 1"):
            make()


@pytest.fixture(scope="module")
def kd_steps(pair):
    """Two KD steps on both sides, dropout off, no augmentation: JAX's
    metrics and student parameters (port names) after each, and the
    port's."""
    t, s, waves, labels = pair
    teacher_j = jax_registry.get_model("My_XLSR_AASIST", num_layers=3,
                                       w2v=W2V).module
    student_j = jax_registry.get_model("My_XLSR_AASIST", num_layers=2, w2v=W2V,
                                       remat=True).module
    tx = jax_steps.make_optimizer(LR, WD)
    params = jax.tree_util.tree_map(jnp.asarray, s["params"])
    state = jax_steps.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray, s["batch_stats"]),
        opt_state=tx.init(params))
    with fnn.intercept_methods(_no_dropout):
        step_j = jax_kd.make_kd_train_step(teacher_j, student_j, tx, KD_KWARGS,
                                           ce_weight=CE_WEIGHT)
        want = []
        for _ in range(2):
            state, m = step_j(state, t, jnp.asarray(waves), jnp.asarray(labels),
                              jax.random.key(0))
            want.append(({k: float(x) for k, x in m.items()},
                         convert.from_jax_variables(
                             jax.tree_util.tree_map(
                                 np.asarray, {"params": state.params,
                                              "batch_stats": state.batch_stats}),
                             "My_XLSR_AASIST"),
                         {k: _to_port(optax.tree_utils.tree_get(
                             state.opt_state, k), s["batch_stats"])
                          for k in ("mu", "nu")}))

    teacher, student = _port(t, 3), _port(s, 2, remat=True)
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    st = steps.TrainState(student, steps.make_optimizer(student, LR, WD))
    step = kd.make_kd_train_step(KD_KWARGS, ce_weight=CE_WEIGHT)
    got = []
    mp = pytest.MonkeyPatch()
    mp.setattr(dropout, "drop", lambda x, p, src: x)
    try:
        for _ in range(2):
            m = step(st, teacher, torch.from_numpy(waves),
                     torch.from_numpy(labels).long(), 1024)
            got.append(({k: float(x) for k, x in m.items()},
                        {k: v.clone() for k, v in student.state_dict().items()},
                        {k: {n: st.optimizer.state[p][key].clone().numpy()
                             for n, p in student.named_parameters()}
                         for k, key in (("mu", "exp_avg"),
                                        ("nu", "exp_avg_sq"))}))
    finally:
        mp.undo()
    return want, got, st, teacher, t_before


def test_kd_step_metrics_match_jax(kd_steps):
    want, got, st, _, _ = kd_steps
    assert st.step == 2
    names = {"total_loss", "ce_loss", "num_correct",
             "KDLoss_logits_logits", "MSELoss_ssl_hidden:1_ssl_hidden:2",
             "ATLoss_backend/GAT_layer_S_backend/GAT_layer_S"}
    for (mw, _, _), (mg, _, _) in zip(want, got):
        assert set(mw) == set(mg) == names
        for k in names:
            np.testing.assert_allclose(mg[k], mw[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        assert mg["MSELoss_ssl_hidden:1_ssl_hidden:2"] > 0
        # each weight applied once
        np.testing.assert_allclose(
            mg["total_loss"], mg["ce_loss"] + mg["KDLoss_logits_logits"]
            + mg["MSELoss_ssl_hidden:1_ssl_hidden:2"]
            + mg["ATLoss_backend/GAT_layer_S_backend/GAT_layer_S"], rtol=1e-6)


def _held_per_tensor(got: dict, want: dict, rel: float) -> None:
    """tests/test_torch_train.py's rule: each tensor within ``rel`` of its
    max |want|; tensors whose max is at most 1e-6 of the largest one's
    (zero in exact arithmetic) under 1e-6 of the largest."""
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        w, scale = want[name], float(np.abs(want[name]).max())
        if scale <= 1e-6 * top:
            assert float(np.abs(g).max()) <= 1e-6 * top, name
        else:
            err = float(np.abs(g - w).max())
            assert err <= rel * scale, (name, err, scale)


def test_kd_step_student_matches_jax_teacher_untouched(kd_steps):
    """AdamW's moments after the first step held per tensor to 1e-3 of
    their max (the first, and the square root of the second: the
    gradients' check, tests/test_torch_train.py; the second step's
    gradients are taken at parameters already up to 2 lr apart); after
    each step the student's BatchNorm statistics within 1e-5 and its
    parameters within 2 lr a step (Adam moves a parameter by about lr
    times the sign of its gradient, which may flip for a gradient near
    zero); the teacher's state bit for bit as it was, and no gradient on
    it."""
    want, got, _, teacher, t_before = kd_steps
    mw, mg = want[0][2], got[0][2]
    _held_per_tensor(mg["mu"], mw["mu"], 1e-3)
    _held_per_tensor({k: np.sqrt(a) for k, a in mg["nu"].items()},
                     {k: np.sqrt(a) for k, a in mw["nu"].items()}, 1e-3)
    for n_step, ((_, sw, _), (_, sg, _)) in enumerate(zip(want, got), start=1):
        for k, v in sg.items():
            if k.endswith("num_batches_tracked"):
                continue
            tol = 1e-5 if "running" in k else 2 * LR * n_step + 1e-6
            np.testing.assert_allclose(v.numpy(), sw[k].numpy(), rtol=0,
                                       atol=tol, err_msg=f"step {n_step} {k}")
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, t_before[k]), k
    assert all(p.grad is None for p in teacher.parameters())

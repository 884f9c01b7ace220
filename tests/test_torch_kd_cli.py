"""The port's distillation CLI against ``rtdsd_tpu.cli.main_kd``, on the CPU.

A tiny ASVspoof 2019 LA split (tests/_torch_track.py) and a 2-layer
``My_XLSR_AASIST`` teacher saved as a reference ``.pt``; the student is the
same family cut to teacher layer 1 (``custom_order_copy_weights: [1]``),
distilled with the shipped recipe's criteria (KDLoss at T=4 on logits, MSE
of student layer 0 against teacher layer 1, weights 0.5 and 1.0), no
augmentation, dropout the identity on both sides, lr 1e-6. Both CLIs run
one epoch (one step and the dev pass) in this process, the JAX side's
random init and orbax left out (see the fixture). Held: every logged
metric, the dev pass, the checkpoint directories' names and
``meta.json``, and the student's score file from ``--is_eval --eval
student --is_score``; the teacher's score file with ``--eval teacher``;
``--w8`` scoring of the student.
"""

import json
import os
import sys

import flax.linen as fnn
import numpy as np
import pytest
import torch

from rtdsd_tpu_torch.cli import main_kd as port_kd
from rtdsd_tpu_torch.models import dropout

from _torch_track import random_variables, write_split

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
N_TRAIN, N_DEV, BATCH = 4, 6, 4
KD_KWARGS = {
    "copy_weights": True, "custom_order_copy_weights": [1],
    "ce_loss_weight": 1.0,
    "student_kwargs": {"num_layers": 1, "order": "custom",
                       "custom_order": [1], "fused_gat": True, "w2v": W2V},
    "kd_criterions": [
        {"key": "KDLoss", "kwargs": {"student_module_path": "logits",
                                     "teacher_module_path": "logits",
                                     "temperature": 4.0}},
        {"key": "MSELoss", "kwargs": {
            "student_module_path": "ssl_model.model.encoder.layers.0",
            "teacher_module_path": "ssl_model.model.encoder.layers.1"}}],
    "kd_criterion_weights": [0.5, 1.0]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _config(root, side, train, dev, audio):
    out = root / side
    cfg = {"SysConfig": {
        "model": "My_XLSR_AASIST", "student_model": "My_XLSR_AASIST",
        "wandb_disabled": True, "num_workers": 2,
        "path_label_asv_spoof_2019_la_train": train,
        "path_asv_spoof_2019_la_train": audio,
        "path_label_asv_spoof_2019_la_dev": dev,
        "path_asv_spoof_2019_la_dev": audio,
        "path_label_asv_spoof_2019_la_eval": dev,
        "path_asv_spoof_2019_la_eval": audio,
        "la19_score_save_path": str(out / "scores_la19.txt"),
        "path_to_save_model": str(out / "runs"),
        "ssl_ckpt_path": "", "ssl_pytree_path": ""},
        "ExpConfig": {
            "random_seed": 42, "train_duration_sec": 0.5,
            "test_duration_sec": 0.5, "la19_eval_random_start": False,
            "batch_size_train": BATCH, "batch_size_test": BATCH,
            "lr": 1.0e-6, "weight_decay": 1.0e-4,
            "allow_data_augmentation": False, "data_augmentation": [],
            "compute_dtype": "float32", "mesh_data_axis": 1,
            "kwargs": {"num_layers": 2, "fused_gat": True, "w2v": W2V},
            "kd_kwargs": KD_KWARGS}}
    path = root / f"kd_{side}.json"
    # PyYAML (which reads the JSON) takes 1e-06 for a string: write 1.0e-06
    path.write_text(json.dumps(cfg).replace(": 1e-06", ": 1.0e-06"))
    return str(path)


def _init_state_shapes(m, rng, x, tx):
    """The JAX package's ``create_train_state`` without its op-by-op
    random init (half a minute on the CPU for these two models): flax's
    BatchNorm init (mean 0, var 1) and zeros elsewhere, on
    ``jax.eval_shape``'s shapes. The teacher's checkpoint and the copy of
    its weights replace every parameter this leaves at zero."""
    import jax
    from rtdsd_tpu.engine.steps import TrainState

    v = jax.eval_shape(lambda r, a: m.init(r, a, train=False), rng, x)
    v = jax.tree_util.tree_map_with_path(
        lambda path, a: (jax.numpy.ones if path[-1].key == "var"
                         else jax.numpy.zeros)(a.shape, a.dtype), v)
    return TrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                      params=v["params"], batch_stats=v["batch_stats"],
                      opt_state=tx.init(v["params"]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' epoch and student scoring; -> (root, {side: config})."""
    from rtdsd_tpu.cli import main_kd as jax_kd
    from rtdsd_tpu.models.export_reference import export_reference_model
    from rtdsd_tpu.models.registry import get_model

    root = tmp_path_factory.mktemp("torch_kd_cli")
    (root / "audio").mkdir()
    rng = np.random.default_rng(11)
    train = write_split(root, "LA_T", N_TRAIN, rng)
    dev = write_split(root, "LA_D", N_DEV, rng)
    module = get_model("My_XLSR_AASIST", num_layers=2, w2v=W2V).module
    v = random_variables(module, np.zeros((2, 8000), np.float32), seed=6,
                         train=False)
    teacher = str(root / "teacher.pt")
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in
                export_reference_model(v, "My_XLSR_AASIST").items()}, teacher)
    cfgs = {side: _config(root, side, train, dev, str(root / "audio"))
            for side in ("jax", "port")}
    score = ["--is_eval", "--eval", "student", "--is_score", "--tracks", "LA19"]
    from rtdsd_tpu.cli import common as jax_common

    with pytest.MonkeyPatch.context() as mp, \
            fnn.intercept_methods(_no_dropout):
        mp.setattr(jax_common, "create_train_state", _init_state_shapes)
        # JAX's async saves without orbax (its import takes 8 s here) take
        # the package's synchronous msgpack path, which scoring reads
        mp.setitem(sys.modules, "orbax.checkpoint", None)
        jax_kd.main(["--config", cfgs["jax"], "--ckpt", teacher,
                     "--max_epoch", "1"])
        jax_kd.main(["--config", cfgs["jax"], "--ckpt",
                     str(root / "jax" / "runs" / "last_kd")] + score)
    mp = pytest.MonkeyPatch()
    mp.setattr(dropout, "drop", lambda x, p, src: x)
    try:
        port_kd.main(["--config", cfgs["port"], "--ckpt", teacher,
                      "--max_epoch", "1", "--device", "cpu"])
    finally:
        mp.undo()
    port_kd.main(["--config", cfgs["port"], "--ckpt",
                  str(root / "port" / "runs" / "last_kd"), "--device", "cpu"]
                 + score)
    return root, cfgs, teacher


def _records(path):
    return [{k: v for k, v in json.loads(l).items() if k != "t"}
            for l in path.read_text().splitlines()]


def test_kd_cli_metrics_match_jax(runs):
    root, _, _ = runs
    want = _records(root / "jax" / "runs" / "kd_metrics.jsonl")
    got = _records(root / "port" / "runs" / "kd_metrics.jsonl")
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    steps_ = [r for r in got if "total_loss" in r]
    assert len(steps_) == N_TRAIN // BATCH
    assert {"MSELoss_ssl_hidden:0_ssl_hidden:1", "KDLoss_logits_logits",
            "ce_loss", "step"} <= set(steps_[0])
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                       err_msg=k)


def test_kd_cli_checkpoints_match_jax(runs):
    """The same directory names (the dev loss in the best one's name to
    five decimals, within 1e-5) and ``meta.json`` contents; the port's
    written by the background writer, whole."""
    root, _, _ = runs
    names = {side: sorted(os.listdir(root / side / "runs"))
             for side in ("jax", "port")}
    assert "last_kd" in names["port"] and "kd_metrics.jsonl" in names["port"]
    best = {side: [n for n in ns if n.startswith("student_best_epoch0_")]
            for side, ns in names.items()}
    assert len(best["port"]) == len(best["jax"]) == 1
    loss = {s: float(b[0].split("_")[3]) for s, b in best.items()}
    assert abs(loss["port"] - loss["jax"]) <= 1.1e-5
    assert best["port"][0].split("_")[4] == best["jax"][0].split("_")[4]
    for sub in ("last_kd", best["port"][0]):
        d = root / "port" / "runs" / sub
        assert sorted(os.listdir(d)) == ["meta.json", "state.pt"]
        blob = torch.load(str(d / "state.pt"), weights_only=True)
        assert blob["step"] == N_TRAIN // BATCH and blob["epoch"] == 0
    for sub in ("last_kd", "best"):
        a = json.loads((root / "port" / "runs" / (
            sub if sub == "last_kd" else best["port"][0]) / "meta.json"
                        ).read_text())
        b = json.loads((root / "jax" / "runs" / (
            sub if sub == "last_kd" else best["jax"][0]) / "meta.json"
                        ).read_text())
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], float):
                assert abs(a[k] - b[k]) <= 1e-5, k
            else:
                assert a[k] == b[k], k


def _scores(path):
    lines = path.read_text().splitlines()
    return [l.split()[0] for l in lines], np.array([float(l.split()[1])
                                                    for l in lines])


def test_kd_cli_student_scores_match_jax(runs):
    root, _, _ = runs
    ids_j, want = _scores(root / "jax" / "scores_la19.txt")
    ids, got = _scores(root / "port" / "scores_la19.txt")
    assert ids == ids_j == [f"LA_D_{i:04d}" for i in range(N_DEV)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_kd_cli_teacher_and_w8_scoring(runs):
    """``--eval teacher`` scores the teacher ``.pt`` as ``cli.main`` does;
    ``--w8`` scores the student with int8 transformer weights."""
    from rtdsd_tpu_torch.cli import main as port_main

    root, cfgs, teacher = runs
    out = root / "port"
    port_kd.main(["--config", cfgs["port"], "--is_eval", "--is_score",
                  "--ckpt", teacher, "--tracks", "LA19", "--comment",
                  "teacher", "--device", "cpu"])
    port_main.main(["--config", cfgs["port"], "--is_eval", "--is_score",
                    "--ckpt", teacher, "--tracks", "LA19", "--comment",
                    "main", "--device", "cpu"])
    ids, t_scores = _scores(out / "scores_la19_teacher.txt")
    assert np.array_equal(t_scores, _scores(out / "scores_la19_main.txt")[1])
    port_kd.main(["--config", cfgs["port"], "--is_eval", "--eval", "student",
                  "--is_score", "--w8", "--ckpt", str(out / "runs" / "last_kd"),
                  "--tracks", "LA19", "--comment", "w8", "--device", "cpu"])
    ids_w8, w8 = _scores(out / "scores_la19_w8.txt")
    _, fp = _scores(out / "scores_la19.txt")
    assert ids_w8 == ids and np.all(np.isfinite(w8))
    assert not np.array_equal(w8, fp)
    np.testing.assert_allclose(w8, fp, rtol=0, atol=0.1 * max(1.0, np.abs(fp).max()))

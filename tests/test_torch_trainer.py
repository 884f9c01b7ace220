"""The port's training loop on the CPU: loader, trainer, checkpoints, CLI.

A synthetic ASVspoof2019-LA-shaped corpus (sine clips for bonafide, noise
for spoof, WAV bytes under ``.flac`` names, some shorter than the 0.5 s
crop) and the tiny ``My_XLSR_AASIST`` of the verify config. Held: the
train loader's batches for epochs 0 and 1 equal to the JAX package's
``DataLoader`` on both decode paths; one ``Trainer`` epoch and its dev pass
(the pad rows left out of the loss); exact resume from a checkpoint
directory; SSL init from a fairseq ``.pt`` against the JAX converter; the
CLI training two epochs from that ``.pt`` and scoring from ``last/``;
``AverageMeter`` and ``EarlyStopping`` against the JAX package's.
"""

import json
import os

import numpy as np
import pytest
import torch

from rtdsd_tpu_torch.cli import main as port_main
from rtdsd_tpu_torch.config import load_yaml_config
from rtdsd_tpu_torch.data.dataset import ASVspoof2019LA
from rtdsd_tpu_torch.data.io import write_wav
from rtdsd_tpu_torch.data.loader import DataLoader
from rtdsd_tpu_torch.engine import checkpoint, steps
from rtdsd_tpu_torch.engine.trainer import Trainer
from rtdsd_tpu_torch.models import convert, convert_fairseq, registry, zoo
from rtdsd_tpu_torch.utils.logging import Logger

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
KWARGS = {"num_layers": 2, "w2v": W2V}
N_TRAIN, N_DEV, BATCH = 14, 6, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_split(root, prefix, n, rng):
    lines = []
    for i in range(n):
        t = np.arange(5000 + 900 * i) / 16000
        bona = i % 2 == 1
        wave = (0.3 * np.sin(2 * np.pi * (330 + 40 * i) * t) if bona
                else 0.2 * rng.standard_normal(len(t))).astype(np.float32)
        uid = f"{prefix}_{i:04d}"
        write_wav(str(root / "audio" / f"{uid}.flac"), wave, 16000)
        lines.append(f"LA_0001 {uid} - A0{1 + i % 3} "
                     f"{'bonafide' if bona else 'spoof'}")
    path = root / f"{prefix}.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(root, config path, fairseq-format SSL .pt) of the corpus."""
    root = tmp_path_factory.mktemp("torch_trainer")
    (root / "audio").mkdir()
    rng = np.random.default_rng(7)
    train = _write_split(root, "LA_T", N_TRAIN, rng)
    dev = _write_split(root, "LA_D", N_DEV, rng)
    audio = str(root / "audio")
    cfg = {"SysConfig": {
        "model": "My_XLSR_AASIST", "wandb_disabled": True, "num_workers": 2,
        "path_label_asv_spoof_2019_la_train": train,
        "path_asv_spoof_2019_la_train": audio,
        "path_label_asv_spoof_2019_la_dev": dev,
        "path_asv_spoof_2019_la_dev": audio,
        "path_label_asv_spoof_2019_la_eval": dev,
        "path_asv_spoof_2019_la_eval": audio,
        "la19_score_save_path": str(root / "scores_la19.txt"),
        "path_to_save_model": str(root / "runs"),
        "ssl_ckpt_path": _fairseq_pt(root), "ssl_pytree_path": ""},
        "ExpConfig": {
            "random_seed": 42, "train_duration_sec": 0.5,
            "test_duration_sec": 0.5, "is_random_start": True,
            "la19_eval_random_start": False,
            "batch_size_train": BATCH, "batch_size_test": BATCH, "lr": 1e-3,
            "allow_data_augmentation": True,
            "data_augmentation": ["RawBoost4"], "compute_dtype": "float32",
            "kwargs": KWARGS}}
    path = root / "train.json"
    path.write_text(json.dumps(cfg))
    return root, str(path), cfg["SysConfig"]["ssl_ckpt_path"]


def _fairseq_pt(root):
    """A fairseq-format checkpoint of a tiny 3-layer encoder: fairseq names,
    a weight-normed positional conv, and the pre-training heads."""
    model = registry.get_model("My_XLSR_AASIST", num_layers=3,
                               w2v=W2V).module
    zoo.init_weights(model, 5)
    sd = {k[len("ssl_model.model."):]: v for k, v in model.state_dict().items()
          if k.startswith("ssl_model.model.")}
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True
                                                     ).sqrt() * 1.5
    sd["encoder.pos_conv.0.weight_v"] = w
    sd.update({"mask_emb": torch.zeros(32), "quantizer.vars": torch.zeros(1, 8, 4),
               "quantizer.weight_proj.weight": torch.zeros(8, 32),
               "project_q.weight": torch.zeros(4, 4),
               "final_proj.weight": torch.zeros(4, 32)})
    path = root / "xlsr_fairseq.pt"
    torch.save({"model": sd, "cfg": {"model": {"_name": "wav2vec2"}}}, str(path))
    return str(path)


def _configs(cfg_path):
    return load_yaml_config(cfg_path)


# ------------------------------------------------------------- loader

@pytest.mark.parametrize("native", [True, False])
def test_train_loader_matches_jax(corpus, native):
    from rtdsd_tpu.config import load_yaml_config as jax_load
    from rtdsd_tpu.data.dataset import ASVspoof2019LA as JaxLA
    from rtdsd_tpu.data.loader import DataLoader as JaxLoader
    from rtdsd_tpu.native import flac as jax_flac

    assert jax_flac.build_if_needed()
    _, cfg, _ = corpus
    sysc, exp = _configs(cfg)
    ours = DataLoader(ASVspoof2019LA(sysc, exp, is_train=True), BATCH,
                      shuffle=True, drop_last=True, seed=exp.random_seed,
                      num_workers=2, use_native=native)
    theirs = JaxLoader(JaxLA(*jax_load(cfg), is_train=True), BATCH,
                       shuffle=True, drop_last=True, seed=exp.random_seed,
                       num_workers=2, use_native=native)
    assert len(ours) == len(theirs) == N_TRAIN // BATCH
    orders = []
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == N_TRAIN // BATCH
        for x, y in zip(a, b):
            assert x.utt_ids == y.utt_ids and x.valid == y.valid == BATCH
            np.testing.assert_array_equal(x.labels, y.labels)
            np.testing.assert_array_equal(x.waves, y.waves)
        orders.append([u for x in a for u in x.utt_ids])
    assert orders[0] != orders[1]              # reshuffled per epoch


# ------------------------------------------------------------- trainer

def _state(exp, seed=0):
    spec = registry.get_model("My_XLSR_AASIST", remat=True, **KWARGS)
    zoo.init_weights(spec.module, seed)
    return steps.TrainState(spec.module, steps.make_optimizer(
        spec.module, exp.lr, exp.weight_decay))


def test_trainer_epoch_and_dev_pass(corpus, tmp_path):
    _, cfg, _ = corpus
    sysc, exp = _configs(cfg)
    state = _state(exp)
    mk = lambda ds, sh: DataLoader(ds, BATCH, shuffle=sh, drop_last=sh,
                                   seed=exp.random_seed, use_native=False)
    train = mk(ASVspoof2019LA(sysc, exp, is_train=True), True)
    dev_set = ASVspoof2019LA(sysc, exp, is_train=False)
    logger = Logger(sysc, metrics_path=str(tmp_path / "m.jsonl"))
    trainer = Trainer(state, train, mk(dev_set, False), None, logger, exp,
                      torch.device("cpu"), rng_seed=exp.random_seed)
    loss = trainer.train()
    assert np.isfinite(loss) and trainer.epoch == 1
    assert state.step == N_TRAIN // BATCH
    dev_loss, dev_acc = trainer.test(is_dev=True)
    logger.close()
    # the dev loss is the weighted CE of the 6 real rows; the padded last
    # batch's 2 repeated rows are left out
    waves = torch.from_numpy(np.stack([dev_set.get(i)[1] for i in range(N_DEV)]))
    labels = torch.tensor([dev_set.trials[i].label for i in range(N_DEV)])
    out = steps.make_eval_step(state.model, ce_weight=exp.ce_weight)(waves, labels)
    want = sum(float(steps.make_eval_step(state.model, ce_weight=exp.ce_weight)(
        waves[s:s + BATCH], labels[s:s + BATCH])["loss"]) * len(labels[s:s + BATCH])
        for s in range(0, N_DEV, BATCH)) / N_DEV
    assert dev_loss == pytest.approx(want, rel=1e-5)
    assert dev_acc == pytest.approx(100.0 * float(out["correct"].float().mean()))
    recs = [json.loads(l) for l in (tmp_path / "m.jsonl").read_text().splitlines()]
    keys = set().union(*recs)
    assert {"Loss", "Train Acc", "Dev Acc", "Dev Loss", "Dev EER"} <= keys
    assert all(np.isfinite(r["Loss"]) for r in recs if "Loss" in r)


def test_resume_is_exact(corpus, tmp_path):
    """2 steps, save, restore into a fresh model, 1 step == 3 steps straight
    (RawBoost4 and the back-end's dropout draw from (seed, step))."""
    _, cfg, _ = corpus
    sysc, exp = _configs(cfg)
    batches = list(DataLoader(ASVspoof2019LA(sysc, exp, is_train=True), BATCH,
                              shuffle=True, drop_last=True, use_native=False))
    train = steps.make_train_step(rawboost_algo=4)

    def run(state, bs):
        for b in bs:
            train(state, torch.from_numpy(b.waves),
                  torch.from_numpy(b.labels).long(), 42)

    straight = _state(exp)
    run(straight, batches[:3])
    first = _state(exp)
    run(first, batches[:2])
    path = str(tmp_path / "ck")
    checkpoint.save_checkpoint(path, first, epoch=0, meta={"epoch": 0})
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt"]
    resumed = checkpoint.restore_checkpoint(path, _state(exp, seed=9))
    assert resumed.step == 2
    assert json.loads(open(os.path.join(path, "meta.json")).read()) == \
        {"epoch": 0}
    run(resumed, batches[2:3])
    for (k, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = (s.optimizer.state_dict()["state"] for s in (straight, resumed))
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


# ------------------------------------------------------------- SSL init

def test_fairseq_ssl_init_matches_jax_converter(corpus):
    from rtdsd_tpu.models.convert_fairseq import (convert_w2v_checkpoint,
                                                  load_torch_state_dict)

    _, _, pt = corpus
    got = convert_fairseq.encoder_state_dict(pt)
    want = convert._w2v(convert_w2v_checkpoint(load_torch_state_dict(pt)), "")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    enc = registry.get_model("My_XLSR_AASIST", num_layers=3,
                             w2v=W2V).module.ssl_model.model
    enc.load_state_dict(got, strict=True)


def test_init_state_selects_student_layers(corpus):
    from rtdsd_tpu_torch.cli.common import build_model, init_state

    _, cfg, pt = corpus
    sysc, exp = _configs(cfg)
    exp.kwargs = {**KWARGS, "order": "custom", "custom_order": [2, 0]}
    spec = build_model(sysc, exp, torch.device("cpu"), train=True)
    state = init_state(spec, sysc, exp, seed=1)
    full = convert_fairseq.encoder_state_dict(pt)
    enc = state.model.ssl_model.model.state_dict()
    for new, old in ((0, 2), (1, 0)):
        key = "encoder.layers.{}.fc1.weight"
        assert torch.equal(enc[key.format(new)], full[key.format(old)])
    assert state.model.training and spec.module.ssl_model.model.encoder.remat
    # the same checkpoint as a pytree directory (ssl_pytree_path, which
    # takes precedence) gives the same encoder
    from rtdsd_tpu_torch.cli import convert as port_convert

    port_convert.main(["--fairseq", pt, "--out", pt + ".pytree"])
    sysc.ssl_pytree_path = pt + ".pytree"
    again = init_state(build_model(sysc, exp, torch.device("cpu"), train=True),
                       sysc, exp, seed=1).model.ssl_model.model.state_dict()
    assert all(torch.equal(again[k], t) for k, t in enc.items())


# ------------------------------------------------------------- CLI

def test_cli_trains_and_scores_from_last(corpus):
    root, cfg, _ = corpus
    port_main.main(["--config", cfg, "--max_epoch", "2", "--device", "cpu"])
    last = root / "runs" / "last"
    assert sorted(os.listdir(last)) == ["meta.json", "state.pt"]
    assert json.loads((last / "meta.json").read_text())["epoch"] == 1
    assert torch.load(str(last / "state.pt"), weights_only=True)["step"] == \
        2 * (N_TRAIN // BATCH)
    recs = [json.loads(l) for l in
            (root / "runs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["Loss"] for r in recs if "Loss" in r]
    assert len(losses) == 2 * (N_TRAIN // BATCH) and np.all(np.isfinite(losses))
    assert sum("Dev Loss" in r for r in recs) == 2
    port_main.main(["--config", cfg, "--is_eval", "--is_score", "--ckpt",
                    str(last), "--tracks", "LA19", "--device", "cpu"])
    lines = (root / "scores_la19.txt").read_text().splitlines()
    assert [l.split()[0] for l in lines] == [f"LA_D_{i:04d}" for i in range(N_DEV)]
    assert np.all(np.isfinite([float(l.split()[1]) for l in lines]))


def test_cli_train_probes(corpus, tmp_path):
    root, cfg, _ = corpus
    raw = json.loads(open(cfg).read())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main.main(["--config", cfg, "--max_epoch", "1"])
    # remat_policy hidden trains through the CLI for an epoch
    raw["ExpConfig"]["kwargs"] = {**KWARGS, "w2v": {**W2V,
                                                    "remat_policy": "hidden"}}
    raw["SysConfig"]["path_to_save_model"] = str(tmp_path / "remat_runs")
    conf = tmp_path / "remat_hidden.json"
    conf.write_text(json.dumps(raw))
    port_main.main(["--config", str(conf), "--max_epoch", "1", "--device",
                    "cpu"])
    recs = [json.loads(l) for l in open(tmp_path / "remat_runs"
                                        / "metrics.jsonl")]
    assert np.all(np.isfinite([r["Loss"] for r in recs if "Loss" in r]))
    # a directory without a checkpoint the port or the JAX package writes
    from rtdsd_tpu_torch.cli.common import load_checkpoint_for_eval

    (tmp_path / "jaxdir").mkdir()
    with pytest.raises(FileNotFoundError, match="state.msgpack"):
        load_checkpoint_for_eval(str(tmp_path / "jaxdir"),
                                 registry.get_model("My_XLSR_AASIST", **KWARGS))


# ------------------------------------------------------------- metrics

def test_meters_match_jax(tmp_path):
    from rtdsd_tpu.utils.metrics import AverageMeter as JaxMeter
    from rtdsd_tpu.utils.metrics import EarlyStopping as JaxStop
    from rtdsd_tpu_torch.utils.metrics import AverageMeter, EarlyStopping

    a, b = AverageMeter("loss"), JaxMeter("loss")
    for val, n in ((0.5, 4), (0.25, 2), (1.0, 1)):
        a.update(val, n)
        b.update(val, n)
    assert (a.avg, a.sum, a.count, str(a)) == (b.avg, b.sum, b.count, str(b))
    stops = []
    for cls, sub in ((EarlyStopping, "port"), (JaxStop, "jax")):
        s = cls(patience=2, save_dir=str(tmp_path / sub))
        saved = []
        for epoch, metric in enumerate((0.5, 0.4, 0.45, 0.41, 0.3)):
            s(metric, epoch, lambda p: (os.makedirs(p), saved.append(p)))
            if s.early_stop:
                break
        stops.append((epoch, s.counter, [os.path.basename(p) for p in saved],
                      sorted(os.listdir(tmp_path / sub))))
    assert stops[0] == stops[1] == (3, 2, ["best_checkpoint_0",
                                           "best_checkpoint_1"],
                                    ["best_checkpoint_1"])

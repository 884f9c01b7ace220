"""A synthetic LA21 track and reference-format ``.pt`` files of tiny JAX
models, shared by the port's CLI tests (tests/test_torch_cli.py,
tests/test_torch_quant.py, tests/test_torch_scoring.py).

Sine clips for bonafide, noise for spoof, WAV bytes under ``.flac`` names;
the tiny ``My_XLSR_AASIST`` (2 layers, width 32) is initialised in JAX with
non-trivial BatchNorm statistics and exported with
``export_reference_model``. :func:`make_conformer` adds a tiny
``My_XLSR_Conformer`` for the same track, its weights made with numpy by
:func:`random_variables` on the JAX module's shapes. The train CLI tests
(tests/test_torch_conformer_train.py, tests/test_torch_convert.py,
tests/test_torch_augment.py) share an ASVspoof 2019 LA split
(:func:`write_split`), an SSL pytree directory (:func:`write_ssl_pytree`)
and tiny copies of the shipped configs (:func:`tiny_shipped_config`).
"""

import json
import os

import numpy as np
import torch

from rtdsd_tpu_torch.data.io import write_wav

N_CLIPS = 10                     # two batches of 8, the last one padded
N_TRAIN, N_DEV, BATCH = 8, 6, 4  # the train CLI tests' ASVspoof 2019 split


def _config(root, model_pt_dir, model="My_XLSR_AASIST", head="    fused_gat: true",
            name="cfg"):
    cfg = f"""
SysConfig:
  wandb_disabled: true
  model: {model}
  path_label_asv_spoof_2021_la_eval: {root}/la21.txt
  path_asv_spoof_2021_la_eval: {root}/audio
  la21_score_save_path: {root}/scores_la21.txt
  path_to_save_model: {model_pt_dir}
  num_workers: 1
ExpConfig:
  random_seed: 42
  test_duration_sec: 0.5
  batch_size_test: 8
  compute_dtype: float32
  kwargs:
    num_layers: 2
{head}
    w2v:
      encoder_embed_dim: 32
      encoder_ffn_dim: 64
      encoder_heads: 4
      conv_pos: 16
      conv_pos_groups: 4
      conv_layers: [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]
"""
    path = root / f"{name}.yaml"
    path.write_text(cfg)
    return str(path)


def write_track(root):
    """Write the clips and the LA21 protocol under ``root``; returns the
    numpy generator that drew them, for the caller's further draws."""
    os.makedirs(root / "audio")
    rng = np.random.default_rng(7)
    lines = []
    for i in range(N_CLIPS):
        t = np.arange(9000 + 300 * i) / 16000
        bona = i % 2 == 1
        wave = (0.3 * np.sin(2 * np.pi * 440 * t) if bona
                else 0.2 * rng.standard_normal(len(t))).astype(np.float32)
        uid = f"LA_E_{i:04d}"
        write_wav(str(root / "audio" / f"{uid}.flac"), wave, 16000)
        lines.append(f"LA_0001 {uid} - A01 {'bonafide' if bona else 'spoof'}")
    (root / "la21.txt").write_text("\n".join(lines) + "\n")
    return rng


def make_track(root):
    """(root, config path, .pt path) of the track written under ``root``."""
    import jax
    import jax.numpy as jnp

    from rtdsd_tpu.config import load_yaml_config
    from rtdsd_tpu.models.export_reference import export_reference_model
    from rtdsd_tpu.models.registry import get_model

    rng = write_track(root)
    cfg = _config(root, root / "runs")

    _, exp = load_yaml_config(cfg)
    spec = get_model("My_XLSR_AASIST", **exp.kwargs)
    v = jax.jit(lambda w: spec.module.init(jax.random.key(0), w, train=False))(
        jnp.zeros((2, 8000), jnp.float32))
    stats = jax.tree_util.tree_map(      # non-trivial BN running statistics
        lambda a: np.asarray(rng.uniform(0.5, 1.5, a.shape), np.float32),
        v["batch_stats"])
    sd = export_reference_model({"params": v["params"], "batch_stats": stats},
                                "My_XLSR_AASIST")
    pt = root / "model.pt"
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in sd.items()},
               str(pt))
    return root, cfg, str(pt)


def random_variables(module, *inputs, seed=0, **kwargs):
    """Seeded numpy weights on the variables' shapes of a JAX module's init
    (``jax.eval_shape``: nothing is compiled): matrices ~ N(0, 1/fan_in),
    embeddings ~ N(0, 1/width), norm scales near 1, BatchNorm statistics
    non-trivial."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.key(0), *a, **kwargs),
        *(jnp.asarray(a) for a in inputs))
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if not hasattr(v, "shape"):
                out[k] = fill(v)
                continue
            shape = v.shape
            if k == "var":
                a = rng.uniform(0.5, 1.5, shape)
            elif k == "scale":
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            elif k in ("bias", "mean"):
                a = 0.1 * rng.standard_normal(shape)
            elif k == "embedding":
                a = rng.standard_normal(shape) * shape[-1] ** -0.5
            else:
                a = rng.standard_normal(shape) * np.prod(shape[:-1]) ** -0.5
            out[k] = a.astype(np.float32)
        return out

    return fill(shapes)


CONFORMER_HEAD = """    emb_size: 16
    heads: 4
    kernel_size: 16
    n_encoders: 4"""


def make_conformer(root, seed=3):
    """(config path, .pt path) of a tiny ``My_XLSR_Conformer`` (2 layers,
    width 32, emb 16, 4 blocks as the JAX CLI reads a .pt, an even
    depthwise kernel) with weights from ``seed``, for the track under
    ``root`` (:func:`write_track`)."""
    from rtdsd_tpu.config import load_yaml_config
    from rtdsd_tpu.models.export_reference import export_reference_model
    from rtdsd_tpu.models.registry import get_model

    cfg = _config(root, root / "runs", model="My_XLSR_Conformer",
                  head=CONFORMER_HEAD, name="conformer")
    _, exp = load_yaml_config(cfg)
    spec = get_model("My_XLSR_Conformer", **exp.kwargs)
    v = random_variables(spec.module, np.zeros((2, 8000), np.float32),
                         seed=seed, train=False)
    sd = export_reference_model(v, "My_XLSR_Conformer")
    pt = root / f"conformer_seed{seed}.pt"
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in sd.items()},
               str(pt))
    return cfg, str(pt)


# ------------------------------------------------ the train CLI tests

def write_split(root, prefix, n, rng):
    """``n`` clips of 0.31-0.7 s (sines bonafide, noise spoof) under
    ``root/audio`` and their ASVspoof 2019 LA protocol; -> its path."""
    lines = []
    for i in range(n):
        t = np.arange(5000 + 700 * i) / 16000
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


def write_ssl_pytree(root, w2v, seed=5, layers=3):
    """A tiny fairseq-format SSL ``.pt`` (weight-normed positional conv) of
    an encoder of ``layers`` layers configured by ``w2v``, converted by
    ``rtdsd_tpu_torch.cli.convert --fairseq`` into a pytree directory;
    -> (pt path, pytree directory)."""
    from rtdsd_tpu_torch.cli import convert as port_convert
    from rtdsd_tpu_torch.models import registry, zoo

    model = registry.get_model("My_XLSR_AASIST", num_layers=layers,
                               w2v=w2v).module
    zoo.init_weights(model, seed)
    pre = "ssl_model.model."
    sd = {k[len(pre):]: v for k, v in model.state_dict().items()
          if k.startswith(pre)}
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_g"] = w.pow(2).sum(
        dim=(0, 1), keepdim=True).sqrt() * 1.5
    sd["encoder.pos_conv.0.weight_v"] = w
    pt = str(root / "xlsr_fairseq.pt")
    torch.save({"model": sd}, pt)
    out = str(root / "xlsr_jax")
    port_convert.main(["--fairseq", pt, "--out", out])
    return pt, out


def tiny_shipped_config(root, shipped, model, kwargs, pytree, rng):
    """``configs/{shipped}`` cut to a tiny size: its recipe (compute dtype,
    augmentation, optimizer, pre-emphasis) with a pruned width-32 model,
    0.5 s crops, batch 4, the synthetic corpus under ``root`` and
    ``ssl_pytree_path`` on ``pytree``; -> the JSON config's path."""
    from rtdsd_tpu_torch.config import load_yaml_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sysc, expc = load_yaml_config(os.path.join(repo, "configs", shipped))
    (root / "audio").mkdir(exist_ok=True)
    train = write_split(root, "LA_T", N_TRAIN, rng)
    dev = write_split(root, "LA_D", N_DEV, rng)
    audio = str(root / "audio")
    cfg = {"SysConfig": {
        "model": model, "wandb_disabled": True, "num_workers": 2,
        "path_label_asv_spoof_2019_la_train": train,
        "path_asv_spoof_2019_la_train": audio,
        "path_label_asv_spoof_2019_la_dev": dev,
        "path_asv_spoof_2019_la_dev": audio,
        "path_label_asv_spoof_2019_la_eval": dev,
        "path_asv_spoof_2019_la_eval": audio,
        "la19_score_save_path": str(root / "scores_la19.txt"),
        "path_to_save_model": str(root / "runs"),
        "ssl_ckpt_path": "", "ssl_pytree_path": pytree},
        "ExpConfig": {
            "random_seed": expc.random_seed, "train_duration_sec": 0.5,
            "test_duration_sec": 0.5, "la19_eval_random_start": False,
            "is_pre_emphasis": expc.is_pre_emphasis,
            "pre_emphasis": expc.pre_emphasis,
            "batch_size_train": BATCH, "batch_size_test": BATCH,
            "lr": 1.0e-3, "weight_decay": expc.weight_decay,
            "allow_data_augmentation": expc.allow_data_augmentation,
            "data_augmentation": list(expc.data_augmentation),
            "compute_dtype": expc.compute_dtype, "kwargs": kwargs}}
    path = root / "train.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def run_cli_epochs(root, cfg, epochs):
    """Train ``epochs`` epochs through the CLI on the CPU and score the dev
    set from ``last/``: finite losses, one a batch, a dev pass an epoch,
    ``last/`` written, a finite score for every dev clip in order."""
    from rtdsd_tpu_torch.cli import main as port_main

    port_main.main(["--config", cfg, "--max_epoch", str(epochs), "--device",
                    "cpu"])
    last = root / "runs" / "last"
    assert sorted(os.listdir(last)) == ["meta.json", "state.pt"]
    assert json.loads((last / "meta.json").read_text())["epoch"] == epochs - 1
    recs = [json.loads(l) for l in
            (root / "runs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["Loss"] for r in recs if "Loss" in r]
    assert len(losses) == epochs * (N_TRAIN // BATCH)
    assert np.all(np.isfinite(losses))
    assert sum("Dev Loss" in r for r in recs) == epochs
    port_main.main(["--config", cfg, "--is_eval", "--is_score", "--ckpt",
                    str(last), "--tracks", "LA19", "--device", "cpu"])
    lines = (root / "scores_la19.txt").read_text().splitlines()
    assert [l.split()[0] for l in lines] == [f"LA_D_{i:04d}"
                                             for i in range(N_DEV)]
    assert np.all(np.isfinite([float(l.split()[1]) for l in lines]))

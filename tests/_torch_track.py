"""A synthetic LA21 track and reference-format ``.pt`` files of tiny JAX
models, shared by the port's CLI tests (tests/test_torch_cli.py,
tests/test_torch_quant.py, tests/test_torch_scoring.py).

Sine clips for bonafide, noise for spoof, WAV bytes under ``.flac`` names;
the tiny ``My_XLSR_AASIST`` (2 layers, width 32) is initialised in JAX with
non-trivial BatchNorm statistics and exported with
``export_reference_model``. :func:`make_conformer` adds a tiny
``My_XLSR_Conformer`` for the same track, its weights made with numpy by
:func:`random_variables` on the JAX module's shapes.
"""

import os

import numpy as np
import torch

from rtdsd_tpu_torch.data.io import write_wav

N_CLIPS = 10                     # two batches of 8, the last one padded


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

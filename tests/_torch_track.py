"""A synthetic LA21 track and a reference-format ``.pt`` of a tiny JAX
model, shared by the port's CLI tests (tests/test_torch_cli.py,
tests/test_torch_quant.py).

Sine clips for bonafide, noise for spoof, WAV bytes under ``.flac`` names;
the tiny ``My_XLSR_AASIST`` (2 layers, width 32) is initialised in JAX with
non-trivial BatchNorm statistics and exported with
``export_reference_model``.
"""

import os

import numpy as np
import torch

from rtdsd_tpu_torch.data.io import write_wav

N_CLIPS = 10                     # two batches of 8, the last one padded


def _config(root, model_pt_dir):
    cfg = f"""
SysConfig:
  wandb_disabled: true
  model: My_XLSR_AASIST
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
    fused_gat: true
    w2v:
      encoder_embed_dim: 32
      encoder_ffn_dim: 64
      encoder_heads: 4
      conv_pos: 16
      conv_pos_groups: 4
      conv_layers: [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]
"""
    path = root / "cfg.yaml"
    path.write_text(cfg)
    return str(path)


def make_track(root):
    """(root, config path, .pt path) of the track written under ``root``."""
    import jax
    import jax.numpy as jnp

    from rtdsd_tpu.config import load_yaml_config
    from rtdsd_tpu.models.export_reference import export_reference_model
    from rtdsd_tpu.models.registry import get_model

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

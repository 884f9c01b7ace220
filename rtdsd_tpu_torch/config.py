"""Typed configuration with the reference YAML schema.

The port's own copy of ``rtdsd_tpu/config.py``: the same ``SysConfig`` /
``ExpConfig`` keys and defaults, so one config file drives both packages.
Loading uses PyYAML when it is installed; without it the file is parsed as
JSON (a subset of YAML), so configs written in JSON syntax load anywhere.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class SysConfig:
    """System-level config: dataset paths, logging, model names."""

    wandb_disabled: bool = False
    wandb_project: str = "ASV-Spoofing"
    wandb_name: str = "rtdsd-tpu"
    wandb_entity: str = ""
    wandb_key: str = ""
    wandb_notes: str = ""

    path_label_asv_spoof_2019_la_train: str = ""
    path_label_asv_spoof_2019_la_dev: str = ""
    path_asv_spoof_2019_la_train: str = ""
    path_asv_spoof_2019_la_dev: str = ""
    path_label_asv_spoof_2019_la_eval: str = ""
    path_asv_spoof_2019_la_eval: str = ""

    path_label_asv_spoof_2021_la_eval: str = ""
    path_label_asv_spoof_2021_la_eval_spec: bool = False
    path_asv_spoof_2021_la_eval: str = ""

    path_asv_spoof_2021_df_eval: str = ""
    path_label_asv_spoof_2021_df_eval: str = ""

    num_workers: int = 4
    # "raise" aborts on undecodable audio; "skip" warns and drops the row
    decode_error_policy: str = "raise"

    path_to_save_model: str = "./runs"
    df21_score_save_path: str = "./runs"
    la21_score_save_path: str = "./runs"
    la19_score_save_path: str = "./runs"

    path_itw_eval: str = ""
    path_label_itw_eval: str = ""
    path_in_the_wild: str = ""
    path_label_in_the_wild: str = ""

    path_asvspoof5: str = ""
    path_label_asvspoof5: str = ""
    asvspoof5_score_save_path: str = "./runs"
    itw_score_save_path: str = "./runs"

    model: str = "XLSR_AASIST"
    student_model: str = "XLSR_AASIST"

    ssl_ckpt_path: str = ""
    ssl_pytree_path: str = ""
    noise_path: str = ""

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "SysConfig":
        return _from_dict(cls, cfg)


@dataclass
class ExpConfig:
    """Experiment config (same keys and defaults as the JAX package)."""

    random_seed: int = 1024
    is_pre_emphasis: bool = True
    is_random_start: bool = False
    include_non_speech: bool = True
    include_residual: bool = True
    pre_emphasis: float = 0.97
    sample_rate: int = 16000
    train_duration_sec: float = 4
    test_duration_sec: float = 4
    batch_size_train: int = 32
    batch_size_test: int = 40
    lr: float = 1e-6
    weight_decay: float = 1e-4
    max_epoch: int = 100
    allow_data_augmentation: bool = False
    data_augmentation: List[str] = field(default_factory=lambda: ["ACN"])
    restore_checkpoint: Optional[str] = None
    kwargs: Dict[str, Any] = field(default_factory=dict)
    kd_kwargs: Dict[str, Any] = field(default_factory=dict)

    compute_dtype: str = "bfloat16"
    prefetch: int = 2
    mesh_data_axis: int = -1
    mesh_model_axis: int = 1
    parallel_mode: str = ""
    ce_weight: List[float] = field(default_factory=lambda: [0.9, 0.1])
    w8_scoring: bool = False
    w8a8_scoring: bool = False
    # LA19-eval crop start: None keeps the reference's always-random start
    la19_eval_random_start: Optional[bool] = None
    optimizer: str = "adamw"
    adam_mu_dtype: Optional[str] = None

    @property
    def train_duration_samples(self) -> int:
        return int(self.train_duration_sec * self.sample_rate)

    @property
    def test_duration_samples(self) -> int:
        return int(self.test_duration_sec * self.sample_rate)

    @classmethod
    def from_dict(cls, cfg: Dict[str, Any]) -> "ExpConfig":
        return _from_dict(cls, cfg)


def _from_dict(cls, cfg: Dict[str, Any]):
    """Build a dataclass from a dict, warning about unknown keys."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(cfg) - names)
    if unknown:
        warnings.warn(f"{cls.__name__}: ignoring unknown config keys {unknown}")
    return cls(**{k: v for k, v in cfg.items() if k in names})


def _parse(text: str, path: str) -> Dict[str, Any]:
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text) if text.strip() else {}
        except json.JSONDecodeError as e:
            raise ValueError(
                f"{path}: PyYAML is not installed and the file is not JSON "
                f"({e}); write the config in JSON syntax or install PyYAML"
            ) from None
    return yaml.safe_load(text) or {}


def load_yaml_config(path: str) -> tuple[SysConfig, ExpConfig]:
    """Load a reference-format config (top-level SysConfig / ExpConfig)."""
    with open(path, "r") as f:
        raw = _parse(f.read(), path)
    sys_cfg = SysConfig.from_dict(raw.get("SysConfig", {}) or {})
    exp_cfg = ExpConfig.from_dict(raw.get("ExpConfig", {}) or {})
    return sys_cfg, exp_cfg

"""The port's scoring CLI against the JAX package's, end to end on the CPU.

A synthetic LA21 track (sine clips for bonafide, noise for spoof, WAV bytes
under ``.flac`` names) is scored from one reference-format ``.pt``, exported
from a tiny JAX model, by ``python -m rtdsd_tpu.cli.main`` (a subprocess,
as tests/test_cli_smoke.py runs it) and by
``rtdsd_tpu_torch.cli.main --device cpu``. The two score files must list the
same ids in the same order, in the same ``"{utt_id} {score}"`` format, with
scores within the float32 tolerance of the model tests.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_track import N_CLIPS, make_track
from rtdsd_tpu_torch.cli import main as port_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny CPU ops: a full torch thread pool per test worker only adds
    contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def track(tmp_path_factory):
    """Synthetic LA21 track, config, and a reference .pt of a tiny model."""
    return make_track(tmp_path_factory.mktemp("torch_cli"))


def _scores(path):
    lines = path.read_text().splitlines()
    for line in lines:      # "{utt_id} {repr of a python float}"
        assert re.fullmatch(r"LA_E_\d{4} -?\d+\.\d+(e-?\d+)?", line), line
    return [l.split(" ")[0] for l in lines], np.array(
        [float(l.split(" ")[1]) for l in lines])


def test_score_file_matches_jax_cli(track):
    root, cfg, pt = track
    args = ["--config", cfg, "--is_eval", "--is_score", "--ckpt", pt,
            "--tracks", "LA21"]
    r = subprocess.run([sys.executable, "-m", "rtdsd_tpu.cli.main", *args,
                        "--comment", "jax"], cwd=REPO, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    port_main.main(args + ["--comment", "port", "--device", "cpu"])

    ids_j, s_j = _scores(root / "scores_la21_jax.txt")
    ids_p, s_p = _scores(root / "scores_la21_port.txt")
    assert ids_p == ids_j == [f"LA_E_{i:04d}" for i in range(N_CLIPS)]
    # whole tiny model in float32, as tests/test_torch_models.py holds it
    np.testing.assert_allclose(s_p, s_j, rtol=1e-4, atol=1e-4)

    # a second run finds the file and skips it, as the JAX CLI does
    before = (root / "scores_la21_port.txt").stat().st_mtime_ns
    port_main.main(args + ["--comment", "port", "--device", "cpu"])
    assert (root / "scores_la21_port.txt").stat().st_mtime_ns == before


def test_cli_probes(track):
    root, cfg, pt = track
    base = ["--config", cfg, "--is_eval", "--is_score", "--device", "cpu"]
    with pytest.raises(ValueError, match="ckpt is None"):
        port_main.main(base + ["--tracks", "LA21"])
    with pytest.raises(ValueError, match="Invalid track"):
        port_main.main(base + ["--ckpt", pt, "--tracks", "BOGUS"])
    # the JAX package's orbax checkpoint directories need orbax: the CLI
    # names the route that works
    orbax = root / "orbax_ckpt"
    (orbax / "orbax").mkdir(parents=True, exist_ok=True)
    with pytest.raises(NotImplementedError, match="export_reference_model"):
        port_main.main(base + ["--ckpt", str(orbax), "--tracks", "LA21"])


def test_cli_without_device_needs_a_gpu(track):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present, so the default device resolves")
    root, cfg, pt = track
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main.main(["--config", cfg, "--is_eval", "--is_score",
                        "--ckpt", pt, "--tracks", "LA21", "--comment", "nodev"])
    assert not (root / "scores_la21_nodev.txt").exists()


# ----------------------------------------------- config and data copies

def test_config_loads_json_without_pyyaml(tmp_path, monkeypatch):
    from rtdsd_tpu_torch.config import load_yaml_config

    (tmp_path / "c.json").write_text(
        '{"SysConfig": {"model": "XLSR_AASIST"}, '
        '"ExpConfig": {"batch_size_test": 16, "kwargs": {"fused_gat": true}}}')
    (tmp_path / "c.yaml").write_text("ExpConfig:\n  batch_size_test: 16\n")
    monkeypatch.setitem(sys.modules, "yaml", None)     # import yaml fails
    sys_cfg, exp_cfg = load_yaml_config(str(tmp_path / "c.json"))
    assert exp_cfg.batch_size_test == 16 and exp_cfg.kwargs["fused_gat"]
    assert exp_cfg.test_duration_samples == 64000   # defaults kept
    with pytest.raises(ValueError, match="PyYAML is not installed"):
        load_yaml_config(str(tmp_path / "c.yaml"))


@pytest.mark.parametrize("random_start", [None, False])
def test_la19_eval_crops_match_jax(track, random_start):
    """The port's copies of the protocol parser, WAV decoder and duration
    fit give the JAX package's trials and crops, including LA19-eval's
    always-random start (same numpy generator, same draws)."""
    from rtdsd_tpu.config import load_yaml_config as jax_cfg
    from rtdsd_tpu.data.dataset import ASVspoof2019LA_eval as JaxLA19
    from rtdsd_tpu_torch.config import load_yaml_config
    from rtdsd_tpu_torch.data.dataset import ASVspoof2019LA_eval

    root, cfg, _ = track
    text = open(cfg).read().replace("2021_la_eval", "2019_la_eval")
    text = text.replace("compute_dtype: float32", "compute_dtype: float32\n"
                        f"  la19_eval_random_start: "
                        f"{'null' if random_start is None else 'false'}")
    path = root / f"cfg_la19_{random_start}.yaml"
    path.write_text(text)
    mine, ref = (cls(*load(str(path))) for cls, load in
                 ((ASVspoof2019LA_eval, load_yaml_config), (JaxLA19, jax_cfg)))
    assert mine.is_random_start == ref.is_random_start == (random_start is None)
    assert [t.utt_id for t in mine.trials] == [t.utt_id for t in ref.trials]
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(len(mine)):
        a, b = mine.get(i, r1), ref.get(i, r2)
        assert a[0] == b[0] and a[2] == b[2]
        np.testing.assert_array_equal(a[1], b[1])

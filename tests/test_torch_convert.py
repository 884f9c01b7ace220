"""SSL initialisation, weight conversion and the JAX package's checkpoint
directories in the port, against the JAX package, on the CPU.

A tiny fairseq-format XLS-R checkpoint (width 32, 24 layers, a
weight-normed positional conv, pre-training heads) is converted by the JAX
CLI into the pytree directory the shipped configs name in
``ssl_pytree_path``. Held bit for bit: ``init_state`` from that directory
against the JAX ``init_state`` for ``XLSR_AASIST`` and for a pruned
``My_XLSR_AASIST`` with a custom order; an HF snapshot (written with
``safetensors`` and with ``torch.save``) against JAX's
``load_ssl_params``; ``rtdsd_tpu_torch.cli.convert`` in its three modes
against the JAX CLI's files; ``to_jax_variables`` round trips. Scores from
a JAX ``state.msgpack`` directory through the port's CLI within 1e-4 of
the JAX CLI's (tests/test_torch_cli.py's float32 CLI tolerance). Raises:
the shape mismatch report, an HF config that disagrees on shape-invisible
fields, orbax directories. A tiny copy of ``configs/xlsr_aasist.yaml`` trains an epoch
from the pytree directory.
"""

import json

import jax
import numpy as np
import pytest
import torch
from flax import serialization as ser

from rtdsd_tpu_torch.cli import common
from rtdsd_tpu_torch.cli import convert as port_convert
from rtdsd_tpu_torch.cli import main as port_main
from rtdsd_tpu_torch.config import load_yaml_config
from rtdsd_tpu_torch.models import convert, convert_fairseq, registry, zoo
from test_torch_msgpack import assert_same_tree

W2V = {"encoder_embed_dim": 32, "encoder_ffn_dim": 64, "encoder_heads": 4,
       "conv_pos": 16, "conv_pos_groups": 4,
       "conv_layers": [[32, 10, 5], [32, 3, 2], [32, 2, 2], [32, 2, 2]]}
HEADS = {"mask_emb": (32,), "quantizer.vars": (1, 8, 4),
         "quantizer.weight_proj.weight": (8, 32), "project_q.weight": (4, 4),
         "final_proj.weight": (4, 32)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fairseq_sd(seed=5):
    """A fairseq-named 24-layer encoder state dict with its weight-normed
    positional conv and pre-training heads."""
    model = registry.get_model("XLSR_AASIST", w2v=W2V).module
    zoo.init_weights(model, seed)
    pre = "ssl_model.model."
    sd = {k[len(pre):]: v for k, v in model.state_dict().items()
          if k.startswith(pre)}
    w = sd.pop("encoder.pos_conv.0.weight")
    sd["encoder.pos_conv.0.weight_g"] = w.pow(2).sum(
        dim=(0, 1), keepdim=True).sqrt() * 1.5
    sd["encoder.pos_conv.0.weight_v"] = w
    g = torch.Generator().manual_seed(seed)
    sd.update({k: torch.randn(s, generator=g) for k, s in HEADS.items()})
    return sd


@pytest.fixture(scope="module")
def ssl(tmp_path_factory):
    """(root, fairseq .pt, the JAX CLI's pytree directory)."""
    from rtdsd_tpu.cli import convert as jax_convert

    root = tmp_path_factory.mktemp("torch_convert")
    pt = str(root / "xlsr_fairseq.pt")
    torch.save({"model": _fairseq_sd(), "cfg": {"model": {}}}, pt)
    jax_convert.main(["--fairseq", pt, "--out", str(root / "xlsr_jax")])
    return root, pt, str(root / "xlsr_jax")


def zeros_state(m, rng, x, tx):
    """The JAX package's ``create_train_state`` with zeros for the random
    init, on ``jax.eval_shape``'s shapes (nothing compiled)."""
    from rtdsd_tpu.engine.steps import TrainState

    v = jax.eval_shape(lambda r, a: m.init(r, a, train=False), rng, x)
    v = jax.tree_util.tree_map(lambda a: jax.numpy.zeros(a.shape, a.dtype), v)
    return TrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                      params=v["params"], batch_stats=v["batch_stats"],
                      opt_state=tx.init(v["params"]))


def _configs(root, model, kwargs, pytree):
    cfg = {"SysConfig": {"model": model, "ssl_pytree_path": pytree},
           "ExpConfig": {"train_duration_sec": 0.5, "compute_dtype": "float32",
                         "kwargs": kwargs}}
    path = root / f"{model}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("model,kwargs", [
    ("XLSR_AASIST", {"w2v": W2V}),
    ("My_XLSR_AASIST", {"w2v": W2V, "num_layers": 3, "order": "custom",
                        "custom_order": [23, 0, 11]})],
    ids=["XLSR_AASIST", "My_XLSR_AASIST_custom"])
def test_init_state_from_pytree_matches_jax(ssl, model, kwargs,
                                            monkeypatch):
    """The JAX ``init_state`` from the pytree directory, its model's
    random init made zeros on ``jax.eval_shape``'s shapes (the checkpoint
    replaces it in the encoder, the part held; an op-by-op init of the
    24-layer model takes half a minute on the CPU)."""
    from rtdsd_tpu.cli import common as jax_common
    from rtdsd_tpu.config import load_yaml_config as jax_load

    root, _, pytree = ssl
    path = _configs(root, model, kwargs, pytree)
    jsys, jexp = jax_load(path)
    jspec = jax_common.build_model(jsys, jexp)
    monkeypatch.setattr(jax_common, "create_train_state", zeros_state)
    want = jax_common.init_state(jspec, jsys, jexp, jax.random.key(0))
    want = convert.from_jax_ssl_params(
        jax.tree_util.tree_map(np.asarray, want.params["ssl_model"]))
    sysc, exp = load_yaml_config(path)
    spec = common.build_model(sysc, exp, torch.device("cpu"), train=True)
    state = common.init_state(spec, sysc, exp, seed=0)
    got = state.model.ssl_model.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert len(spec.module.ssl_model.model.encoder.layers) == \
        len(spec.layer_indices)


# ---------------------------------------------------------------- HF

def _hf_names(fs_sd):
    """fairseq -> HF ``transformers`` spelling (the inverse of the
    converter's renames), under ``wav2vec2.``, plus two HF head keys."""
    rules = [(r"^feature_extractor\.conv_layers\.(\d+)\.0\.",
              r"feature_extractor.conv_layers.\1.conv."),
             (r"^feature_extractor\.conv_layers\.(\d+)\.2\.1\.",
              r"feature_extractor.conv_layers.\1.layer_norm."),
             (r"^layer_norm\.", "feature_projection.layer_norm."),
             (r"^post_extract_proj\.", "feature_projection.projection."),
             (r"^encoder\.pos_conv\.0\.", "encoder.pos_conv_embed.conv."),
             (r"self_attn\.(q|k|v|out)_proj", r"attention.\1_proj"),
             (r"\.self_attn_layer_norm\.", ".layer_norm."),
             (r"\.fc1\.", ".feed_forward.intermediate_dense."),
             (r"\.fc2\.", ".feed_forward.output_dense.")]
    import re

    out = {}
    for k, v in fs_sd.items():
        if k in HEADS:
            continue
        for pat, repl in rules:
            k = re.sub(pat, repl, k)
        out["wav2vec2." + k] = v.clone()
    g = torch.Generator().manual_seed(1)
    out["quantizer.codevectors"] = torch.randn(1, 8, 4, generator=g)
    out["project_hid.weight"] = torch.randn(4, 32, generator=g)
    return out


def _hf_config(layers=24, heads=4):
    return {"conv_dim": [32] * 4, "conv_kernel": [10, 3, 2, 2],
            "conv_stride": [5, 2, 2, 2], "hidden_size": 32,
            "intermediate_size": 64, "num_attention_heads": heads,
            "num_hidden_layers": layers, "num_conv_pos_embeddings": 16,
            "num_conv_pos_embedding_groups": 4, "do_stable_layer_norm": True,
            "feat_extract_norm": "layer", "conv_bias": True}


@pytest.fixture(scope="module")
def hf_dirs(ssl):
    """Two HF snapshots of the fixture's encoder: model.safetensors and
    pytorch_model.bin."""
    from safetensors.torch import save_file

    root = ssl[0]
    hf = _hf_names(_fairseq_sd())
    dirs = {}
    for kind in ("safetensors", "bin"):
        d = root / f"hf_{kind}"
        d.mkdir()
        (d / "config.json").write_text(json.dumps(_hf_config()))
        if kind == "safetensors":
            save_file({k: v.contiguous() for k, v in hf.items()},
                      str(d / "model.safetensors"))
        else:
            torch.save(hf, str(d / "pytorch_model.bin"))
        dirs[kind] = str(d)
    return dirs


@pytest.mark.parametrize("kind", ["safetensors", "bin"])
def test_hf_snapshot_matches_jax(hf_dirs, ssl, kind):
    from rtdsd_tpu.cli.common import load_ssl_params

    path = hf_dirs[kind]
    cfg = registry.get_model("XLSR_AASIST", w2v=W2V).module.w2v_cfg
    got = common.load_ssl_state_dict(path, cfg)
    want = convert.from_jax_ssl_params(load_ssl_params(path))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k
    # the same weights as the fairseq checkpoint they were renamed from
    fs = convert_fairseq.encoder_state_dict(ssl[1])
    assert all(torch.equal(got[k], fs[k]) for k in fs)


def test_hf_config_checks(hf_dirs, tmp_path):
    from rtdsd_tpu.models.convert_hf import w2v_config_from_hf as jax_cfg
    from rtdsd_tpu_torch.models.convert_hf import w2v_config_from_hf

    cfg = registry.get_model("XLSR_AASIST",
                             w2v={**W2V, "encoder_heads": 2}).module.w2v_cfg
    with pytest.raises(ValueError, match="(?s)shape-invisible.*encoder_heads"):
        common.load_ssl_state_dict(hf_dirs["safetensors"], cfg)
    for fn in (w2v_config_from_hf, jax_cfg):
        with pytest.raises(ValueError, match="post-LN"):
            fn({**_hf_config(), "do_stable_layer_norm": False})
    a, b = w2v_config_from_hf(_hf_config()), jax_cfg(_hf_config())
    for f in ("conv_layers", "extractor_mode", "conv_bias", "encoder_layers",
              "encoder_embed_dim", "encoder_heads", "layer_norm_first"):
        assert getattr(a, f) == getattr(b, f), f
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        (tmp_path / "config.json").write_text("{}")
        from rtdsd_tpu_torch.models.convert_hf import load_hf_dir
        load_hf_dir(str(tmp_path))


# ------------------------------------------------------------ convert CLI

@pytest.mark.parametrize("mode", ["fairseq", "hf", "reference"])
def test_convert_cli_matches_jax(ssl, hf_dirs, tmp_path, mode):
    """The port's file read by flax gives the JAX CLI's tree, every leaf
    bit for bit and of the same dtype."""
    from rtdsd_tpu.cli import convert as jax_convert

    _, pt, _ = ssl
    if mode == "reference":
        from _torch_track import make_conformer, write_track

        write_track(tmp_path)
        _, src = make_conformer(tmp_path)
        args = ["--reference", src, "--model", "My_XLSR_Conformer"]
    else:
        args = [f"--{mode}", pt if mode == "fairseq" else hf_dirs["bin"]]
    for side, main in (("port", port_convert.main), ("jax", jax_convert.main)):
        main(args + ["--out", str(tmp_path / side)])
    got, want = ((tmp_path / s / "weights.msgpack").read_bytes()
                 for s in ("port", "jax"))
    assert_same_tree(ser.msgpack_restore(got), ser.msgpack_restore(want))


@pytest.mark.parametrize("name", ["My_XLSR_AASIST", "My_XLSR_Conformer"])
def test_to_jax_variables_round_trip(name):
    """``to_jax_variables`` -> ``from_jax_variables`` is the identity, bit
    for bit, and its layout is the JAX converter's."""
    from rtdsd_tpu.models.convert_fairseq import convert_reference_model
    from rtdsd_tpu.models.registry import get_model as jax_get
    from _torch_track import random_variables

    kw = {"num_layers": 2, "w2v": W2V}
    if "Conformer" in name:
        kw.update(emb_size=16, heads=4, kernel_size=16, n_encoders=4)
    v = random_variables(jax_get(name, **kw).module,
                         np.zeros((2, 8000), np.float32), train=False)
    sd = convert.from_jax_variables(v, name)
    tree = convert.to_jax_variables(sd, name)
    assert_same_tree(tree, v)
    back = convert.from_jax_variables(tree, name)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    want = convert_reference_model({k: t.numpy() for k, t in sd.items()},
                                   name)
    assert_same_tree(tree, want)


def test_weight_norm_fold_matches_jax_bit_for_bit(ssl):
    """The positional conv's W = g v / ||v|| in JAX's float32 numpy order
    (a torch reduction sums in another order)."""
    from rtdsd_tpu.models.convert_fairseq import (convert_w2v_checkpoint,
                                                  load_torch_state_dict)

    _, pt, _ = ssl
    got = convert_fairseq.encoder_state_dict(pt)["encoder.pos_conv.0.weight"]
    want = convert.from_jax_ssl_params(convert_w2v_checkpoint(
        load_torch_state_dict(pt)))["encoder.pos_conv.0.weight"]
    assert torch.equal(got, want)


# ------------------------------------------------------------ raises

def test_ssl_shape_mismatch_is_reported(ssl, tmp_path):
    root, _, pytree = ssl
    sysc, exp = load_yaml_config(_configs(
        tmp_path, "My_XLSR_AASIST",
        {"num_layers": 2, "w2v": {**W2V, "encoder_ffn_dim": 48}}, pytree))
    spec = common.build_model(sysc, exp, torch.device("cpu"), train=True)
    with pytest.raises(ValueError) as e:
        common.init_state(spec, sysc, exp, seed=0)
    msg = str(e.value)
    assert "does not match the model's w2v config (6 mismatched leaves)" in msg
    assert "encoder.layers.0.fc1.weight: checkpoint (64, 32) vs model " \
        "(48, 32)" in msg
    # a 3-layer checkpoint cannot give layer 5
    from _torch_track import write_ssl_pytree

    sysc.ssl_pytree_path = write_ssl_pytree(tmp_path, W2V, layers=3)[1]
    exp.kwargs = {"num_layers": 2, "order": "custom", "custom_order": [0, 5],
                  "w2v": W2V}
    spec = common.build_model(sysc, exp, torch.device("cpu"), train=True)
    with pytest.raises(ValueError, match=r"layer indices \[5\] out of range"):
        common.init_state(spec, sysc, exp, seed=0)


def test_jax_checkpoint_directory_raises(ssl, tmp_path):
    spec = registry.get_model("My_XLSR_AASIST", num_layers=2, w2v=W2V)
    for sub in ("orbax", "orbax.prev"):
        d = tmp_path / f"ck_{sub}"
        (d / sub).mkdir(parents=True)
        with pytest.raises(NotImplementedError,
                           match="export_reference_model"):
            common.load_checkpoint_for_eval(str(d), spec)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="state.msgpack"):
        common.load_checkpoint_for_eval(str(tmp_path / "empty"), spec)
    with pytest.raises(ValueError, match="no batch_stats"):
        common.load_checkpoint_for_eval(ssl[2], spec)      # an SSL pytree


# ------------------------------------------------------ JAX directories

@pytest.fixture(scope="module")
def jax_state_dirs(tmp_path_factory):
    """A tiny Conformer's JAX train state (the JAX CLI's ``init_state``,
    its random init zeros, then seeded weights) saved as ``state.msgpack``
    and as ``weights.msgpack``, with the LA21 track; -> (root, config,
    state dir, weights dir, the weights)."""
    from rtdsd_tpu.cli import common as jax_common
    from rtdsd_tpu.config import load_yaml_config as jax_load
    from rtdsd_tpu.engine import checkpoint as jax_ckpt
    from _torch_track import make_conformer, random_variables, write_track

    root = tmp_path_factory.mktemp("jax_dirs")
    write_track(root)
    cfg, _ = make_conformer(root)
    sysc, exp = jax_load(cfg)
    spec = jax_common.build_model(sysc, exp, train=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common, "create_train_state", zeros_state)
        state = jax_common.init_state(spec, sysc, exp, jax.random.key(0))
    v = random_variables(spec.module, np.zeros((2, 8000), np.float32),
                         seed=11, train=False)
    state = state.replace(params=jax.tree_util.tree_map(jax.numpy.asarray,
                                                        v["params"]),
                          batch_stats=v["batch_stats"])
    jax_ckpt.save_checkpoint(str(root / "state_dir"), state, {"epoch": 0})
    jax_ckpt.save_params_only(str(root / "weights_dir"), v["params"],
                              v["batch_stats"])
    return root, cfg, str(root / "state_dir"), str(root / "weights_dir"), v


def test_scores_from_jax_state_dir_match_jax_cli(jax_state_dirs, monkeypatch):
    """The JAX CLI restores the whole state over its init (made zeros here,
    as in the fixture)."""
    from rtdsd_tpu.cli import common as jax_common
    from rtdsd_tpu.cli import main as jax_main

    root, cfg, state_dir, weights_dir, v = jax_state_dirs
    monkeypatch.setattr(jax_common, "create_train_state", zeros_state)
    scores = {}
    for side, main, extra in (("jax", jax_main.main, []),
                              ("port", port_main.main, ["--device", "cpu"])):
        main(["--config", cfg, "--is_eval", "--is_score", "--ckpt", state_dir,
              "--tracks", "LA21", "--comment", side] + extra)
        lines = (root / f"scores_la21_{side}.txt").read_text().splitlines()
        scores[side] = {l.split()[0]: float(l.split()[1]) for l in lines}
    assert scores["port"].keys() == scores["jax"].keys() and scores["port"]
    for u, s in scores["jax"].items():
        assert abs(scores["port"][u] - s) <= 1e-4, u
    # the weights-only directory loads the same model
    spec = registry.get_model("My_XLSR_Conformer",
                              **load_yaml_config(cfg)[1].kwargs)
    common.load_checkpoint_for_eval(weights_dir, spec)
    want = convert.from_jax_variables(v, "My_XLSR_Conformer")
    got = spec.module.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------ CLI

def test_cli_trains_aasist_from_ssl_pytree(ssl, tmp_path):
    """configs/xlsr_aasist.yaml's recipe (bf16, RawBoost4) at a tiny size,
    the encoder from the JAX CLI's pytree directory: an epoch, then
    scoring from ``last/``."""
    from _torch_track import run_cli_epochs, tiny_shipped_config

    _, _, pytree = ssl
    cfg = tiny_shipped_config(tmp_path, "xlsr_aasist.yaml", "My_XLSR_AASIST",
                              {"num_layers": 2, "order": "custom",
                               "custom_order": [5, 17], "w2v": W2V},
                              pytree, np.random.default_rng(9))
    run_cli_epochs(tmp_path, cfg, epochs=1)

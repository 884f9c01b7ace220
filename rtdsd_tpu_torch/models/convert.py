"""Weights into and out of the port's modules.

- :func:`from_jax_variables`: the JAX package's ``{'params',
  'batch_stats'}`` tree (as numpy arrays) -> the port's state dict. The
  port's own copy of the layout rules of
  ``rtdsd_tpu/models/export_reference.py``: Dense (I, O) -> Linear (O, I);
  Conv (K, I/g, O) -> Conv1d (O, I/g, K); Conv (Kh, Kw, I, O) -> Conv2d
  (O, I, Kh, Kw); scale/bias (+ mean/var) -> weight/bias (+ running stats).
  A quantized tree (``rtdsd_tpu.models.quantize.quantize_variables``: the
  transformer matmuls hold int8 ``vals`` (L, in, out) and ``scales`` (L, 1,
  out) in place of ``kernel``) gives ``vals``/``scales``/``bias`` in the
  same layout, the buffers of ``W8Linear`` and ``W8A8Linear``. A Conformer
  head's Dense layers that the reference holds as 1x1 convs (the conv
  module's pointwise layers) become Conv1d (O, I, 1).
- :func:`load_reference_state_dict`: a reference ``.pt`` (or a state dict)
  -> the port's state dict. It folds fairseq's weight-normed positional conv
  (``weight_g``/``weight_v``, or the ``parametrizations`` spelling) into one
  weight, strips a ``module.`` prefix, and drops keys the eval graph has no
  use for: the reference's dead ``encoder.{i}.0.bn1.*`` and fairseq's
  pretraining-only ``mask_emb``, ``quantizer.*``, ``project_q.*``,
  ``final_proj.*``. The result loads with ``strict=True``.
- :func:`to_jax_variables` and :func:`to_jax_ssl_params`: the inverse of
  :func:`from_jax_variables`, the port's state dict -> the JAX package's
  ``{'params', 'batch_stats'}`` tree, or the encoder's ``params`` tree
  alone, as numpy float32 arrays (int8 ``vals`` of a quantized model):
  the layout ``rtdsd_tpu/models/convert_fairseq.py::convert_reference_model``
  and ``convert_w2v_checkpoint`` produce (the transformer layers stacked on
  a leading axis).

A JAX model built with ``remat_save_every`` = m >= 2 keeps its layers in
the mixed layout of ``convert_fairseq.py::to_mixed_remat``: the first layer
of each chunk of m under ``layers/layer_save`` (axis L/m), the other m - 1
under ``layers/layers_r/layer`` (axes L/m, m - 1). The readers take either
layout; the writers give the mixed one with ``remat_save_every=m``. The
port's state dict keeps ``encoder.layers.{i}`` in both cases.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

_DEAD = re.compile(r"(^|\.)encoder\.\d+\.0\.bn1\.")
_PRETRAIN_ONLY = re.compile(
    r"^ssl_model\.model\.(mask_emb$|quantizer\.|project_q\.|final_proj\.)")
_POS = "ssl_model.model.encoder.pos_conv.0"


def _t(x) -> torch.Tensor:
    """A float32 copy of a numpy or tensor leaf."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32, copy=True)
    return torch.from_numpy(np.array(x, np.float32))


def _lin(out: StateDict, name: str, p: Mapping):
    if "vals" in p:                             # int8 W8Dense / W8A8Dense
        out[f"{name}.vals"] = torch.from_numpy(np.array(p["vals"], np.int8))
        out[f"{name}.scales"] = _t(p["scales"])
    else:
        out[f"{name}.weight"] = _t(p["kernel"]).t().contiguous()
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _conv1d(out: StateDict, name: str, p: Mapping):
    out[f"{name}.weight"] = _t(p["kernel"]).permute(2, 1, 0).contiguous()
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _conv2d(out: StateDict, name: str, p: Mapping):
    out[f"{name}.weight"] = _t(p["kernel"]).permute(3, 2, 0, 1).contiguous()
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _norm(out: StateDict, name: str, p: Mapping, stats: Mapping = None):
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])
    if stats is not None:
        out[f"{name}.running_mean"] = _t(stats["mean"])
        out[f"{name}.running_var"] = _t(stats["var"])
        out[f"{name}.num_batches_tracked"] = torch.tensor(0)


def from_jax_ssl_params(params: Mapping) -> StateDict:
    """The JAX encoder's ``params`` tree (the ``ssl_model`` subtree, or what
    ``save_ssl_params`` writes) -> a ``Wav2Vec2Encoder``'s state dict."""
    return _w2v(params, "")


def _w2v(params: Mapping, P: str) -> StateDict:
    out: StateDict = {}
    fe = params["feature_extractor"]
    for i in range(len([k for k in fe if k.startswith("conv_")])):
        _conv1d(out, f"{P}feature_extractor.conv_layers.{i}.0", fe[f"conv_{i}"])
        if f"ln_{i}" in fe:
            _norm(out, f"{P}feature_extractor.conv_layers.{i}.2.1", fe[f"ln_{i}"])
    if "gn_0" in fe:
        _norm(out, f"{P}feature_extractor.conv_layers.0.2", fe["gn_0"])
    _norm(out, f"{P}layer_norm", params["layer_norm_pre"])
    _lin(out, f"{P}post_extract_proj", params["post_extract_proj"])
    _conv1d(out, f"{P}encoder.pos_conv.0", params["pos_conv"]["conv"])
    _norm(out, f"{P}encoder.layer_norm", params["encoder_layer_norm"])
    stacked = standard_layers(params["layers"])
    names = {"self_attn_layer_norm": "self_attn_layer_norm",
             "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
             "final_layer_norm": "final_layer_norm", "fc1": "fc1", "fc2": "fc2"}
    for i in range(len(stacked["fc1"]["bias"])):
        for jax_name, torch_name in names.items():
            sub = {k: np.asarray(v)[i] for k, v in stacked[jax_name].items()}
            fn = _norm if "norm" in jax_name else _lin
            fn(out, f"{P}encoder.layers.{i}.{torch_name}", sub)
    return out


def _tree_map(fn, *trees):
    if isinstance(trees[0], Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def standard_layers(layers: Mapping) -> Mapping:
    """The JAX encoder's ``layers`` subtree -> its ``layer`` stack (L, ...):
    as it is in the standard layout, interleaved from the mixed one
    (``convert_fairseq.py::from_mixed_remat``)."""
    if "layer_save" not in layers:
        return layers["layer"]

    def join(save, rest):
        save, rest = np.asarray(save), np.asarray(rest)
        merged = np.concatenate([save[:, None], rest], axis=1)
        return merged.reshape((-1,) + merged.shape[2:])

    return _tree_map(join, layers["layer_save"], layers["layers_r"]["layer"])


def mixed_layers(stacked: Mapping, m: int) -> dict:
    """A ``layer`` stack (L, ...) -> the mixed layout's ``layers`` subtree
    for ``remat_save_every`` = m (``convert_fairseq.py::to_mixed_remat``)."""
    def split(leaf):
        if leaf.shape[0] % m:
            raise ValueError(f"stacked depth {leaf.shape[0]} not divisible "
                             f"by m={m}")
        return leaf.reshape((leaf.shape[0] // m, m) + leaf.shape[1:])

    return {"layer_save": _tree_map(lambda a: split(a)[:, 0], stacked),
            "layers_r": {"layer": _tree_map(lambda a: split(a)[:, 1:],
                                            stacked)}}


def _aasist(params: Mapping, stats: Mapping) -> StateDict:
    out: StateDict = {}
    _lin(out, "LL", params["LL"])
    _norm(out, "first_bn", params["first_bn"], stats["first_bn"])
    _norm(out, "first_bn1", params["first_bn1"], stats["first_bn1"])
    for i in range(6):
        blk, bs = params[f"encoder_{i}"], stats[f"encoder_{i}"]
        base = f"encoder.{i}.0"
        _conv2d(out, f"{base}.conv1", blk["conv1"])
        _norm(out, f"{base}.bn2", blk["bn2"], bs["bn2"])
        _conv2d(out, f"{base}.conv2", blk["conv2"])
        if "conv_downsample" in blk:
            _conv2d(out, f"{base}.conv_downsample", blk["conv_downsample"])
    _conv2d(out, "attention.0", params["att_conv1"])
    _norm(out, "attention.2", params["att_bn"], stats["att_bn"])
    _conv2d(out, "attention.3", params["att_conv2"])
    for name in ("pos_S", "master1", "master2"):
        out[name] = _t(params[name])
    for name in ("GAT_layer_S", "GAT_layer_T"):
        p = params[name]
        for ln in ("att_proj", "proj_with_att", "proj_without_att"):
            _lin(out, f"{name}.{ln}", p[ln])
        out[f"{name}.att_weight"] = _t(p["att_weight"])
        _norm(out, f"{name}.bn", p["bn"], stats[name]["bn"])
    for name in ("HtrgGAT_layer_ST11", "HtrgGAT_layer_ST12",
                 "HtrgGAT_layer_ST21", "HtrgGAT_layer_ST22"):
        p = params[name]
        for ln in ("proj_type1", "proj_type2", "att_proj", "att_projM",
                   "proj_with_att", "proj_without_att", "proj_with_attM",
                   "proj_without_attM"):
            _lin(out, f"{name}.{ln}", p[ln])
        for w in ("att_weight11", "att_weight22", "att_weight12", "att_weightM"):
            out[f"{name}.{w}"] = _t(p[w])
        _norm(out, f"{name}.bn", p["bn"], stats[name]["bn"])
    for name in ("pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2",
                 "pool_hT2"):
        _lin(out, f"{name}.proj", params[name]["proj"])
    _lin(out, "out_layer", params["out_layer"])
    return out


def _conv1x1(out: StateDict, name: str, p: Mapping):
    """Dense (I, O) -> Conv1d (O, I, 1)."""
    out[f"{name}.weight"] = _t(p["kernel"]).t().contiguous()[..., None]
    out[f"{name}.bias"] = _t(p["bias"])


def conformer_block(out: StateDict, bp: str, blk: Mapping, stats: Mapping
                    ) -> None:
    """One ``ConformerBlock``'s params and BatchNorm stats -> the
    reference's lucidrains names under ``bp``."""
    for ff in ("ff1", "ff2"):
        _norm(out, f"{bp}.{ff}.fn.norm", blk[f"{ff}_norm"])
        _lin(out, f"{bp}.{ff}.fn.fn.net.0", blk[ff]["fc1"])
        _lin(out, f"{bp}.{ff}.fn.fn.net.3", blk[ff]["fc2"])
    _norm(out, f"{bp}.attn.norm", blk["attn_norm"])
    for ln in ("to_q", "to_kv", "to_out"):
        _lin(out, f"{bp}.attn.fn.{ln}", blk["attn"][ln])
    out[f"{bp}.attn.fn.rel_pos_emb.weight"] = _t(
        blk["attn"]["rel_pos_emb"]["embedding"])
    conv = blk["conv"]
    _norm(out, f"{bp}.conv.net.0", conv["ln"])
    _conv1x1(out, f"{bp}.conv.net.2", conv["pw1"])
    _conv1d(out, f"{bp}.conv.net.4.conv", conv["dw"])
    _norm(out, f"{bp}.conv.net.5", conv["bn"], stats["conv"]["bn"])
    _conv1x1(out, f"{bp}.conv.net.7", conv["pw2"])
    _norm(out, f"{bp}.post_norm", blk["post_norm"])


def conformer_backend(params: Mapping, stats: Mapping) -> StateDict:
    """``ConformerBackend`` params and BatchNorm stats -> the reference's
    ``Model`` names."""
    out: StateDict = {}
    _lin(out, "LL", params["LL"])
    _norm(out, "first_bn", params["first_bn"], stats["first_bn"])
    conf = params["conformer"]
    out["conformer.class_token"] = _t(conf["class_token"])
    _lin(out, "conformer.fc5", conf["fc5"])
    for name in sorted((k for k in conf if k.startswith("block_")),
                       key=lambda k: int(k.split("_")[1])):
        conformer_block(out, f"conformer.encoder_blocks.{name.split('_')[1]}",
                        conf[name], stats["conformer"][name])
    return out


def from_jax_variables(variables: Mapping[str, Any], model_name: str
                       ) -> StateDict:
    """JAX ``{'params', 'batch_stats'}`` of a zoo model (numpy leaves) ->
    the port's state dict for the same model (``model_name`` containing
    ``AASIST`` or not tells the two back-ends apart, as the JAX export
    does)."""
    params = variables["params"]
    stats = variables["batch_stats"]["backend"]
    out = _w2v(params["ssl_model"], "ssl_model.model.")
    head = _aasist if "AASIST" in model_name else conformer_backend
    out.update(head(params["backend"], stats))
    return out


def _fold_weight_norm(sd: StateDict) -> None:
    """W = g * v / ||v||, the norm over dims (0, 1) (fairseq's dim=2),
    computed in float32 numpy exactly as the JAX package's converter
    computes it (a torch reduction sums in another order: up to 2e-7 apart
    at full width)."""
    for g_key, v_key in ((f"{_POS}.weight_g", f"{_POS}.weight_v"),
                         (f"{_POS}.parametrizations.weight.original0",
                          f"{_POS}.parametrizations.weight.original1")):
        if g_key in sd:
            g = sd.pop(g_key).detach().float().numpy()
            v = sd.pop(v_key).detach().float().numpy()
            norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
            sd[f"{_POS}.weight"] = torch.from_numpy(
                g * v / np.maximum(norm, 1e-12))


def load_reference_state_dict(path_or_dict: Union[str, Mapping]) -> StateDict:
    """A reference ``.pt`` path or state dict -> the port's state dict."""
    obj = path_or_dict
    if isinstance(obj, str):
        obj = torch.load(obj, map_location="cpu", weights_only=True)
    if isinstance(obj.get("model"), Mapping):
        obj = obj["model"]
    if isinstance(obj.get("state_dict"), Mapping):
        obj = obj["state_dict"]
    sd: StateDict = {}
    for k, v in obj.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if _DEAD.search(k) or _PRETRAIN_ONLY.search(k):
            continue
        sd[k] = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
    _fold_weight_norm(sd)
    return sd


# ------------------------------------------------- the port -> JAX trees

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy().copy()


def _lin_out(sd: Mapping, name: str) -> dict:
    if f"{name}.vals" in sd:                    # int8 W8Linear / W8A8Linear
        p = {"vals": sd[f"{name}.vals"].detach().cpu().numpy().copy(),
             "scales": _np(sd[f"{name}.scales"])}
    else:
        p = {"kernel": np.ascontiguousarray(_np(sd[f"{name}.weight"]).T)}
    if f"{name}.bias" in sd:
        p["bias"] = _np(sd[f"{name}.bias"])
    return p


def _conv_out(sd: Mapping, name: str, perm) -> dict:
    p = {"kernel": np.ascontiguousarray(
        np.transpose(_np(sd[f"{name}.weight"]), perm))}
    if f"{name}.bias" in sd:
        p["bias"] = _np(sd[f"{name}.bias"])
    return p


def _conv1d_out(sd: Mapping, name: str) -> dict:
    return _conv_out(sd, name, (2, 1, 0))


def _conv2d_out(sd: Mapping, name: str) -> dict:
    return _conv_out(sd, name, (2, 3, 1, 0))


def _conv1x1_out(sd: Mapping, name: str) -> dict:
    return {"kernel": np.ascontiguousarray(_np(sd[f"{name}.weight"])[..., 0].T),
            "bias": _np(sd[f"{name}.bias"])}


def _norm_out(sd: Mapping, name: str) -> dict:
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


def _stats_out(sd: Mapping, name: str) -> dict:
    return {"mean": _np(sd[f"{name}.running_mean"]),
            "var": _np(sd[f"{name}.running_var"])}


_LAYER_RE = re.compile(r"^encoder\.layers\.(\d+)\.")
_CONV_RE = re.compile(r"^feature_extractor\.conv_layers\.(\d+)\.0\.weight$")


def to_jax_ssl_params(sd: Mapping[str, torch.Tensor], prefix: str = "",
                      remat_save_every: int = 0) -> dict:
    """A ``Wav2Vec2Encoder``'s state dict (keys under ``prefix``) -> the JAX
    encoder's ``params`` tree, the inverse of :func:`from_jax_ssl_params`;
    in the mixed layout for ``remat_save_every`` >= 2."""
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    fe = {}
    n_conv = 1 + max(int(m.group(1)) for k in sd if (m := _CONV_RE.match(k)))
    for i in range(n_conv):
        fe[f"conv_{i}"] = _conv1d_out(sd, f"feature_extractor.conv_layers.{i}.0")
        if f"feature_extractor.conv_layers.{i}.2.1.weight" in sd:
            fe[f"ln_{i}"] = _norm_out(sd, f"feature_extractor.conv_layers.{i}.2.1")
    if "feature_extractor.conv_layers.0.2.weight" in sd:
        fe["gn_0"] = _norm_out(sd, "feature_extractor.conv_layers.0.2")
    names = {"self_attn_layer_norm": ("self_attn_layer_norm", _norm_out),
             "q_proj": ("self_attn.q_proj", _lin_out),
             "k_proj": ("self_attn.k_proj", _lin_out),
             "v_proj": ("self_attn.v_proj", _lin_out),
             "out_proj": ("self_attn.out_proj", _lin_out),
             "final_layer_norm": ("final_layer_norm", _norm_out),
             "fc1": ("fc1", _lin_out), "fc2": ("fc2", _lin_out)}
    n_layers = 1 + max(int(m.group(1)) for k in sd if (m := _LAYER_RE.match(k)))
    per_layer = [{jax: fn(sd, f"encoder.layers.{i}.{torch_name}")
                  for jax, (torch_name, fn) in names.items()}
                 for i in range(n_layers)]
    stacked = {jax: {leaf: np.stack([layer[jax][leaf] for layer in per_layer])
                     for leaf in per_layer[0][jax]} for jax in names}
    return {"feature_extractor": fe,
            "layer_norm_pre": _norm_out(sd, "layer_norm"),
            "post_extract_proj": _lin_out(sd, "post_extract_proj"),
            "pos_conv": {"conv": _conv1d_out(sd, "encoder.pos_conv.0")},
            "encoder_layer_norm": _norm_out(sd, "encoder.layer_norm"),
            "layers": (mixed_layers(stacked, remat_save_every)
                       if remat_save_every >= 2 else {"layer": stacked})}


def _aasist_out(sd: Mapping) -> tuple:
    params = {"LL": _lin_out(sd, "LL"), "first_bn": _norm_out(sd, "first_bn"),
              "first_bn1": _norm_out(sd, "first_bn1"),
              "att_conv1": _conv2d_out(sd, "attention.0"),
              "att_bn": _norm_out(sd, "attention.2"),
              "att_conv2": _conv2d_out(sd, "attention.3"),
              "out_layer": _lin_out(sd, "out_layer")}
    stats = {"first_bn": _stats_out(sd, "first_bn"),
             "first_bn1": _stats_out(sd, "first_bn1"),
             "att_bn": _stats_out(sd, "attention.2")}
    for i in range(6):
        base = f"encoder.{i}.0"
        blk = {"conv1": _conv2d_out(sd, f"{base}.conv1"),
               "bn2": _norm_out(sd, f"{base}.bn2"),
               "conv2": _conv2d_out(sd, f"{base}.conv2")}
        if f"{base}.conv_downsample.weight" in sd:
            blk["conv_downsample"] = _conv2d_out(sd, f"{base}.conv_downsample")
        params[f"encoder_{i}"] = blk
        stats[f"encoder_{i}"] = {"bn2": _stats_out(sd, f"{base}.bn2")}
    for name in ("pos_S", "master1", "master2"):
        params[name] = _np(sd[name])
    for name in ("GAT_layer_S", "GAT_layer_T"):
        params[name] = {ln: _lin_out(sd, f"{name}.{ln}") for ln in
                        ("att_proj", "proj_with_att", "proj_without_att")}
        params[name]["att_weight"] = _np(sd[f"{name}.att_weight"])
        params[name]["bn"] = _norm_out(sd, f"{name}.bn")
        stats[name] = {"bn": _stats_out(sd, f"{name}.bn")}
    for name in ("HtrgGAT_layer_ST11", "HtrgGAT_layer_ST12",
                 "HtrgGAT_layer_ST21", "HtrgGAT_layer_ST22"):
        params[name] = {ln: _lin_out(sd, f"{name}.{ln}") for ln in
                        ("proj_type1", "proj_type2", "att_proj", "att_projM",
                         "proj_with_att", "proj_without_att", "proj_with_attM",
                         "proj_without_attM")}
        for w in ("att_weight11", "att_weight22", "att_weight12", "att_weightM"):
            params[name][w] = _np(sd[f"{name}.{w}"])
        params[name]["bn"] = _norm_out(sd, f"{name}.bn")
        stats[name] = {"bn": _stats_out(sd, f"{name}.bn")}
    for name in ("pool_S", "pool_T", "pool_hS1", "pool_hT1", "pool_hS2",
                 "pool_hT2"):
        params[name] = {"proj": _lin_out(sd, f"{name}.proj")}
    return params, stats


def _conformer_out(sd: Mapping) -> tuple:
    conf = {"class_token": _np(sd["conformer.class_token"]),
            "fc5": _lin_out(sd, "conformer.fc5")}
    conf_stats = {}
    blocks = sorted({int(k.split(".")[2]) for k in sd
                     if k.startswith("conformer.encoder_blocks.")})
    for i in blocks:
        bp = f"conformer.encoder_blocks.{i}"
        blk = {"attn_norm": _norm_out(sd, f"{bp}.attn.norm"),
               "attn": {ln: _lin_out(sd, f"{bp}.attn.fn.{ln}")
                        for ln in ("to_q", "to_kv", "to_out")},
               "conv": {"ln": _norm_out(sd, f"{bp}.conv.net.0"),
                        "pw1": _conv1x1_out(sd, f"{bp}.conv.net.2"),
                        "dw": _conv1d_out(sd, f"{bp}.conv.net.4.conv"),
                        "bn": _norm_out(sd, f"{bp}.conv.net.5"),
                        "pw2": _conv1x1_out(sd, f"{bp}.conv.net.7")},
               "post_norm": _norm_out(sd, f"{bp}.post_norm")}
        blk["attn"]["rel_pos_emb"] = {
            "embedding": _np(sd[f"{bp}.attn.fn.rel_pos_emb.weight"])}
        for ff in ("ff1", "ff2"):
            blk[f"{ff}_norm"] = _norm_out(sd, f"{bp}.{ff}.fn.norm")
            blk[ff] = {"fc1": _lin_out(sd, f"{bp}.{ff}.fn.fn.net.0"),
                       "fc2": _lin_out(sd, f"{bp}.{ff}.fn.fn.net.3")}
        conf[f"block_{i}"] = blk
        conf_stats[f"block_{i}"] = {"conv": {"bn": _stats_out(sd, f"{bp}.conv.net.5")}}
    params = {"LL": _lin_out(sd, "LL"), "first_bn": _norm_out(sd, "first_bn"),
              "conformer": conf}
    return params, {"first_bn": _stats_out(sd, "first_bn"),
                    "conformer": conf_stats}


def to_jax_variables(state_dict: Mapping[str, torch.Tensor], model_name: str,
                     remat_save_every: int = 0) -> dict:
    """The port's state dict of a zoo model -> the JAX package's
    ``{'params', 'batch_stats'}`` (numpy float32 leaves, int8 ``vals`` of a
    quantized model), the inverse of :func:`from_jax_variables`
    (``num_batches_tracked`` has no JAX counterpart); the encoder's layers
    in the mixed layout for ``remat_save_every`` >= 2."""
    head = _aasist_out if "AASIST" in model_name else _conformer_out
    params, stats = head(state_dict)
    return {"params": {"ssl_model": to_jax_ssl_params(
                           state_dict, "ssl_model.model.", remat_save_every),
                       "backend": params},
            "batch_stats": {"backend": stats}}

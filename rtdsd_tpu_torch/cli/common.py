"""CLI plumbing: the port of ``rtdsd_tpu/cli/common.py`` (model and train
state construction, checkpoint loading, scoring). In a job of several
processes each scores its stripe of a dataset, the stripes are merged back
into dataset order on every process, and process 0 alone writes."""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch

from rtdsd_tpu_torch.config import ExpConfig, SysConfig
from rtdsd_tpu_torch.data.dataset import AudioDataset
from rtdsd_tpu_torch.data.loader import EvalLoader
from rtdsd_tpu_torch.engine import checkpoint
from rtdsd_tpu_torch.engine.steps import (TrainState, make_optimizer,
                                          make_score_step, reinit_params)
from rtdsd_tpu_torch.models.convert import (StateDict, from_jax_ssl_params,
                                            from_jax_variables,
                                            load_reference_state_dict)
from rtdsd_tpu_torch.models.convert_fairseq import encoder_state_dict
from rtdsd_tpu_torch.models.convert_hf import convert_hf_checkpoint, load_hf_dir
from rtdsd_tpu_torch.models.quantize import quantize_state_dict
from rtdsd_tpu_torch.models.registry import ModelSpec, get_model
from rtdsd_tpu_torch.models.wav2vec2 import select_layers
from rtdsd_tpu_torch.models.zoo import init_weights
from rtdsd_tpu_torch.parallel import distributed
from rtdsd_tpu_torch.parallel.mesh import ProcessMesh, make_mesh
from rtdsd_tpu_torch.utils import flax_msgpack
from rtdsd_tpu_torch.utils.spans import span

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def resolve_dtype(exp_config: ExpConfig) -> torch.dtype:
    return DTYPES[exp_config.compute_dtype]


def init_distributed(device: Optional[str]) -> bool:
    """Join torchrun's process group, if the job has one, before any device
    use: gloo for ``--device cpu``, else NCCL when CUDA is available."""
    cpu = device is not None and torch.device(device).type == "cpu"
    return distributed.maybe_initialize_distributed(
        backend="gloo" if cpu else None)


def setup_mesh(exp_config: ExpConfig) -> ProcessMesh:
    """The ("data", "model") mesh of ``mesh_data_axis`` x
    ``mesh_model_axis`` over the job's processes; settings the process
    count cannot hold raise."""
    return make_mesh(exp_config.mesh_data_axis, exp_config.mesh_model_axis)


def build_model(sys_config: SysConfig, exp_config: ExpConfig,
                device: torch.device, name: Optional[str] = None,
                kwargs: Optional[dict] = None, train: bool = False
                ) -> ModelSpec:
    """The configured model on ``device``, in eval mode, or with ``train``
    in train mode with its encoder layers rematerialised (as the JAX
    package builds a model to train)."""
    spec = get_model(name or sys_config.model, dtype=resolve_dtype(exp_config),
                     remat=train,
                     **(kwargs if kwargs is not None else exp_config.kwargs))
    spec.module.to(device).train(train)
    return spec


def init_state(spec: ModelSpec, sys_config: SysConfig, exp_config: ExpConfig,
               seed: int) -> TrainState:
    """Initialise ``spec.module`` with the JAX package's initialisers from
    ``seed``, load the SSL checkpoint (``ssl_pytree_path``, else
    ``ssl_ckpt_path``; see :func:`load_ssl_state_dict`) into its encoder,
    the layers a pruned student keeps selected from it, and re-initialise
    the configured SSL parameters after it; then the optimizer."""
    model = spec.module
    init_weights(model, seed)
    ssl_src = sys_config.ssl_pytree_path or sys_config.ssl_ckpt_path
    if ssl_src:
        enc = model.ssl_model.model
        sd = select_layers(load_ssl_state_dict(ssl_src, model.w2v_cfg),
                           spec.layer_indices, prefix="")
        check_ssl_shapes(enc.state_dict(), sd, ssl_src)
        enc.load_state_dict(sd, strict=True)
        if spec.reinit_patterns:
            reinit_params(model.ssl_model, spec.reinit_patterns, seed ^ 0x5eed)
    return TrainState(model, optimizer_for(spec, exp_config)(model))


def optimizer_for(spec: ModelSpec, exp_config: ExpConfig):
    """``model -> optimizer`` of the config, with ``spec``'s freeze rules
    (a placement on a mesh builds the optimizer anew through it)."""
    return lambda model: make_optimizer(
        model, exp_config.lr, exp_config.weight_decay, spec.freeze_patterns,
        spec.unfreeze_patterns, optimizer=exp_config.optimizer,
        mu_dtype=exp_config.adam_mu_dtype)


def load_ssl_state_dict(path: str, expect_cfg=None) -> StateDict:
    """The encoder's state dict from an SSL checkpoint, dispatched as the
    JAX package's ``load_ssl_params``: a directory holding ``config.json``
    is an HF snapshot, any other directory the JAX package's pytree
    directory (its ``weights.msgpack`` ``params``, as ``cli.convert``
    writes it), a file a fairseq or reference-named ``.pt``.

    ``expect_cfg``, the model's ``Wav2Vec2Config``: an HF snapshot's
    config must agree with it on the fields that change no parameter shape
    (a wrong head split would load cleanly and compute garbage)."""
    if not os.path.isdir(path):
        return encoder_state_dict(path)
    if not os.path.exists(os.path.join(path, "config.json")):
        params = flax_msgpack.read(os.path.join(path, "weights.msgpack"))
        return from_jax_ssl_params(params["params"])
    sd, derived = convert_hf_checkpoint(*load_hf_dir(path))
    if expect_cfg is not None:
        bad = [f"  {f}: snapshot {getattr(derived, f)!r} vs model "
               f"{getattr(expect_cfg, f)!r}"
               for f in ("encoder_heads", "layer_norm_first")
               if getattr(derived, f) != getattr(expect_cfg, f)]
        if bad:
            raise ValueError(
                f"HF snapshot {path!r} config disagrees with the model's w2v "
                "config on shape-invisible fields (these would load cleanly "
                "but run wrong math):\n" + "\n".join(bad))
    return sd


def check_ssl_shapes(model_sd: Mapping[str, torch.Tensor],
                     ckpt_sd: Mapping[str, torch.Tensor], src: str) -> None:
    """Raise a readable error, listing the mismatched entries, when an SSL
    checkpoint's dimensions do not match the model's ``w2v`` config (the
    JAX package's ``_check_ssl_shapes``, over the encoder's names)."""
    have = {k: tuple(v.shape) for k, v in ckpt_sd.items()}
    problems = []
    for key, t in model_sd.items():
        got = have.pop(key, None)
        if got is None:
            problems.append(f"  missing in checkpoint: {key} "
                            f"(model wants {tuple(t.shape)})")
        elif got != tuple(t.shape):
            problems.append(f"  {key}: checkpoint {got} vs model "
                            f"{tuple(t.shape)}")
    problems += [f"  not in model: {k} {v}" for k, v in have.items()]
    if problems:
        shown = "\n".join(problems[:8])
        more = (f"\n  ... and {len(problems) - 8} more"
                if len(problems) > 8 else "")
        raise ValueError(
            f"SSL checkpoint {src!r} does not match the model's w2v config "
            f"({len(problems)} mismatched leaves):\n{shown}{more}\n"
            "Check ExpConfig.kwargs.w2v (encoder dims / conv_layers / "
            "num_layers) against the checkpoint's architecture.")


def load_checkpoint_for_eval(ckpt: str, spec: ModelSpec) -> None:
    """Load a model into ``spec.module`` (strict) from a reference ``.pt``,
    one of the port's checkpoint directories, or one of the JAX package's:
    ``state.msgpack`` (its ``params`` and ``batch_stats``; the step and
    the optimizer state are not read) or weights-only ``weights.msgpack``.
    The JAX package's orbax directories raise."""
    if checkpoint.is_checkpoint(ckpt):
        sd = checkpoint.load_model_state(ckpt)
    elif os.path.isdir(ckpt):
        sd = from_jax_variables(checkpoint.load_jax_variables(ckpt), spec.name)
    else:
        sd = load_reference_state_dict(ckpt)
    spec.module.load_state_dict(sd, strict=True)


def apply_w8(sys_config: SysConfig, exp_config: ExpConfig, spec: ModelSpec,
             device: torch.device, a8: bool = False,
             name: Optional[str] = None,
             kwargs: Optional[dict] = None) -> ModelSpec:
    """Serving mode: rebuild the spec (the model ``name`` with ``kwargs``,
    by default the configured one) with int8 transformer matmuls and fill
    it with the loaded float model's weights, quantized on ``device``
    (models/quantize.py). ``a8=True`` adds dynamic int8 activations."""
    kwargs = dict(exp_config.kwargs if kwargs is None else kwargs)
    kwargs["w2v"] = {**(kwargs.get("w2v") or {}), "w8": True, "a8": bool(a8)}
    w8 = build_model(sys_config, exp_config, device, name=name, kwargs=kwargs)
    w8.module.load_state_dict(quantize_state_dict(spec.module.state_dict()),
                              strict=True)
    print("w8 scoring: XLSR transformer weights quantized to int8"
          + (" + dynamic int8 activations (w8a8)" if a8 else ""))
    return w8


def load_eval_model(sys_config: SysConfig, exp_config: ExpConfig, ckpt: str,
                    device: torch.device, w8: bool = False,
                    w8a8: bool = False, name: Optional[str] = None,
                    kwargs: Optional[dict] = None) -> ModelSpec:
    """Build the model ``sys_config`` names (a cascade's screener passes
    its own configs; ``name`` and ``kwargs`` override the model and its
    kwargs, as a distillation student's are), load ``ckpt`` (strict), and
    optionally quantize it (w8/w8a8, the config's
    ``w8_scoring``/``w8a8_scoring`` OR'd in)."""
    setup_mesh(exp_config)
    spec = build_model(sys_config, exp_config, device, name=name,
                       kwargs=kwargs)
    load_checkpoint_for_eval(ckpt, spec)
    print(f"Loaded checkpoint from {ckpt}")
    a8 = w8a8 or exp_config.w8a8_scoring
    if a8 or w8 or exp_config.w8_scoring:
        spec = apply_w8(sys_config, exp_config, spec, device, a8=a8,
                        name=name, kwargs=kwargs)
    return spec


def score_dataset(dataset, spec: ModelSpec, batch_size: int,
                  device: torch.device, on_decode_error: str = "raise",
                  num_workers: int = 4):
    """Score every trial of this process's stripe (all of them with one
    process) in order -> (utt_ids, scores). Batches are decoded as the JAX
    CLI decodes them (native, ``num_workers`` threads), dispatched without
    waiting, and read back once at the end."""
    step = make_score_step(spec.module)
    loader = EvalLoader(dataset, batch_size, num_workers=num_workers,
                        use_native=True, on_decode_error=on_decode_error,
                        process_index=distributed.process_index(),
                        process_count=distributed.process_count())
    names, outs = [], []
    batches = iter(loader)
    for _ in range(len(loader)):
        with span("score.loader_wait"):
            b = next(batches)
        waves = torch.from_numpy(b.waves).to(device, non_blocking=True)
        outs.append(step(waves)[:b.valid])
        names.extend(b.utt_ids[:b.valid])
    if not outs:
        return names, []
    with span("score.readback"):
        return names, torch.cat(outs).float().cpu().tolist()


def _write_score_file(save_path: str, names, scores) -> None:
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "w") as fh:
        for f, cm in zip(names, scores):
            fh.write("{} {}\n".format(f, cm))
    print(f"Wrote {len(names)} scores -> {save_path}")


def tag_score_path(save_path: str, comment, path_attr: str) -> str:
    """Insert ``_{comment}`` before the ``.txt`` of a score path; a path with
    no ``.txt`` is rejected so that two tagged runs cannot collide."""
    if not comment:
        return save_path
    if ".txt" not in save_path:
        raise ValueError(
            f"--comment needs a '.txt' score path to tag; "
            f"{path_attr}={save_path!r} has none")
    return save_path.replace(".txt", f"_{comment}.txt")


def _check_score_shortfall(dataset, names) -> None:
    """A score file must cover every trial (``skip`` may have dropped some)."""
    expected = len(dataset.trials)
    if len(names) != expected:
        raise RuntimeError(
            f"scored {len(names)}/{expected} trials — "
            f"{expected - len(names)} utterance(s) were skipped "
            f"(undecodable?). A score file must cover every trial; fix "
            f"the corpus or score with on_decode_error='raise' to see "
            f"the failing files.")


def produce_evaluation_file(dataset, spec: ModelSpec, save_path: str,
                            batch_size: int, device: torch.device,
                            on_decode_error: str = "raise") -> None:
    """Write the ``"{utt_id} {score}"`` score file, in the JAX package's
    byte format; the score is the raw bonafide logit. Several processes
    merge their stripes and process 0 writes."""
    names, scores = score_dataset(dataset, spec, batch_size, device,
                                  on_decode_error)
    names, scores = _gather_stripes(dataset, names, scores)
    _check_score_shortfall(dataset, names)
    if distributed.process_index() == 0:
        _write_score_file(save_path, names, scores)


def _gather_stripes(dataset, names, scores):
    """Every process's stripe merged into dataset order, the same on every
    process; as they are with one process. The stripes' padding scores a
    few trials twice: the first score stands (both are the same)."""
    if distributed.process_count() == 1:
        return names, scores
    merged = {}
    for part_names, part_scores in distributed.all_gather_objects(
            (names, scores)):
        for n, sc in zip(part_names, part_scores):
            merged.setdefault(n, sc)
    names = [t.utt_id for t in dataset.trials if t.utt_id in merged]
    return names, [merged[n] for n in names]


def subset_dataset(dataset, indices) -> AudioDataset:
    """A bare AudioDataset over a subset of ``dataset``'s trials, with its
    duration fit and crop."""
    return AudioDataset([dataset.trials[i] for i in indices],
                        dataset.duration,
                        is_random_start=dataset.is_random_start,
                        sample_rate=dataset.sample_rate)


def produce_evaluation_file_cascade(
        dataset_screen, dataset_full, spec_screen: ModelSpec,
        spec_full: ModelSpec, save_path: str, batch_size: int,
        device: torch.device, band: float, center: float = 0.0) -> None:
    """Two-stage cascade scoring: the screener scores every trial; the
    trials whose screener score lies in ``|score - center| <= band`` are
    scored again by the full model, as a second pass over a subset
    dataset. Both datasets list the same trials in the same order (they
    may differ in duration fit); a mismatch raises. The file keeps the
    score-file format. Several processes merge the screener's stripes
    before the subset is built, so that all build the same one, then
    stripe the subset and merge again; process 0 writes."""
    names, scores = score_dataset(dataset_screen, spec_screen, batch_size,
                                  device)
    names, scores = _gather_stripes(dataset_screen, names, scores)
    _check_score_shortfall(dataset_screen, names)
    esc = [i for i, sc in enumerate(scores) if abs(sc - center) <= band]
    if esc:
        sub = subset_dataset(dataset_full, esc)
        sub_names, sub_scores = _gather_stripes(
            sub, *score_dataset(sub, spec_full, batch_size, device))
        for i, name, sc in zip(esc, sub_names, sub_scores):
            if name != names[i]:
                raise RuntimeError(f"cascade datasets disagree at index {i}: "
                                   f"{names[i]!r} vs {name!r}")
            scores[i] = sc
    print(f"cascade: {len(esc)}/{len(names)} escalated "
          f"({100.0 * len(esc) / max(len(names), 1):.1f}%, "
          f"band {band} around {center})")
    if distributed.process_index() == 0:
        _write_score_file(save_path, names, scores)

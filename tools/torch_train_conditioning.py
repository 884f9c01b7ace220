"""How far float32 determines the port's train-step gradients, by depth.

For each layer selection of the full-width XLSR_AASIST (random seed-0
weights of ``chip_smoke.py``, its synthetic train clips, batch 4, float32,
TF32 off, PyTorch's deterministic algorithms) one train step runs three
times from the same state and seed: with the attention kernel, with its
plain version, and with PyTorch's math SDPA (no kernel). Printed per
selection: the gradients zero in exact arithmetic (max at most 1e-6 of the
largest), how many of the others differ from the plain step by more than
1e-3 of their max for the kernel and for math SDPA, the worst of them, and
how many discrete choices (max-pool, top-k order, ``maximum``, ``amax``)
differ from the plain step's.

Needs a CUDA device; run from the repo root:

    python3 tools/torch_train_conditioning.py [0-3 0-4,23 0-7 0-11 0-23]
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

SELECTIONS = ("0-3", "0-4,23", "0-7", "0-11", "0-23")


def parse(spec: str) -> list:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


@contextlib.contextmanager
def recording(rec: list):
    """Record the discrete choices of the graph back-end's forward without
    changing what it draws: sort orders, max-pool argmaxes, ``maximum``
    masks, ``amax`` argmaxes."""
    from rtdsd_tpu_torch.models.aasist import AASISTBackend

    sort, mp, mx, amax = torch.sort, F.max_pool2d, torch.maximum, torch.Tensor.amax
    forward, inside = AASISTBackend.forward, []

    def forward_(self, *a, **k):
        inside.append(True)
        try:
            return forward(self, *a, **k)
        finally:
            inside.pop()

    def sort_(x, *a, **k):
        out = sort(x, *a, **k)
        if inside:
            rec.append(("sort", out.indices.detach().clone()))
        return out

    def mp_(x, *a, **k):
        out, idx = mp(x, *a, return_indices=True, **k)
        if inside:
            rec.append(("max_pool2d", idx.detach().clone()))
        return out

    def mx_(a, b, *r, **k):
        if inside:
            rec.append(("maximum", (a >= b).detach().clone()))
        return mx(a, b, *r, **k)

    def amax_(x, *a, **k):
        dim = k.get("dim", a[0] if a else None)
        if inside and dim is not None:
            rec.append(("amax", x.detach().argmax(dim=dim).clone()))
        return amax(x, *a, **k)

    def swap(fns):
        (torch.sort, F.max_pool2d, torch.maximum, torch.Tensor.amax,
         AASISTBackend.forward) = fns

    swap((sort_, mp_, mx_, amax_, forward_))
    try:
        yield
    finally:
        swap((sort, mp, mx, amax, forward))


def main(argv) -> int:
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.registry import get_model
    from rtdsd_tpu_torch.models.wav2vec2 import select_layers
    from rtdsd_tpu_torch.ops import build

    dev = torch.device("cuda")
    print(cs.smi(), flush=True)
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sd = cs.random_reference_state_dict(get_model("XLSR_AASIST").module, seed=0)
    root = os.path.join(cs.WORK, "train")
    os.makedirs(root, exist_ok=True)
    cs.write_train_set(root)
    cs.write_train_config(root, os.path.join(root, "unused.pt"))
    waves, labels = cs.train_batch(dev, cs.PARITY_BATCH)
    ref = load_reference_state_dict(sd)
    ctxs = {"kernels": contextlib.nullcontext, "plain": cs.plain_kernels,
            "sdpa": lambda: cs.attention_swapped(cs.sdpa_math)}
    for spec_s in argv or SELECTIONS:
        t0 = time.perf_counter()
        layers = parse(spec_s)
        spec = get_model("My_XLSR_AASIST", dtype=torch.float32, remat=True,
                         num_layers=len(layers), order="custom",
                         custom_order=layers, fused_gat=True,
                         w2v={"fast_softmax": False})
        model = spec.module.to(dev).train()
        runs, choices = {}, {}
        with cs.deterministic():
            for name, ctx in ctxs.items():
                model.load_state_dict(select_layers(ref, spec.layer_indices),
                                      strict=True)
                rec = []
                with ctx(), recording(rec):
                    runs[name] = cs._train_step_outputs(model, waves, labels,
                                                        cs.TRAIN_LR)
                choices[name] = rec
        del model
        plain = runs["plain"]
        line = [f"layers {spec_s}: loss plain {plain['loss']:.7f}"]
        for name in ("kernels", "sdpa"):
            held = cs.held_per_tensor(runs[name]["grads"], plain["grads"],
                                      cs.TRAIN_GRAD_TOL)
            real = [n for n in held["gap"] if n not in held["zero"]]
            past = [n for n in real if n in held["over"]]
            flips = sum(int((a != b).sum()) for (_, a), (_, b) in
                        zip(choices[name], choices["plain"]))
            line.append(
                f"{name}: loss |d| {abs(runs[name]['loss'] - plain['loss']):.3g}, "
                f"{len(held['zero'])} zero (worst {cs._worst(held['gap'], held['zero'], 1)}), "
                f"{len(past)} of {len(real)} past {cs.TRAIN_GRAD_TOL} "
                f"(worst {cs._worst(held['gap'], real)}), "
                f"{flips} discrete choices of {len(choices[name])} ops differ")
        print("; ".join(line) + f"; {time.perf_counter() - t0:.1f} s",
              flush=True)
        del runs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

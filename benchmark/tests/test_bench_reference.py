"""The plain references against the program (``rtdsd_tpu_torch``) on the
CPU at a tiny size, in float32: each family's whole model at two depths
and its weights' names, a serving window, and the loader's tiling and
cutting of files. The references themselves import neither."""

import os

import numpy as np
import pytest
import torch

from benchmark.harness import audio, program, runner
from benchmark.harness.weights import make_weights, model_weights
from benchmark.reference import xlsr_aasist as ref
from benchmark.tests.tiny import config as tiny

SEED = 2 ** 31 + 11


@pytest.mark.parametrize("name", ["xlsr_aasist", "xlsr6_aasist",
                                  "tiny_conformer"])
def test_param_shapes_are_the_programs_state_dict(name):
    cfg = tiny(name, 2)
    fam = runner.family(cfg).reference
    want = {k: tuple(v.shape) for k, v in program.build_model(
        cfg, make_weights(fam.param_shapes(fam.ModelShape(cfg)), 1,
                          torch.device("cpu")),
        torch.device("cpu")).state_dict().items()}
    assert fam.param_shapes(fam.ModelShape(cfg)) == want


# (family's configuration, layers, samples, the pools' scoring vectors)
MODELS = [("xlsr_aasist", 1, 16000, "zero"),
          ("xlsr_aasist", 3, 24000, "zero"),
          ("xlsr_aasist", 1, 16000, "random"),
          ("xlsr_aasist", 3, 24000, "random"),
          # 531 frames: the relative positions clip at 512
          ("tiny_conformer", 1, 16000, None),
          ("tiny_conformer", 2, 170000, None)]


@pytest.mark.parametrize("name,layers,samples,pools", MODELS)
def test_reference_matches_program_float32(name, layers, samples, pools):
    """Both sides compute in float32 (TF32 off in the reference) with the
    same operations in another order: the program's attention kernel's
    plain path, fused norms and einsums against plain matmuls. Logits of
    order 1 after a few layers then differ by rounding, 1e-7 to 1e-6 at
    these sizes; atol 1e-4 leaves room for the longer sums of 531 frames
    and fails a wrong operation, which moves a logit by 1e-2 or more (the
    relative positions clipped at 100 instead of 512 move one by 0.018)."""
    cfg = tiny(name, layers)
    if pools == "random":
        cfg.pop("weights")
    fam = runner.family(cfg).reference
    w = model_weights(cfg, SEED, torch.device("cpu"))
    model = program.build_model(cfg, w, torch.device("cpu"))
    waves = torch.from_numpy(np.stack(audio.tones(
        np.random.default_rng(1), [samples] * 3, torch.device("cpu"))))
    with torch.no_grad():
        got = model(waves)[:, 1]
    want = fam.bonafide_scores(w, fam.ModelShape(cfg), waves, block=2)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_zero_pool_scores_keep_nodes_by_index():
    """With zero scoring vectors every node scores alike and a pool keeps
    its first nodes, in index order."""
    cfg = runner.config("xlsr_aasist")
    w = model_weights(cfg, SEED, torch.device("cpu"))
    p = ref.Params({k: v for k, v in w.items() if k.startswith("pool_S")})
    h = torch.randn(2, 10, 64)
    got = ref._pool(h, p, "pool_S", 0.5)
    s = torch.sigmoid(w["pool_S.proj.bias"])
    torch.testing.assert_close(got, h[:, :5] * s)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096)
    e8 = (ref.fp8_rounding(x) - x).abs().max() / x.abs().max()
    e16 = (x.bfloat16().float() - x).abs().max() / x.abs().max()
    assert e8 > 4 * e16
    assert ref.fp8_rounding(x).abs().max() == pytest.approx(
        float(x.abs().max()), rel=1e-6)


def test_window_scores_match_the_serving_engine(tmp_path):
    """The engine's windows (rings, extend, gather, score) against the
    reference's forward of each window's own samples."""
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer

    cfg = tiny("xlsr_aasist", 2)
    w = model_weights(cfg, SEED, torch.device("cpu"))
    model = program.build_model(cfg, w, torch.device("cpu"))
    eng = MultiStreamScorer(model, model.w2v_cfg, duration=16000, hop=8000,
                            max_streams=2)
    waves = audio.tones(np.random.default_rng(5), [40080] * 2,
                        torch.device("cpu"))
    hs = [eng.open_stream(s) for s in range(2)]
    for h, x in zip(hs, waves):
        eng.push(h, x)
    got = eng.drain()
    assert len(got) == 2 * 4
    want = ref.bonafide_scores(w, ref.ModelShape(cfg), torch.from_numpy(
        np.stack([waves[r.stream_id][r.start_sample:r.start_sample + 16000]
                  for r in got])))
    torch.testing.assert_close(torch.tensor([r.score for r in got]), want,
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("native", [True, False])
def test_fit_duration_matches_the_loader(tmp_path, native):
    """The loader's first-N crop of long files and tiling of short ones,
    native and Python decode, against ``fit_duration`` of the file read by
    the harness's own WAV reader."""
    from rtdsd_tpu_torch.data.dataset import AudioDataset
    from rtdsd_tpu_torch.data.loader import EvalLoader
    from rtdsd_tpu_torch.data.protocols import Trial

    rng = np.random.default_rng(3)
    paths = audio.write_track(str(tmp_path), rng, [3000, 7999, 8000, 20001],
                              torch.device("cpu"))
    ds = AudioDataset([Trial(f, os.path.basename(f), 0) for f in paths],
                      8000, is_random_start=False)
    (batch,) = list(EvalLoader(ds, 4, use_native=native))
    want = np.stack([audio.fit_duration(audio.read_wav(f), 8000).numpy()
                     for f in paths])
    np.testing.assert_array_equal(batch.waves, want)

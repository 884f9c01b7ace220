"""The operation and byte counts against reckonings by hand, written out
with the published sizes of XLS-R 300M, AASIST and the XLSR-Conformer
head."""

import importlib

import pytest

from benchmark.counts import xlsr_aasist as counts
from benchmark.counts import xlsr_conformer
from benchmark.harness import card
from benchmark.harness.runner import config as load_config

FLAGSHIP = load_config("xlsr_aasist")
STUDENT = load_config("xlsr6_aasist")
# the reference repo's Conformer head (its ``Model``): emb_size 144, 4
# heads, kernel 31, 4 blocks, feed-forward x4, conv expansion x2
CONFORMER = dict(FLAGSHIP, family="xlsr_conformer", backend={
    "emb_size": 144, "heads": 4, "kernel_size": 31, "n_encoders": 4,
    "ff_mult": 4, "conv_expansion_factor": 2, "max_pos_emb": 512})


def test_conv_frames_of_a_4_s_clip_and_a_1_s_window():
    conv = list(zip(FLAGSHIP["conv_dim"], FLAGSHIP["conv_kernel"],
                    FLAGSHIP["conv_stride"]))
    assert counts.conv_frames(conv, 64000) == [12799, 6399, 3199, 1599, 799,
                                               399, 199]
    assert counts.num_frames(FLAGSHIP, 16000) == 49


def test_frontend_of_a_4_s_clip():
    hand = (2 * 1 * 10 * 512 * 12799 + 2 * 512 * 3 * 512 * 6399
            + 2 * 512 * 3 * 512 * 3199 + 2 * 512 * 3 * 512 * 1599
            + 2 * 512 * 3 * 512 * 799 + 2 * 512 * 2 * 512 * 399
            + 2 * 512 * 2 * 512 * 199)
    assert counts.frontend_flops(FLAGSHIP, 64000) == hand


@pytest.mark.parametrize("cfg,layers", [(FLAGSHIP, 24), (STUDENT, 6)])
def test_encoder_over_199_frames(cfg, layers):
    t = 199
    per_layer = (4 * 2 * t * 1024 * 1024        # q, k, v, out
                 + 2 * 2 * t * 1024 * 4096      # fc1, fc2
                 + 2 * 2 * 16 * t * t * 64)     # 16 heads: Q K^T, P V
    hand = 2 * t * 512 * 1024 + 2 * t * 1024 * 64 * 128 + layers * per_layer
    assert counts.encoder_flops(cfg, t) == hand


def test_backend_of_a_1_s_window():
    """49 frames: after the 3x3 max pool 42 frequency rows by 16 frames;
    pooled to 21 + 8 nodes, then 10 + 4."""
    h, w = 42, 16
    convs = (2 * (h + 1) * w * 1 * 32 * 6 + 2 * h * w * 32 * 32 * 6
             + 2 * h * w * 1 * 32 * 3                          # (1, 32)
             + 2 * (h + 1) * w * 32 * 32 * 6 + 2 * h * w * 32 * 32 * 6
             + 2 * (h + 1) * w * 32 * 64 * 6 + 2 * h * w * 64 * 64 * 6
             + 2 * h * w * 32 * 64 * 3                         # (32, 64)
             + 3 * (2 * (h + 1) * w * 64 * 64 * 6 + 2 * h * w * 64 * 64 * 6))

    def gat(n):
        return (2 * n * n * 64 * 64 + 2 * n * n * 64 + 2 * n * n * 64
                + 2 * 2 * n * 64 * 64)

    def htrg(n, d):
        return (2 * n * d * d + 2 * n * n * d * 32 + 2 * n * n * 32
                + 2 * n * n * d + 3 * 2 * n * d * 32 + 2 * 2 * d * 32)

    hand = (2 * 49 * 1024 * 128 + convs + 2 * h * w * 2 * 64 * 128
            + gat(42) + gat(16) + 2 * (htrg(29, 64) + htrg(14, 32))
            + 2 * 160 * 2)
    assert counts.backend_flops(FLAGSHIP, 49) == hand


def test_forward_totals():
    """About 149 GFLOP a 4 s clip and 36 GFLOP a 1 s window for the
    flagship, 13.6 GFLOP a window for the student."""
    assert counts.forward_flops(FLAGSHIP, 64000) == pytest.approx(148.66e9,
                                                                  rel=1e-3)
    assert counts.forward_flops(FLAGSHIP, 16000) == pytest.approx(35.95e9,
                                                                  rel=1e-3)
    assert counts.forward_flops(STUDENT, 16000) == pytest.approx(
        35.95e9 - 18 * (8 * 49 * 1024 ** 2 + 4 * 49 * 1024 * 4096
                        + 4 * 16 * 49 * 49 * 64), rel=1e-3)


def test_attention_launch_and_bound():
    ops, nbytes = counts.attention_launch(40, 199, 16, 64, 2)
    assert ops == 2 * 2 * 40 * 16 * 199 * 199 * 64
    assert nbytes == 4 * 40 * 199 * 1024 * 2
    # bf16 on an H100: 65.2 MB at 3.35 TB/s (19.5 us) against 6.5 GFLOP
    # at 989 TFLOP/s (6.6 us): bound by the bytes, as at 576 windows
    assert card.bound_seconds(ops, nbytes, "bfloat16") == pytest.approx(
        nbytes / 3.35e12)
    ops1, nbytes1 = counts.attention_launch(576, 49, 16, 64, 2)
    assert card.bound_seconds(ops1, nbytes1, "bfloat16") == pytest.approx(
        nbytes1 / 3.35e12)


@pytest.mark.parametrize("cfg", [FLAGSHIP, STUDENT, CONFORMER])
def test_kernels_give_the_attention_launch_in_the_compute_dtype(cfg):
    """One ``mha_small_t`` launch, as ``attention_launch`` counts it: the
    flagship's and the student's (bf16), and the Conformer's encoder."""
    fam = xlsr_conformer if cfg is CONFORMER else counts
    assert fam.kernels(cfg, 40, 199) == {
        "mha_small_t": (*counts.attention_launch(40, 199, 16, 64, 2),
                        "bfloat16")}
    f32 = dict(cfg, program=dict(cfg["program"], compute_dtype="float32"))
    assert fam.kernels(f32, 576, 49)["mha_small_t"] == (
        *counts.attention_launch(576, 49, 16, 64, 4), "float32")


@pytest.mark.parametrize("family", ["xlsr_aasist", "xlsr_conformer"])
def test_kernels_counted_are_the_programs_kernels(family):
    """The adapter's list of kernels and the counts' name the same ones,
    so that every kernel the harness reads in a trace has its count."""
    program = importlib.import_module(f"benchmark.programs.{family}")
    fam = xlsr_conformer if family == "xlsr_conformer" else counts
    cfg = CONFORMER if family == "xlsr_conformer" else FLAGSHIP
    listed = program.kernels()
    assert set(listed) == set(fam.kernels(cfg, 40, 199))
    assert all(isinstance(t, str) and t and n >= 0
               for t, n in listed.values())


def test_conformer_head_over_199_frames():
    """199 frames and the class token, 200 rows, at width 144: per block
    two feed-forwards (144 -> 576 -> 144), q, k, v, three products over 4
    heads of 36 (Q K^T, Q against the position embeddings, P V), out,
    pointwise 144 -> 576, depthwise 288 x 31, pointwise 288 -> 144."""
    n = 200
    block = (2 * (2 * n * 144 * 576 + 2 * n * 576 * 144)
             + 3 * 2 * n * 144 * 144
             + 3 * 2 * 4 * n * n * 36
             + 2 * n * 144 * 144
             + 2 * n * 144 * 576 + 2 * n * 288 * 31 + 2 * n * 288 * 144)
    hand = 2 * 199 * 1024 * 144 + 4 * block + 2 * 144 * 2
    assert xlsr_conformer.head_flops(CONFORMER, 199) == hand
    assert xlsr_conformer.forward_flops(CONFORMER, 64000) == (
        counts.frontend_flops(FLAGSHIP, 64000)
        + counts.encoder_flops(FLAGSHIP, 199) + hand)

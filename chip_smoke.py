"""Chip smoke of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each of which fails the run (non-zero exit) when it fails:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build of every CUDA kernel from ``rtdsd_tpu_torch/csrc`` (parallel nvcc);
3. each kernel against its plain PyTorch version on the card, at the shapes
   its path gives it (batch 16), with times of the kernel, the plain
   version, the least time the card could take (bound) and, for attention,
   ``scaled_dot_product_attention`` as the library yardstick (timed here,
   never used by the port, its kernels named by the profiler): attention in
   float32 and bf16, each also at the edges of its kernels' tiling (bf16:
   T 1, 17, 37, 208, 256, 257 and the longest T the wrapper takes at D=64,
   D 16, 32, 128; float32: T 1, 17, 63, 64, 65, 199, 256, 257, both sides of
   the tiled kernel's limit and the longest T at every head dim; q, k, v
   views of one projection, a negative scale, and in float32 a zero one),
   with ptxas's registers and spills of the attention kernels; the two GAT
   functions at the main path's shapes and at the edges of the tiled body
   (N at 1, at one 4-key group and one past it, at a query-tile boundary,
   the largest N it takes and one past, which the rows body takes; D 16, 32,
   128; Do 8, 256 and an odd Do on the rows body up to its largest N; n1 at
   0, at a boundary and at N; batch 1; a bf16 ``x`` view and the model's
   transposed-view kernel, bit for bit against contiguous float32 copies),
   the tiled body's tanh against ``tanhf``, ptxas's registers and spills
   of both GAT bodies, and at the main path's shapes the tiled body timed in
   turns with the rows body (the one-pair-a-thread body of earlier
   versions), one call a CUDA graph and ten;
   ``quantize_int8`` at the flagship's three matrix shapes in both rounding
   modes and both layouts it reads in place (row-major and ``weight.t()``;
   bit for bit, plus statistics of the stochastic mode; one and ten calls a
   graph), the whole flagship state dict through ``quantize_state_dict``
   (144 pairs bit for bit; 144 quantize kernels and no copy, by the
   profiler), ``ln_gelu``, and ``conv_ln_gelu_grouped`` at the six
   front-end layer geometries, in bf16 on each body in turns (the
   tensor-core body and the FFMA body) beside the model's unfused layer,
   with ptxas's registers and spills of the quantize and conv kernels;
   ``gelu_fast`` (the rational-erf GELU) bit for bit against the plain
   chain at the FFN hidden of a scoring batch of 40 and of a 576-stream
   tick and at the front-end's transposed (40, 512, 12799), timed beside
   its bytes bound, the plain chain and ``F.gelu`` (the exact erf:
   information only), with ptxas's registers and spills;
4. the eval loader on the main path's track: the native (C++, built with
   g++ at first use, the CLI's) and the Python decode paths of
   ``EvalLoader`` give identical batches of
   first-N crops at 16 kHz; host decode ms per batch of 16 four-second
   clips for each;
   then the paths, each with every launch counter set to 0 just before it
   and read just after (``gelu_fast`` included: one launch a front-end conv
   layer, one for the positional conv and one a transformer layer in every
   bf16 forward, none in float32):
   a. the main path: a full-width XLSR_AASIST (24 layers, width 1024,
      random weights from seed 0) saved as a reference-named ``.pt``, 32
      synthetic four-second clips scored in bf16 through
      ``rtdsd_tpu_torch.cli.main`` with ``fused_gat: true`` and
      ``fast_softmax: false``; the counters must read 24, 2 and 4 per batch;
   b. int8 scoring: the same clips and ``.pt`` through the CLI with
      ``--w8`` and with ``--w8a8``: the same counts, and 144 launches of
      ``quantize_int8`` (24 layers x 6 matmuls) per run;
   c. the op ``fused_conv_frontend`` (not wired into the encoder, as in the
      JAX package) on (16, 64000) waves with the model's front-end weights,
      against the port's ``ConvFeatureExtractor``: 1 ``ln_gelu`` and 6
      ``conv_ln_gelu_grouped`` launches;
   d. the Conformer: a full-width XLSR_Conformer (24 layers, width 1024,
      emb 144, 4 heads, kernel 31, 4 blocks; random weights from seed 0)
      saved as a reference-named ``.pt`` and the 32 clips scored through
      the CLI with ``model: ConformerModel`` in bf16 (``fast_softmax:
      false``): 24 ``mha_small_t`` launches per batch and no other kernel;
      then with ``--w8a8``: 144 ``quantize_int8`` launches too;
   e. a cascade: the screener, a full-width My_XLSR_AASIST (layers 0-4 and
      23, the student of ``configs/kd_xlsr6_aasist.yaml``, ``fused_gat``,
      seed 1, its own ``--cascade_config``), scores the clips alone; then
      the cascade with the Conformer of (d) as the full model and the band
      halfway between the k-th and (k+1)-th smallest |screener score|, k
      the split nearest 16 where they differ (bf16 scores tie): k trials
      escalate, 6 x 2 + 24 x ceil(k / 16) ``mha_small_t``, 2 x 2 and 4 x 2
      GAT launches; lines that did not escalate are the screener's scores
      exactly, escalated ones the Conformer's within the CLI-versus-forward
      tolerance;
   f. ``configs/realtime_b1.yaml``'s model kwargs (``conv_segments: 8``) on
      the XLSR_AASIST of (a): one bf16 clip's logits against the same
      weights unsegmented, within the CLI-versus-forward tolerance;
   g. streaming: three files made from a seed under
      ``build/chip_smoke/stream/`` (61.31 s with its tail window off the
      320-sample grid, 2.5 s, 20 s at 22.05 kHz) through
      ``rtdsd_tpu_torch.cli.stream`` (4 s windows, 2 s hop, batch 8,
      ``--per_window --out``): the XLSR_AASIST of (a) naive and
      ``--incremental``, ``--incremental --w8a8``, and the Conformer of (d)
      ``--incremental``; launches exactly (score batches, warm-ups
      included) x (24, 2, 4), 144 ``quantize_int8`` with ``--w8a8``, none
      of the GAT for the Conformer and of the convstack kernels anywhere;
      window starts as ``frame_starts`` (snapped to the frame grid under
      ``--incremental``) give them, every score finite, naive and
      incremental bf16 scores at the same start within the
      CLI-versus-forward tolerance. Outside the CLI, on the 61.31 s file:
      at batch 8, in float32 (TF32 off) and bf16, every kernel call of
      both scorers against its plain version on the same inputs (phase 3's
      tolerances) and each scorer's window scores with the kernels against
      the same scorer with the plain versions (float32 within the logit
      tolerance; bf16 printed beside the float32 scores), the two scorers
      on the float32 model within the logit tolerance, and in bf16 their xRT
      (five rounds in turns) and device ms by kernel class of one
      ``window_scores`` call each and of its front-end alone;
   h. serving: 32 synthetic files of 6-10 s made from a seed under
      ``build/chip_smoke/serve/`` (every third with 2 s of exact silence)
      served as live streams through ``rtdsd_tpu_torch.cli.serve`` (1 s
      windows, 0.5 s hop, ``--per_window --out``): the XLSR_AASIST of (a)
      in bf16 with ``--gate_db -50``; a cascade, the screener of (e)
      primary and that XLSR_AASIST escalating over a band that holds about
      half of the screener's scores; ``--w8a8``. Window starts as the
      flush semantics give them, finite scores, launches exactly (24 or 6
      attention, 2 + 4 GAT) x (score and escalate dispatches, the warm-up's
      included), 144 ``quantize_int8`` with ``--w8a8``, no convstack
      launch; gated windows, zero segments and escalations present. Outside
      the CLI: the float32 engine (TF32 off, 32 streams) against direct
      scoring of the same windows (max |d| within 1e-4), every kernel call
      held to its plain version; the same pushes with the zero-segment
      fastpath off (within 1e-4); a cascade on 8 streams held to the
      plain versions in float32 and bf16; then bf16 engines at 128 and 512
      streams: one tick held to the plain versions, 20 ticks paced to the
      hop (tick p50 / p95), ``device_costs`` and device ms per tick, busy
      share, one tick's kernels by class, the memory estimate (JAX's
      formula plus the port's eager term) beside
      ``torch.cuda.max_memory_allocated()`` over the paced ticks, which it
      must not be below, with the limit the engine read and each dispatch
      shape's peak per row;
   i. the socket daemon: (a) an in-process ``ServeDaemon`` on the float32
      XLSR_AASIST (TF32 off) serving 8 of 4h's files over a Unix socket in
      int16, four through the port's ``ServeClient`` and four through its
      ``NativeServeClient`` (g++ at first use): every window once at the
      flush semantics' starts, within 1e-4 of direct scoring of the
      int16-quantized window, every kernel call held to its plain version,
      every handle CLOSED; (b) ``rtdsd_tpu_torch.cli.daemon.main`` in this
      process in bf16 (32 slots, stats every second) fed the 32 files of 4h
      by 32 of the port's feeder binaries with ``--realtime``, the
      ``--ckpt`` file replaced by seed-2 weights and SIGHUP sent mid-run,
      SIGTERM at the end: the reload line, ``reloads=1`` and no overrun or
      idle shed in the last stats line, every file's windows once and
      finite, launches exactly (24, 2, 4) x the score dispatches (the
      warm-up's included), the memory peak during the reload; (c) an
      in-process daemon on the bf16 model at 512 streams fed by a child
      process over 4 connections (1 s prefill, then a hop per stream every
      500 ms for 20 hops): every window once and finite, no overrun; the
      per-window latency from the completing push to its SCORE frame, the
      tick wall and the memory peak beside the estimate are printed;
   j. training: the SSL part of the seed-0 weights written as a fairseq
      ``.pt``; 64 train and 32 dev synthetic four-second clips with
      ASVspoof 2019 LA protocols (seed 3) under ``build/chip_smoke/train/``;
      ``rtdsd_tpu_torch.cli.main --config <json> --max_epoch 1`` in bf16
      with RawBoost4, batch 32, ``fused_gat: true``, ``fast_softmax:
      false`` and ``ssl_ckpt_path`` on that ``.pt``: launches exactly 48
      ``mha_small_t`` (forward and remat recompute) and no GAT a train step
      plus (24, 2, 4) a dev batch, every logged loss finite, ``last/``
      written; then ``--is_eval --is_score --ckpt runs/last`` scores the 32
      dev clips (finite, (24, 2, 4)), and the multi-GB state is deleted.
      Outside the CLI on the same weights: (a) one float32 train step (TF32
      off, PyTorch's deterministic algorithms) at batch 4 with the kernels
      against the same step with the plain versions, same seed, gated on
      the first 4 transformer layers at full width: loss within 1e-4,
      every gradient and AdamW's first moment and square-rooted second
      within 1e-3 of their tensor's max (those zero in exact arithmetic,
      max under 1e-6 of the largest gradient, held under 1e-6 of it),
      BatchNorm statistics within 1e-4, parameters after AdamW within 2 lr
      (+ 1e-6 of rounding); at full depth the loss, the zero gradients and
      the statistics are gated, and the count of other gradients past 1e-3
      is printed for the kernels and for a step with the math SDPA in
      place of the attention (float32's conditioning, no kernel in it);
      (b) ``mha_small_t``'s autograd function at (32,
      199, 16, 64), float32 and bf16, forward and dQ, dK, dV against
      autograd through the plain version at phase 3's tolerances; (c) bf16
      ms per train step at batch 32 (2 warm-ups, median [min, max] of 5),
      ``max_memory_allocated``, one step's launches (48 attention, no GAT),
      device busy share (kernel time over the profiled step's wall and
      over the median step) and device ms by kernel class (torch.profiler);
   k. the shipped configs' SSL route and the XLSR-Conformer recipe: (a)
      ``python -m rtdsd_tpu_torch.cli.convert --fairseq`` on 4j's
      full-width SSL ``.pt`` writes a pytree directory, which the port
      reads back equal to the ``.pt``'s own conversion, tensor for tensor;
      (b) ``cli.main --max_epoch 1`` trains a full-width XLSR_Conformer in
      bf16 from ``ssl_pytree_path`` on that directory (4j's clips, batch
      32, ``fast_softmax: false``) with ``data_augmentation: [mul_augment,
      ACN, HPF, LPF, GAN, TMK]`` and ``noise_path`` on four synthetic noise
      WAVs under ``build/chip_smoke/train/noise``: launches exactly 48
      ``mha_small_t`` a train step and 24 a dev batch, no GAT, every logged
      loss finite, ``last/`` written; scoring from it (finite, 24); (c) one
      float32 Conformer train step with both chains (TF32 off,
      deterministic algorithms) on layers 0-3 at full width, batch 4, with
      the kernels against the plain versions, gated as 4j (a); (d) bf16
      Conformer train steps at batch 32 with both chains: ms (median [min,
      max] of 5 after 2 warm-ups), ``max_memory_allocated``, one step's
      launches, busy share, device ms by kernel class, the chains' own
      device ms profiled alone on the batch, and the host chain's ms a
      batch of 32 clips;
   l. (run before k, which deletes 4j's SSL ``.pt``) knowledge
      distillation, ``configs/kd_xlsr6_aasist.yaml``'s recipe:
      (a) ``rtdsd_tpu_torch.cli.main_kd --max_epoch 1`` in bf16 with the
      seed-0 XLSR_AASIST ``.pt`` as the teacher and the My_XLSR_AASIST
      student on teacher layers 0-4 and 23 (the recipe's ``kd_kwargs``:
      KDLoss at T 4 on the logits, MSE of student layer 5 against teacher
      layer 23, weights 0.5 and 1.0, the copy in that order; ``fused_gat``
      and ``fast_softmax: false`` added), RawBoost4, 4j's clips cut to
      1 s, batch 32, the student's SSL init from 4j's fairseq ``.pt``:
      right after the copy, before the first step, the student's layer j
      equals teacher layer [0, 1, 2, 3, 4, 23][j] and every other
      parameter the teacher's, bit for bit, and its BatchNorm statistics
      are at their init; launches exactly 36 ``mha_small_t`` (24 teacher,
      6 + 6 student forward and recompute) and 2 / 4 GAT (the teacher's)
      a step, 6 / 2 / 4 in the dev batch; finite logged terms,
      ``last_kd/`` and one ``student_best_epoch0_*``; then ``--is_eval
      --eval student --is_score`` from ``last_kd/`` in bf16 and
      ``--w8a8``: 32 finite scores, (6, 2, 4) and 36 ``quantize_int8``
      (``last_kd/`` is kept for 4m);
      (b) one float32 KD step (TF32 off, deterministic algorithms) at
      batch 4, a 4-layer full-width teacher and a 2-layer student (layers
      0 and 3), the kernels against the plain versions: every loss term
      within 1e-4, gradients and AdamW's moments as 4j (a), the teacher
      bit for bit unchanged, and every kernel call of a third step held
      to its plain version; (c) bf16 KD steps of the recipe at batch 32:
      ms (median [min, max] of 5 after 2 warm-ups),
      ``max_memory_allocated``, one step's launches, busy share, device ms
      by kernel class and the teacher's forward alone; (d) 4j's bf16
      train step with AdamW, ``adam_mu_dtype: bfloat16`` and Adafactor:
      ms a step and the allocator's peak (information);
   j (e). (after 4j (c)) the remat settings ``full``, ``remat_policy:
      hidden``, ``dots`` and ``remat_save_every: 4``: one float32 train
      step each (TF32 off, deterministic algorithms, batch 4, layers 0-3
      at full width), every gradient within 1e-6 of its max of ``full``'s
      (the max |d| printed); then bf16 steps at batch 32 at full depth:
      ms a step (median [min, max] of 3 after one), ``max_memory_allocated``
      and one step's attention launches;
   m. (after 4l) export and artifact-only scoring and serving: (a)
      ``rtdsd_tpu_torch.cli.export`` in a fresh process on 4a's bf16
      ``.pt`` (``--batch sym --platforms cuda``: export wall, program and
      sidecar bytes), then ``cli.infer`` in another on 4a's 32 clips:
      scores against 4a's CLI scores within 0.05 x max(1, |score|), no
      model-defining or JAX module imported, launches exactly (48, 4, 8);
      4l's student from ``last_kd/`` exported with ``--student --w8a8
      --batch 32`` (4l's scoring batch; 36 ``quantize_int8``) and its
      artifact on 4l's dev clips against 4l's ``--w8a8`` student scores,
      (6, 2, 4); (b) a streaming bundle of 4a's model (4 s windows, 2 s
      hop) and ``cli.infer --per_window --batch_size 8`` on 4g's 16 kHz
      files: windows at 4g's incremental starts, scores within 0.05 x
      max(1, |score|) of ``cli.stream --incremental``, (24, 2, 4) a score
      call; (c) a serving bundle at 4h's
      geometry (512 streams, 1 s windows, 0.5 s hop, bf16, int16) with
      4h's cascade: the artifact engine against the checkpoint engine at
      the same fixed shapes on 4h's files (the same windows, flags and
      dispatch counts, scores within 0.05 x max(1, |score|), the count
      equal bit for bit printed), both timed in turns at 512 streams
      (tick p50 / p95, device ms a tick); ``cli.serve --artifact`` on the
      32 files and ``cli.daemon --artifact`` (16 files over the socket, a
      SIGHUP reloading the weight sidecars between two halves) with exact
      launches;
   n. (right after 4j's train CLI, whose ``last/`` and score file it
      reads) several processes: (a) world size 1 under NCCL at full
      width: ``python -m torch.distributed.run --nproc_per_node 1 -m
      rtdsd_tpu_torch.cli.main`` trains 4j's recipe with ``parallel_mode:
      dp`` one epoch (DDP): its first step's loss equals 4j's bit for bit;
      the same launcher scores the dev clips from 4j's ``last/``: the file
      equals 4j's byte for byte; then in this process, under a group of
      one, the DDP step and 4j's step timed in turns (bf16, batch 32, ms a
      step) and one DDP step's launches (48 attention); (b) two gloo
      processes sharing the card (``chip_smoke.py --ddp-worker``), a
      4-layer full-width XLSR_AASIST in float32 (TF32 off, deterministic
      algorithms, dropout off, no augmentation): DDP steps on each
      process's half of an 8-clip batch with losses equal on both and the
      parameters identical after, the first loss within 1e-4 of one
      process's step on the whole batch, the gradient collectives' ms a
      step (the step against one under ``no_sync``, in turns), and the dev
      clips scored at 8 a process, the merged file equal to one process's
      at 8 byte for byte;
5. one full-width float32 batch with the kernels against the same batch
   with every kernel swapped for its plain version (TF32 off): logits agree,
   for XLSR_AASIST and for XLSR_Conformer;
   then steady-state ms per clip (f32 at batch 16; bf16, w8, w8a8 and the
   bf16 XLSR_Conformer at batch 16 and batch 1, timed in turns over five
   rounds) and torch.profiler breakdowns of the device time of one f32 and
   one bf16 batch of 16, of one w8a8 batch of 16 and of 1, and of one bf16
   XLSR_Conformer batch of 16 with its head's share (the back-end profiled
   alone on the same batch's encoder features), and the kernels that the
   bf16 batch's six GAT calls launch (the GAT kernels and any cast or copy
   inside the calls); the bf16 forward at batch 16 and 1 with the kernels
   as ``torch.library`` operators (the port's binding) against their
   ``ctypes`` launches called directly, in turns (the binding's cost).

It prints a ``{"kernels": [...]}`` line (``stream_launches``: the launches
of the four runs of 4g together; ``serve_launches``: of the three CLI runs
of 4h; ``daemon_launches``: of the daemon CLI run of 4i (b);
``train_launches``: of the train CLI run of 4j;
``conformer_train_launches``: of the Conformer train CLI run of 4k;
``kd_launches``: of the KD CLI epoch of 4l; ``export_launches``: of
4m's exports and artifact runs together), the
``nvidia-smi`` name and power limit
line, and as its last line ``{"ok": true, "device": {...}}``. Scratch
files go to ``build/chip_smoke/`` in the checkout.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
B = 16                      # clips per batch on the main path
N_CLIPS = 32
SAMPLES = 64000             # 4 s at 16 kHz -> 199 frames
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
PEAK = {"bf16": 989e12, "f32": 67e12}   # dense FLOP/s, published
# (rtol, atol): f32 differs by summation order only; bf16 may round the
# output one step apart (a bf16 step is 2^-8 of the value)
ATTN_TOL = {"f32": (1e-4, 1e-5), "bf16": (1e-2, 1e-2)}
# bf16 attention, besides ATTN_TOL: |got - want| / |want| over the whole
# output. Rounding keeps it near 1e-3; a dropped 16-key tile at the longest
# T moves outputs of size 0.05 by 0.004 or more, about 10% of the norm.
ATTN_REL_NORM = 1e-2
GAT_TOL = (1e-4, 1e-5)      # f32 throughout, summation order only
LOGIT_TOL = 1e-3            # 24 f32 layers + graph back-end, order only
CONV_TOL = ATTN_TOL         # f32 summation order; bf16 one output step
FRONTEND_F32_ATOL = 5e-4    # rational vs exact erf over 7 layers
                            # (tests/test_pallas.py:171)
QUANT_SHAPES = ((1024, 1024), (1024, 4096), (4096, 1024))   # (in, out)
QUANT_Z = 6.0               # |mean rounding error| in standard errors
STEADY_REPEATS = 5          # rounds of the int8-vs-bf16 steady timings
FRONTEND_GELU = 7           # gelu_fast launches of a (b)f16 conv front-end
# gelu_fast launches of a bf16 train step of the 24-layer model under remat:
# the front-end and the positional conv once, each layer in the forward and
# again in its recompute (the backward recomputes the plain chain: no
# launch); of a KD step: the 24-layer teacher's forward and the 6-layer
# student's step
TRAIN_STEP_GELU = FRONTEND_GELU + 1 + 2 * 24
KD_STEP_GELU = (FRONTEND_GELU + 1 + 24) + (FRONTEND_GELU + 1 + 2 * 6)
# (Cin, Cout, k, s, T in) of front-end layers 1-6 on 64000 samples
CONV_LAYERS = tuple((512, 512, k, 2, t) for k, t in
                    ((3, 12799), (3, 6399), (3, 3199), (3, 1599), (2, 799),
                     (2, 399)))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_ms(fn, iters: int = 20, calls: int = 1) -> float:
    """Device time of one call of ``fn``: captured once in a CUDA graph and
    replayed, so host launch overhead is not in the number. A one-kernel
    graph takes 5-7 us a replay on an H100 whatever the kernel (a 16-float
    fill measured so); ``calls`` > 1 captures that many calls in the graph,
    so the number comes nearer the kernel's own time."""
    fn()                                         # warm-up, outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters / calls


def ptxas_summary(stem: str, kernels) -> list:
    """ptxas's registers and spills of the named kernels (mangled-name
    fragments) from the build log of ``csrc/<stem>.cu``."""
    from rtdsd_tpu_torch.ops import build

    with open(build.library_path(stem) + ".log") as f:
        lines = f.read().splitlines()
    return [f"ptxas {name}: " + " | ".join(l.split(":", 1)[-1].strip()
                                          for l in lines[i + 2:i + 4])
            for i, line in enumerate(lines) if "Compiling entry function" in line
            for name in kernels if name in line]


def bound_ms(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ phase 3

def check_attention_close(got, want, what: str) -> None:
    """Hold an attention output to ATTN_TOL of its dtype and, in bf16, to
    ATTN_REL_NORM."""
    kind = "bf16" if got.dtype == torch.bfloat16 else "f32"
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    rtol, atol = ATTN_TOL[kind]
    log(f"mha_small_t {kind} ({what}): max|d| {err:.3g} (rtol {rtol}, atol "
        f"{atol}), relative norm {rel:.3g}"
        + (f" (limit {ATTN_REL_NORM})" if kind == "bf16" else ""))
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
    if kind == "bf16" and not rel <= ATTN_REL_NORM:
        raise AssertionError(f"mha_small_t bf16 ({what}): relative norm {rel:.3g}")


def attention_edges(dev, g) -> None:
    """Both dtypes' kernels against their plain version at the edges of
    their tiling, and q, k, v as strided views of one (B, T, 3 H D)
    projection. bf16: T around 16-key tiles, 64-key groups and the 256-key
    register chunk, the two-pass paths past it (also with several query
    tiles per block at (16, 257, 16, 64), and at the streaming batch's
    (8, 199, 16, 64), where each block walks 2 of the 4 query tiles; the
    serving windows' (128 and 512, 49, 16, 64) in both dtypes), the
    longest T the wrapper takes at every head dim. float32: T around 32-key strips and 64-row query
    tiles, both sides of the tiled kernel's limit
    (attention.f32_tiled_max_seq), the longest T at every head dim; a
    negative and a zero scale in both."""
    from rtdsd_tpu_torch.ops.attention import (HEAD_DIMS, f32_tiled_max_seq,
                                               max_seq, mha_small_t,
                                               mha_small_t_reference)

    cases = {torch.bfloat16: (
        [(2, t, 4, 64) for t in (1, 17, 37, 208, 256, 257)]
        + [(2, 50, 4, d) for d in (16, 32, 128)]
        + [(2, 300, 4, 16), (2, 300, 4, 32), (2, 200, 4, 128)]
        + [(2, max_seq(d, torch.bfloat16), 4, d) for d in HEAD_DIMS]),
        torch.float32: (
        [(2, t, 4, 64) for t in (1, 17, 63, 64, 65, 199, 256, 257)]
        + [(2, 50, 4, d) for d in (16, 32, 128)]
        + [(2, f32_tiled_max_seq(d) + e, 4, d) for d in (16, 32, 128)
           for e in (0, 1)]
        + [(2, max_seq(d, torch.float32), 4, d) for d in HEAD_DIMS])}
    serve = [(b, SERVE_FRAMES, 16, 64) for b in SERVE_TIMED]
    views = {torch.bfloat16: [(16, 257, 16, 64), (B, 199, 16, 64),
                              (STREAM_BATCH, 199, 16, 64)] + serve,
             torch.float32: [(2, 199, 16, 64), (16, 257, 16, 64),
                             (STREAM_BATCH, 199, 16, 64)] + serve}
    for dtype in (torch.bfloat16, torch.float32):
        for d in (32, 64):               # a negative and a zero scale
            q, k, v = (torch.randn((2, 50, 4, d), generator=g, device=dev,
                                   dtype=dtype) for _ in range(3))
            for scale in ((-0.3,) if dtype == torch.bfloat16 else (-0.3, 0.0)):
                got = mha_small_t(q, k, v, scale=scale)
                want = mha_small_t_reference(q, k, v, scale=scale)
                check_attention_close(got, want, f"B=2, T=50, H=4, D={d}, "
                                                 f"scale {scale}")
        for b, t, h, d in cases[dtype] + views[dtype]:
            x = torch.randn((b, t, 3 * h * d), generator=g, device=dev,
                            dtype=dtype)
            q, k, v = (x[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
                       for i in range(3))
            if (b, t, h, d) in cases[dtype]:           # separate tensors
                q, k, v = (y.contiguous() for y in (q, k, v))
            got, want = mha_small_t(q, k, v), mha_small_t_reference(q, k, v)
            check_attention_close(got, want, f"B={b}, T={t}, H={h}, D={d}"
                                  + ("" if (b, t, h, d) in cases[dtype]
                                     else ", views of one projection"))


def kernel_names(fn) -> list:
    """Names of the device kernels one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def check_attention(dev) -> dict:
    import torch.nn.functional as F

    from rtdsd_tpu_torch.ops.attention import mha_small_t, mha_small_t_reference

    g = torch.Generator(device=dev).manual_seed(0)
    t, h, d = 199, 16, 64
    attention_edges(dev, g)
    rec = {}
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        # q, k, v as the layer makes them: views of (B, T, H*D) projections
        q, k, v = (torch.randn((B, t, h * d), generator=g, device=dev)
                   .to(dtype).view(B, t, h, d) for _ in range(3))
        got = mha_small_t(q, k, v)
        want = mha_small_t_reference(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rtol, atol = ATTN_TOL[kind]
        log(f"mha_small_t {kind} (B={B}, T={t}, H={h}, D={d}): max|d| {err:.3g}"
            f" (rtol {rtol}, atol {atol})")
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        ms = device_ms(lambda: mha_small_t(q, k, v))
        plain = device_ms(lambda: mha_small_t_reference(q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        lib = device_ms(sdpa)
        size = q.element_size()
        bnd, by = bound_ms(4 * B * t * h * d * size, 4 * B * h * t * t * d,
                           kind)
        log(f"  kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {bnd:.4f} ms ({by}); sdpa ran "
            + "; ".join(n[:80] for n in kernel_names(sdpa)))
        rec[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                         bound_by=by, library_ms=lib,
                         shape=f"q,k,v ({B},{t},{h},{d}) {kind}")
    return rec["bf16"]           # the main path runs attention in bf16


def _gat_ops(n: int, d: int, do: int) -> float:
    """Operations of one aggregation over B graphs of n nodes: per (i, j)
    the pair product (d), projection (2 d do), bias + tanh + edge dot
    (3 do), then softmax (3 n per row) and the weighted sum (2 n d)."""
    return B * (n * n * (d + 2 * d * do + 3 * do) + 3 * n * n + 2 * n * n * d)


def _gat_inputs(g, dev, b, n, d, do, x_dtype=torch.float32):
    x = torch.randn((b, n, d), generator=g, device=dev).to(x_dtype)
    w = torch.randn((d, do), generator=g, device=dev) * d ** -0.5
    bias = torch.randn((do,), generator=g, device=dev) * 0.1
    vecs = [torch.randn((do, 1), generator=g, device=dev) * do ** -0.5
            for _ in range(3)]
    return x, w, bias, vecs


def _gat_fns(gat, htrg: bool, x, w, bias, vecs, n1, temp):
    """(kernel call, plain call) of one GAT function on these inputs."""
    if htrg:
        return (lambda: gat.fused_htrg_gat_aggregate(x, w, bias, *vecs, n1, temp),
                lambda: gat.fused_htrg_gat_aggregate_reference(
                    x, w, bias, *vecs, n1, temp))
    return (lambda: gat.fused_gat_aggregate(x, w, bias, vecs[0], temp),
            lambda: gat.fused_gat_aggregate_reference(x, w, bias, vecs[0], temp))


def gat_edges(dev, g) -> None:
    """Both GAT functions against their plain versions at the edges of the
    tiled body and across the shape rule (ops/gat.py::tiled), at the
    model's four graphs for one clip and for the streaming batch of 8, at
    its four graphs of a 1 s serving window for a batch of 128, and
    on the model's layouts: x a bf16 (or float32) transposed view, the kernel
    ``att_proj.weight.t()``, bit for bit against contiguous float32 copies.
    Then the tiled body's tanh against tanhf."""
    from rtdsd_tpu_torch.ops import build, gat

    big = gat.max_nodes(64, 64, "tiled")
    homog = [(2, 1, 64, 64), (2, 4, 64, 64), (2, 5, 64, 64), (2, 8, 64, 64),
             (2, 9, 64, 64), (2, big, 64, 64), (2, big + 1, 64, 64),
             (2, 50, 16, 64), (2, 50, 32, 32), (2, 50, 128, 64),
             (2, 30, 128, 256), (3, 13, 16, 8), (2, 50, 64, 33),
             (2, gat.max_nodes(64, 33, "rows"), 64, 33), (1, 66, 64, 64),
             (1, 42, 64, 64), (STREAM_BATCH, 66, 64, 64),
             (STREAM_BATCH, 42, 64, 64)] + [
        (SERVE_TIMED[0], n, 64, 64) for n in SERVE_GAT_NODES]
    typed = [(2, 26, 32, 32, n1) for n1 in (0, 4, 8, 26)] + [
        (1, 54, 64, 32, 33), (2, 19, 16, 8, 9), (2, 54, 64, 33, 33),
        (STREAM_BATCH, 54, 64, 32, 33), (STREAM_BATCH, 26, 32, 32, 16)] + [
        (SERVE_TIMED[0], *g) for g in SERVE_HTRG_GRAPHS]
    cases = [(False, c, None) for c in homog] + [(True, c[:4], c[4]) for c in typed]
    worst = 0.0
    for htrg, (b, n, d, do), n1 in cases:
        x, w, bias, vecs = _gat_inputs(g, dev, b, n, d, do)
        run, ref = _gat_fns(gat, htrg, x, w, bias, vecs, n1,
                            100.0 if htrg else 2.0)
        got, want = run(), ref()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        what = (f"{'htrg' if htrg else 'gat'} (B={b}, N={n}, D={d}, Do={do}"
                f"{'' if n1 is None else f', n1={n1}'}, "
                f"{'tiled' if gat.tiled(n, d, do) else 'rows'} body)")
        try:
            torch.testing.assert_close(got, want, rtol=GAT_TOL[0], atol=GAT_TOL[1])
        except AssertionError:
            log(f"GAT {what}: max|d| {err:.3g} FAILS (rtol {GAT_TOL[0]}, "
                f"atol {GAT_TOL[1]})")
            raise
    log(f"GAT edges: {len(cases)} shapes, max|d| {worst:.3g} (rtol "
        f"{GAT_TOL[0]}, atol {GAT_TOL[1]}); largest N tiled {big}, rows "
        f"{gat.max_nodes(64, 33, 'rows')} (D=64, Do=33)")
    for htrg in (False, True):
        b, n, d, do, n1 = (B, 54, 64, 32, 33) if htrg else (B, 66, 64, 64, None)
        for dtype in (torch.bfloat16, torch.float32):
            x, _, bias, vecs = _gat_inputs(g, dev, b, n, d, do)
            x = x.transpose(1, 2).contiguous().transpose(1, 2).to(dtype)
            w = (torch.randn((do, d), generator=g, device=dev) * d ** -0.5).t()
            run, ref = _gat_fns(gat, htrg, x, w, bias, vecs, n1, 2.0)
            copies = _gat_fns(gat, htrg, x.float().contiguous(), w.contiguous(),
                              bias, vecs, n1, 2.0)[0]
            got, same, want = run(), copies(), ref()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            log(f"GAT {'htrg' if htrg else 'gat'} on the model's layouts (x a "
                f"{str(dtype)[6:]} view, W = weight.t()): equal to contiguous "
                f"f32 copies: {torch.equal(got, same)}; max|d| {err:.3g}")
            if not torch.equal(got, same):
                raise RuntimeError("GAT kernel differs on the model's layouts")
            torch.testing.assert_close(got, want, rtol=GAT_TOL[0], atol=GAT_TOL[1])
    x = torch.linspace(-12, 12, 1 << 22, device=dev)
    fast, ref = torch.empty_like(x), torch.empty_like(x)
    lib = build.library("gat", gat._SIGNATURES)
    build.check(lib.gat_tanh_check(x.data_ptr(), fast.data_ptr(), ref.data_ptr(),
                                   x.numel(), torch.cuda.current_stream().cuda_stream),
                "gat_tanh_check")
    d_f = (fast - ref).abs().max().item()
    d_64 = (fast.double() - x.double().tanh()).abs().max().item()
    d_ref = (ref.double() - x.double().tanh()).abs().max().item()
    log(f"GAT tanh (ex2.approx) on [-12, 12]: max|fast - tanhf| {d_f:.3g}, "
        f"max|fast - tanh (f64)| {d_64:.3g}, max|tanhf - tanh (f64)| {d_ref:.3g}")
    if d_f > 1e-6:
        raise RuntimeError("the GAT kernel's tanh is off tanhf by more than 1e-6")


def _gat_ops(n: int, d: int, do: int) -> float:
    """Operations of one aggregation over B graphs of n nodes: per (i, j)
    the pair product (d), projection (2 d do), bias + tanh + edge dot
    (3 do), then softmax (3 n per row) and the weighted sum (2 n d)."""
    return B * (n * n * (d + 2 * d * do + 3 * do) + 3 * n * n + 2 * n * n * d)


def check_gat(dev, htrg: bool) -> dict:
    from rtdsd_tpu_torch.ops import build, gat

    g = torch.Generator(device=dev).manual_seed(1)
    if not htrg:
        gat_edges(dev, g)
    # main-path shapes: GAT_layer_S/T, or HtrgGAT ST11/ST21 and ST12/ST22
    shapes = ([(54, 64, 32, 33, 100.0), (26, 32, 32, 16, 100.0)] if htrg
              else [(42, 64, 64, None, 2.0), (66, 64, 64, None, 2.0)])
    name = "fused_htrg_gat_aggregate" if htrg else "fused_gat_aggregate"
    rec = None
    for n, d, do, n1, temp in shapes:
        x, w, bias, vecs = _gat_inputs(g, dev, B, n, d, do)
        if not htrg:
            vecs = vecs[:1]
        run, ref = _gat_fns(gat, htrg, x, w, bias, vecs, n1, temp)
        got, want = run(), ref()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        log(f"{name} (B={B}, N={n}, D={d}, Do={do}"
            f"{'' if n1 is None else f', n1={n1}'}): max|d| {err:.3g} "
            f"(rtol {GAT_TOL[0]}, atol {GAT_TOL[1]})")
        torch.testing.assert_close(got, want, rtol=GAT_TOL[0], atol=GAT_TOL[1])
        # the rows body, the one-pair-a-thread body of earlier versions, on
        # the same inputs: the yardstick of the tiled one
        out, edges = torch.empty_like(x), (vecs * 3)[:3]
        lib = build.library("gat", gat._SIGNATURES)
        rows = lambda: build.check(lib.gat_rows_aggregate_f32(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(),
            *(e.data_ptr() for e in edges), out.data_ptr(), B, n, d, do,
            n if n1 is None else n1, temp,
            torch.cuda.current_stream().cuda_stream), "gat_rows_aggregate_f32")
        rows()
        torch.testing.assert_close(out, want, rtol=GAT_TOL[0], atol=GAT_TOL[1])
        # in turns: rows, tiled, tiled, rows; one call a graph, then ten
        t = {k: [] for k in ("rows", "tiled", "rows10", "tiled10")}
        for k in ("rows", "tiled", "tiled", "rows"):
            fn = rows if k == "rows" else run
            t[k].append(device_ms(fn))
            t[k + "10"].append(device_ms(fn, calls=10))
        ms, plain = t["tiled"][0], device_ms(ref)
        nbytes = 4 * (2 * B * n * d + d * do + (1 + len(vecs)) * do)
        bnd, by = bound_ms(nbytes, _gat_ops(n, d, do), "f32")
        log(f"  kernel {ms:.4f} / {t['tiled'][1]:.4f} ms, rows body "
            f"{t['rows'][0]:.4f} / {t['rows'][1]:.4f} ms; ten calls a graph: "
            f"kernel {t['tiled10'][0]:.4f} / {t['tiled10'][1]:.4f}, rows body "
            f"{t['rows10'][0]:.4f} / {t['rows10'][1]:.4f} ms a call; plain "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        this = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=None, rows_body_ms=t["rows"][0],
                    shape=f"x ({B},{n},{d}) W ({d},{do}) f32")
        if rec is None or this["ms"] > rec["ms"]:
            rec = this                       # report the heavier shape
    return rec


def check_quant(dev, sd: dict) -> dict:
    """quantize_int8 at the flagship's matrix shapes, in the two layouts
    the kernel reads in place (row-major (in, out), the JAX package's, and
    the transposed view ``weight.t()`` that the model's path passes):
    kernel and plain version bit for bit in both rounding modes; the
    stochastic mode's error below one scale step and unbiased per column;
    times one and ten calls a CUDA graph. Then the whole flagship state dict
    through quantize_state_dict (quant_state_dict). The reported record is
    the slowest shape and layout one call a graph (``ms``), with its time
    ten calls a graph beside it (``ms_ten_calls``)."""
    from rtdsd_tpu_torch.ops.quant import quantize_int8, quantize_int8_reference

    g = torch.Generator(device=dev).manual_seed(2)
    rec = None
    for n, (r, c) in enumerate(QUANT_SHAPES):
        seed = 7919 * (n + 1)
        for layout in ("row-major", "weight.t()"):
            trans = layout == "weight.t()"
            x = torch.randn((c, r) if trans else (r, c), generator=g,
                            device=dev) * r ** -0.5
            x = x.t() if trans else x
            for stochastic in (False, True):
                got = quantize_int8(x, seed, stochastic)
                want = quantize_int8_reference(x, seed, stochastic)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise RuntimeError(f"quantize_int8 ({r}, {c}) {layout} "
                                       f"stochastic={stochastic}: kernel != "
                                       f"plain version")
            vals, scales = got                       # the stochastic mode
            scaled = x.double() / scales.double()
            err = vals.double() - scaled
            var = (scaled - scaled.floor()) * (scaled.floor() + 1 - scaled)
            z_col = (err.mean(0) / (var.sum(0).sqrt() / r).clamp_min(1e-30)).abs()
            z_all = (err.mean() / (var.sum().sqrt() / err.numel())).abs().item()
            worst = err.abs().max().item()
            log(f"quantize_int8 ({r}, {c}) {layout}: kernel == plain in both "
                f"modes; stochastic max|q - x/scale| {worst:.6f} (< 1), "
                f"per-column |mean err| max {z_col.max().item():.2f} SE, whole "
                f"matrix {z_all:.2f} SE (limit {QUANT_Z})")
            if worst >= 1.0 or z_col.max().item() > QUANT_Z or z_all > QUANT_Z:
                raise RuntimeError("stochastic rounding out of its bounds")
            ms = device_ms(lambda: quantize_int8(x, seed))
            ms10 = device_ms(lambda: quantize_int8(x, seed), calls=10)
            plain = device_ms(lambda: quantize_int8_reference(x, seed, True))
            bnd, by = bound_ms(4 * r * c + r * c + 4 * c, 0, "f32")
            log(f"  kernel {ms:.4f} ms one call a graph, {ms10:.4f} ms ten "
                f"calls a graph; plain {plain:.4f} ms, bound {bnd:.4f} ms "
                f"({by})")
            if rec is None or ms > rec["ms"]:
                rec = dict(max_abs_err=0.0, ms=ms, ms_ten_calls=ms10,
                           plain_ms=plain, bound_ms=bnd, bound_by=by,
                           library_ms=None,
                           shape=f"x ({r},{c}) f32 {layout}, stochastic")
    quant_state_dict(sd, dev)
    return rec


def quant_state_dict(sd: dict, dev) -> None:
    """The flagship's 144 transformer matrices through quantize_state_dict
    on the card, as a ``--w8`` load runs it: every (vals, scales) pair equal
    bit for bit to the plain version on the same weight and seed, and, by
    the profiler, 144 quantize kernels and no other kernel (no copy)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.quantize import matmul_keys, quantize_state_dict
    from rtdsd_tpu_torch.ops.quant import quantize_int8_reference

    ref = {k: v.to(dev) for k, v in load_reference_state_dict(sd).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = quantize_state_dict(ref)
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
    n_quant = sum(c for k, c in kernels.items() if "quant_kernel" in k)
    others = {k: c for k, c in kernels.items() if "quant_kernel" not in k}
    keys = matmul_keys(ref)
    same = 0
    for n, key in enumerate(keys, start=1):
        vals, scales = quantize_int8_reference(ref[key].t(), seed=7919 * n,
                                               stochastic=True)
        base = key[:-len("weight")]
        same += (torch.equal(out[base + "vals"], vals)
                 and torch.equal(out[base + "scales"], scales))
    log(f"quantize_state_dict, flagship: {same} of {len(keys)} (vals, scales) "
        f"pairs equal to the plain version bit for bit; device kernels in "
        f"the call: {n_quant} quantize, others {others or 'none'}")
    if len(keys) != 144 or same != 144 or n_quant != 144 or others:
        raise RuntimeError("quantize_state_dict on the card: wrong matrices "
                           "or kernels besides the 144 quantize launches")


def check_ln_gelu(dev) -> dict:
    from rtdsd_tpu_torch.ops.convstack import ln_gelu, ln_gelu_reference

    g = torch.Generator(device=dev).manual_seed(3)
    shape = (B, 12799, 512)                 # layer 0's output at 4 s
    gamma = 1 + 0.1 * torch.randn(512, generator=g, device=dev)
    beta = 0.1 * torch.randn(512, generator=g, device=dev)
    x32 = torch.randn(shape, generator=g, device=dev) * 2
    rec = {}
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = x32.to(dtype)
        got, want = ln_gelu(x, gamma, beta), ln_gelu_reference(x, gamma, beta)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rtol, atol = CONV_TOL[kind]
        log(f"ln_gelu {kind} {shape}: max|d| {err:.3g} (rtol {rtol}, atol "
            f"{atol})")
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        ms = device_ms(lambda: ln_gelu(x, gamma, beta))
        plain = device_ms(lambda: ln_gelu_reference(x, gamma, beta))
        bnd, by = bound_ms(2 * x.numel() * x.element_size() + 2 * 512 * 4,
                           0, kind)
        log(f"  kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms "
            f"({by})")
        rec[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                         bound_by=by, library_ms=None,
                         shape=f"x {shape} {kind}")
    del x32
    return rec["bf16"]


# (name, shape, transposed): the FFN hidden of a scoring batch of 40 at 4 s
# and of a 576-stream serving tick at 1 s (contiguous), the front-end's
# first layer at batch 40 as its LayerNorm leaves it (the transpose of a
# contiguous (40, 12799, 512))
GELU_SHAPES = (("ffn, score batch", (40 * 199, 4096), False),
               ("ffn, serve tick", (576 * 49, 4096), False),
               ("front-end layer 0", (40, 12799, 512), True))


def check_gelu(dev) -> dict:
    """gelu_fast in bf16 at GELU_SHAPES: bit for bit and in the plain
    chain's layout against it, then the kernel (ten calls a CUDA graph),
    the plain chain and ``F.gelu`` (the exact erf, another function:
    information only) beside the bytes bound. The reported record is the
    scoring batch's FFN hidden."""
    import torch.nn.functional as F

    from rtdsd_tpu_torch.ops.fastgelu import gelu_fast, gelu_fast_reference

    g = torch.Generator(device=dev).manual_seed(4)
    recs = []
    for name, shape, transposed in GELU_SHAPES:
        x = (torch.randn(shape, generator=g, device=dev) * 3).bfloat16()
        if transposed:
            x = x.transpose(1, 2)
        got, want = gelu_fast(x), gelu_fast_reference(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want) or got.stride() != want.stride():
            raise RuntimeError(f"gelu_fast {name} {tuple(x.shape)} differs "
                               f"from the plain chain")
        del got, want
        ms = device_ms(lambda: gelu_fast(x), calls=10)
        plain = device_ms(lambda: gelu_fast_reference(x))
        lib = device_ms(lambda: F.gelu(x), calls=10)
        bnd, by = bound_ms(2 * x.numel() * x.element_size(), 0, "bf16")
        log(f"gelu_fast bf16 {name} {tuple(x.shape)} strides {x.stride()}: "
            f"bit for bit; kernel {ms:.4f} ms ({100 * bnd / ms:.1f}% of the "
            f"bound), plain {plain:.4f} ms, F.gelu {lib:.4f} ms (exact erf, "
            f"information), bound {bnd:.4f} ms ({by})")
        recs.append(dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                         bound_ms=bnd, bound_by=by, library_ms=lib,
                         shape=f"x {tuple(x.shape)} bf16 ({name})"))
        del x
    torch.cuda.empty_cache()
    return recs[0]


def unfused_layer(x, w, bias, gamma, beta, s: int):
    """One front-end layer as ConvFeatureExtractor runs it in bf16, on its
    (B, Cin, T) activations: F.conv1d with the bias, LayerNorm in float32,
    rational-erf GELU (three or more PyTorch calls; information only)."""
    import torch.nn.functional as F

    from rtdsd_tpu_torch.ops.fastgelu import gelu

    x_cf = x.transpose(1, 2).contiguous()
    wt, bt = w.permute(2, 1, 0).to(x.dtype).contiguous(), bias.to(x.dtype)

    def run():
        y = F.conv1d(x_cf, wt, bt, stride=s).transpose(1, 2)
        y = F.layer_norm(y.float(), (wt.shape[0],), gamma, beta, 1e-5)
        return gelu(y.to(x.dtype), fast=True)
    return run


def check_conv(dev) -> dict:
    """conv_ln_gelu_grouped at each front-end layer geometry, batch 16:
    float32 on the FFMA body; bf16 on both bodies (the tensor-core body,
    "mma", the rule's, and the FFMA body), each
    against the plain version within CONV_TOL and timed in turns, one call
    a CUDA graph (layers 5-6 also ten), with the model's unfused bf16 layer
    timed beside them for information. The reported record is layer 1 on
    the rule's body."""
    from rtdsd_tpu_torch.ops.convstack import (conv_body, conv_ln_gelu_grouped,
                                               conv_ln_gelu_grouped_reference)

    g = torch.Generator(device=dev).manual_seed(4)
    bodies = ("ffma", "mma")
    recs, total = [], {b: 0.0 for b in bodies + ("unfused",)}
    for layer, (cin, cout, k, s, t) in enumerate(CONV_LAYERS, start=1):
        w = torch.randn((k, cin, cout), generator=g, device=dev) * (k * cin) ** -0.5
        bias = 0.1 * torch.randn(cout, generator=g, device=dev)
        gamma = 1 + 0.1 * torch.randn(cout, generator=g, device=dev)
        beta = 0.1 * torch.randn(cout, generator=g, device=dev)
        x32 = torch.randn((B, t, cin), generator=g, device=dev)
        f_out = (t - k) // s + 1
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            runs = {b: (lambda b=b: conv_ln_gelu_grouped(
                x, w, bias, gamma, beta, k=k, s=s, body=b))
                for b in (bodies if kind == "bf16" else ("ffma",))}
            ref = lambda: conv_ln_gelu_grouped_reference(x, w, bias, gamma,
                                                         beta, k=k, s=s)
            want = ref().float()
            rtol, atol = CONV_TOL[kind]
            errs = {}
            for b, run in runs.items():
                got = run().float()
                torch.cuda.synchronize()
                errs[b] = (got - want).abs().max().item()
                try:
                    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
                except AssertionError:
                    log(f"conv_ln_gelu_grouped {kind} layer {layer}, {b} body: "
                        f"max|d| {errs[b]:.3g} FAILS (rtol {rtol}, atol {atol})")
                    raise
            log(f"conv_ln_gelu_grouped {kind} layer {layer} (B={B}, "
                f"T={t}->{f_out}, k={k}, s={s}, {cin}->{cout}): max|d| "
                + ", ".join(f"{b} {e:.3g}" for b, e in errs.items())
                + f" (rtol {rtol}, atol {atol})")
            if kind == "f32":
                continue
            # in turns: every body, then again in reverse order
            t1 = {b: [] for b in bodies}
            t10 = {b: [] for b in bodies}
            for b in bodies + bodies[::-1]:
                t1[b].append(device_ms(runs[b], iters=10))
                if layer >= 5:
                    t10[b].append(device_ms(runs[b], iters=10, calls=10))
            plain = device_ms(ref, iters=10)
            unfused = device_ms(unfused_layer(x, w, bias, gamma, beta, s), iters=10)
            size = x.element_size()
            nbytes = size * (B * t * cin + k * cin * cout + B * f_out * cout) \
                + 4 * 3 * cout
            bnd, by = bound_ms(nbytes, 2 * B * f_out * k * cin * cout, "bf16")
            rule = conv_body(dtype, cin, cout)
            for b in bodies:
                total[b] += t1[b][0]
            total["unfused"] += unfused
            log(f"  one call a graph: " + ", ".join(
                f"{b} {t1[b][0]:.4f} / {t1[b][1]:.4f}" for b in bodies)
                + (("; ten calls a graph: " + ", ".join(
                    f"{b} {t10[b][0]:.4f} / {t10[b][1]:.4f}" for b in bodies))
                   if t10["mma"] else "")
                + f" ms; plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}); "
                f"the model's unfused bf16 layer (conv1d + LN + GELU, "
                f"information) {unfused:.4f} ms; rule: {rule}")
            recs.append(dict(max_abs_err=errs[rule], ms=t1[rule][0],
                             plain_ms=plain, bound_ms=bnd, bound_by=by,
                             library_ms=None, ffma_ms=t1["ffma"][0],
                             unfused_layer_ms=unfused,
                             shape=f"x ({B},{t},{cin}) w ({k},{cin},{cout}) "
                                   f"s={s} bf16, {rule} body"))
    log(f"conv_ln_gelu_grouped: all six layers at batch {B}, bf16, one call "
        f"a graph each: " + ", ".join(f"{b} {v:.4f} ms" for b, v in total.items()))
    return recs[0]


# ------------------------------------------------------------ phase 4

def random_reference_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Random weights from a seed, under the reference's names: linear and
    conv weights ~ N(0, 1/fan_in), biases small, norms at identity, BN
    running stats non-trivial; the positional conv split into fairseq's
    weight_g / weight_v, and for an AASIST head the reference's dead bn1
    keys included."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "num_batches_tracked":
            sd[name] = torch.zeros((), dtype=torch.long)
        elif leaf == "running_var":
            sd[name] = torch.rand(t.shape, generator=g) + 0.5
        elif leaf in ("running_mean", "bias"):
            sd[name] = torch.randn(t.shape, generator=g) * 0.02
        elif t.dim() == 1:                      # norm scales
            sd[name] = torch.ones(t.shape)
        elif "att_weight" in leaf:              # edge vectors (Do, 1)
            sd[name] = torch.randn(t.shape, generator=g) * t.shape[0] ** -0.5
        else:
            fan_in = t[0].numel() if t.dim() > 1 else 1
            sd[name] = torch.randn(t.shape, generator=g) * fan_in ** -0.5
    for key in [k for k in sd if k.endswith(("pos_S", "master1", "master2"))]:
        sd[key] = torch.randn(sd[key].shape, generator=g)
    pos = "ssl_model.model.encoder.pos_conv.0.weight"
    w = sd.pop(pos)
    sd[pos + "_g"] = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd[pos + "_v"] = w
    for i in range(1, 6):
        if f"encoder.{i}.0.conv1.weight" not in sd:     # not an AASIST head
            break
        c = sd[f"encoder.{i}.0.conv1.weight"].shape[1]
        for leaf, val in (("weight", torch.ones(c)), ("bias", torch.zeros(c)),
                          ("running_mean", torch.zeros(c)),
                          ("running_var", torch.ones(c)),
                          ("num_batches_tracked", torch.zeros((), dtype=torch.long))):
            sd[f"encoder.{i}.0.bn1.{leaf}"] = val
    return sd


def write_track(root: str) -> None:
    from rtdsd_tpu_torch.data.io import write_wav

    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    lines = []
    for i in range(N_CLIPS):
        n = 40000 + 1000 * i          # some shorter than 4 s: repeat-tiled
        t = np.arange(n) / 16000
        bona = i % 2 == 1
        wave = (0.3 * np.sin(2 * np.pi * (220 + 20 * i) * t) if bona
                else 0.2 * rng.standard_normal(n)).astype(np.float32)
        uid = f"LA_E_{i:07d}"
        write_wav(os.path.join(root, "audio", uid + ".flac"), wave, 16000)
        lines.append(f"LA_0001 {uid} alaw ita_tx {'bonafide' if bona else 'spoof'}")
    with open(os.path.join(root, "la21.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_config(root: str, dtype: str, model: str = "XLSR_AASIST",
                 kwargs: dict = None, name: str = None) -> str:
    kwargs = kwargs or {"fused_gat": True, "w2v": {"fast_softmax": False}}
    cfg = {"SysConfig": {"model": model, "wandb_disabled": True,
                         "path_label_asv_spoof_2021_la_eval": f"{root}/la21.txt",
                         "path_asv_spoof_2021_la_eval": f"{root}/audio",
                         "la21_score_save_path": f"{root}/scores_la21.txt"},
           "ExpConfig": {"compute_dtype": dtype, "batch_size_test": B,
                         "test_duration_sec": SAMPLES / 16000,
                         "kwargs": kwargs}}
    path = os.path.join(root, f"config_{name or dtype}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=1)       # JSON syntax: loads with or without PyYAML
    return path


def counters():
    from rtdsd_tpu_torch.ops import attention, convstack, fastgelu, gat, quant

    return (attention.mha_small_t, gat.fused_gat_aggregate,
            gat.fused_htrg_gat_aggregate, quant.quantize_int8,
            convstack.ln_gelu, convstack.conv_ln_gelu_grouped,
            fastgelu.gelu_fast)


def reset_counters() -> None:
    for fn in counters():
        fn.launches = 0


def read_counters() -> dict:
    return {fn.__name__: fn.launches for fn in counters()}


def loader_phase() -> None:
    """The eval loader on the main path's track: the native decode path
    (the CLI's) and the Python one give identical batches (first-N crops,
    16 kHz WAV); host ms per batch of 16 four-second clips for each, median
    of three passes over the track (files in the page cache)."""
    from rtdsd_tpu_torch.config import load_yaml_config
    from rtdsd_tpu_torch.data.dataset import ASVspoof2021LA_eval
    from rtdsd_tpu_torch.data.loader import EvalLoader
    from rtdsd_tpu_torch.native import flac

    t0 = time.perf_counter()
    flac.load()
    log(f"native decoder: {os.path.basename(flac.library_path())} ready in "
        f"{time.perf_counter() - t0:.2f} s (g++ at first use)")
    ds = ASVspoof2021LA_eval(*load_yaml_config(write_config(WORK, "bfloat16")))
    batches, ms = {}, {}
    for native in (True, False):
        loader = EvalLoader(ds, B, num_workers=4, use_native=native)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            batches[native] = list(loader)
            times.append((time.perf_counter() - t0) * 1e3 / len(batches[native]))
        ms[native] = statistics.median(times)
    nat, py = batches[True], batches[False]
    same = len(nat) == len(py) and all(
        a.utt_ids == b.utt_ids and a.valid == b.valid
        and np.array_equal(a.labels, b.labels) and np.array_equal(a.waves, b.waves)
        for a, b in zip(nat, py))
    log(f"eval loader, LA21 track ({N_CLIPS} clips, batch {B}, first-N crops, "
        f"16 kHz WAV): native == Python batches: {same}; host decode per "
        f"batch of {B} four-second clips, median of 3 passes: native "
        f"(4 threads) {ms[True]:.2f} ms, Python {ms[False]:.2f} ms "
        f"({os.cpu_count()} host cores)")
    if not same:
        raise RuntimeError("native and Python eval loaders give other batches")


def gat_call_kernels(model, waves) -> None:
    """The kernels around the GAT launches of one forward: each GAT call is
    a ``record_function`` range in a profiled forward, and every kernel an
    op inside a range launches (a cast, a copy) is counted; the GAT kernels
    themselves (ctypes launches, under no op) by name."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from rtdsd_tpu_torch.models import aasist

    saved = {n: getattr(aasist, n) for n in ("fused_gat_aggregate",
                                             "fused_htrg_gat_aggregate")}

    def traced(fn):
        def call(*args, **kwargs):
            with record_function("gat_call"):
                return fn(*args, **kwargs)
        return call

    try:
        for n, fn in saved.items():
            setattr(aasist, n, traced(fn))
        with torch.inference_mode():
            model(waves)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model(waves)
                torch.cuda.synchronize()
    finally:
        for n, fn in saved.items():
            setattr(aasist, n, fn)

    def kernels(e):
        return [k.name for k in e.kernels] + [k for c in e.cpu_children
                                             for k in kernels(c)]

    # the profiler mirrors each range on the device's timeline: count the
    # host side only
    calls = [e for e in prof.events()
             if e.name == "gat_call" and e.device_type == DeviceType.CPU]
    around = Counter(k for e in calls for k in kernels(e))
    gat_kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and "gat_" in e.key
                      and e.key != "gat_call")
    log(f"one bf16 batch of {waves.shape[0]}: {len(calls)} GAT calls, "
        f"{gat_kernels} GAT kernels, {sum(around.values())} other kernels "
        f"launched inside the calls (casts, copies)"
        + "".join(f"; {k[:70]} x{c}" for k, c in sorted(around.items())))


def run_cli(cfg: str, ckpt: str, tag: str, extra=()) -> tuple:
    """Score the track through the CLI with every launch counter zeroed
    just before; -> (launches, {utt_id: score}, wall s). The score file
    must hold N_CLIPS finite scores."""
    from rtdsd_tpu_torch.cli import main as cli

    scores = os.path.join(WORK, f"scores_la21_{tag}.txt")
    if os.path.exists(scores):
        os.remove(scores)
    reset_counters()
    t0 = time.perf_counter()
    cli.main(["--config", cfg, "--is_eval", "--is_score", "--ckpt", ckpt,
              "--tracks", "LA21", "--comment", tag] + list(extra))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    with open(scores) as f:
        lines = f.read().splitlines()
    vals = np.array([float(l.split(" ")[1]) for l in lines])
    if len(lines) != N_CLIPS or not np.all(np.isfinite(vals)):
        raise RuntimeError(f"{tag}: score file has {len(lines)} lines, "
                           f"finite: {np.isfinite(vals).sum()}")
    return launches, {l.split(" ")[0]: float(l.split(" ")[1])
                      for l in lines}, wall


def launches_want(attention=0, gat=0, quantize=0, gelu=0) -> dict:
    """Expected counters; ``gat`` counts AASIST forwards (2 + 4 launches)."""
    return {"mha_small_t": attention, "fused_gat_aggregate": 2 * gat,
            "fused_htrg_gat_aggregate": 4 * gat, "quantize_int8": quantize,
            "ln_gelu": 0, "conv_ln_gelu_grouped": 0, "gelu_fast": gelu}


def w2v_gelu(layers: int) -> int:
    """gelu_fast launches of a bf16 forward from the wave: the front-end's
    conv layers, the positional conv and each transformer layer."""
    return FRONTEND_GELU + 1 + layers


def main_path(ckpt: str, mode: str = "") -> dict:
    """Score the track through the CLI in bf16, plain (``mode`` "") or with
    ``--w8`` / ``--w8a8``; check the scores and the launch counts."""
    tag = mode or "bf16"
    launches, scores, wall = run_cli(write_config(WORK, "bfloat16"), ckpt,
                                     tag, [f"--{mode}"] if mode else [])
    batches = -(-N_CLIPS // B)
    want = launches_want(24 * batches, batches, 144 if mode else 0,
                         w2v_gelu(24) * batches)
    log(f"{tag} path: {len(scores)} finite scores; launches {launches} "
        f"(want {want}); CLI wall {wall:.2f} s incl. model build, load"
        f"{' and quantization' if mode else ''}")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    return {"launches": launches, "scores": scores}


# the Conformer runs its encoder's attention through the kernel, as 4a does
CONFORMER_KWARGS = {"w2v": {"fast_softmax": False}}
# the 6-layer student of configs/kd_xlsr6_aasist.yaml, the cascade's screener
SCREENER_KWARGS = {"num_layers": 6, "order": "custom",
                   "custom_order": [0, 1, 2, 3, 4, 23], "fused_gat": True,
                   "w2v": {"fast_softmax": False}}


def conformer_path(ckpt: str) -> dict:
    """4d: the full-width XLSR_Conformer (``model: ConformerModel``)
    through the CLI in bf16 and with ``--w8a8``; -> the bf16 scores."""
    cfg = write_config(WORK, "bfloat16", "ConformerModel", CONFORMER_KWARGS,
                       name="conformer")
    batches = -(-N_CLIPS // B)
    scores = {}
    for mode in ("", "w8a8"):
        tag = "conformer_" + (mode or "bf16")
        launches, scores[tag], wall = run_cli(cfg, ckpt, tag,
                                              [f"--{mode}"] if mode else [])
        want = launches_want(24 * batches, quantize=144 if mode else 0,
                             gelu=w2v_gelu(24) * batches)
        log(f"{tag} path: {N_CLIPS} finite scores; launches {launches} (want "
            f"{want}); CLI wall {wall:.2f} s incl. model build and load"
            f"{' and quantization' if mode else ''}")
        if launches != want:
            raise RuntimeError(f"kernel launches {launches} != {want}")
    return scores["conformer_bf16"]


def cascade_path(ckpt: str, screener_ckpt: str, conformer: dict) -> None:
    """4e: the screener alone, then the cascade with the band halfway
    between the k-th and (k+1)-th smallest |screener score|, k the split
    nearest 16 where the two differ (bf16 scores can tie): k trials
    escalate to the Conformer. Lines that did not escalate are the
    screener's scores exactly; escalated ones the Conformer's within the
    CLI-versus-forward tolerance."""
    cfg_s = write_config(WORK, "bfloat16", "My_XLSR_AASIST", SCREENER_KWARGS,
                         name="screener")
    batches = -(-N_CLIPS // B)
    launches, screen, wall = run_cli(cfg_s, screener_ckpt, "screener")
    want = launches_want(6 * batches, batches, gelu=w2v_gelu(6) * batches)
    log(f"screener (My_XLSR_AASIST, layers {SCREENER_KWARGS['custom_order']})"
        f": launches {launches} (want {want}); CLI wall {wall:.2f} s")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    mags = np.sort(np.abs(list(screen.values())))
    cuts = [k for k in range(1, N_CLIPS) if mags[k - 1] < mags[k]]
    if not cuts:
        raise RuntimeError("every screener score has the same magnitude")
    half = min(cuts, key=lambda k: abs(k - N_CLIPS // 2))
    band = float((mags[half - 1] + mags[half]) / 2)
    launches, cascade, wall = run_cli(
        os.path.join(WORK, "config_conformer.json"), ckpt, "cascade",
        ["--cascade_ckpt", screener_ckpt, "--cascade_config", cfg_s,
         "--cascade_band", repr(band), "--cascade_center", "0"])
    esc = sorted(u for u, v in screen.items() if abs(v) <= band)
    want = launches_want(6 * batches + 24 * -(-len(esc) // B), batches,
                         gelu=w2v_gelu(6) * batches
                         + w2v_gelu(24) * -(-len(esc) // B))
    kept = sum(cascade[u] == screen[u] for u in screen if u not in esc)
    err = max(abs(cascade[u] - conformer[u]) for u in esc)
    scale = max(1.0, max(abs(conformer[u]) for u in esc))
    log(f"cascade (band {band:.6g} around 0): {len(esc)}/{N_CLIPS} escalated; "
        f"launches {launches} (want {want}); {kept}/{N_CLIPS - len(esc)} kept "
        f"lines equal the screener's; escalated vs the Conformer's own bf16 "
        f"scores max|d| {err:.3g} (tol {0.05 * scale:.3g}); CLI wall "
        f"{wall:.2f} s incl. both models' build and load")
    if len(esc) != half or launches != want:
        raise RuntimeError(f"cascade escalated {len(esc)}, launches {launches}")
    if kept != N_CLIPS - len(esc) or err > 0.05 * scale:
        raise RuntimeError("cascade scores differ from the two models' own")


def realtime_path(sd: dict, dev) -> None:
    """4f: configs/realtime_b1.yaml's model kwargs (``conv_segments: 8``)
    on the full-width XLSR_AASIST, against the same weights unsegmented, one
    bf16 clip."""
    from rtdsd_tpu_torch.config import load_yaml_config
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.registry import get_model

    sys_cfg, exp_cfg = load_yaml_config(os.path.join(ROOT, "configs",
                                                     "realtime_b1.yaml"))
    w2v = exp_cfg.kwargs["w2v"]
    ref = load_reference_state_dict(sd)
    wave = batch_waves(dev)[:1]
    logits = {}
    for n in (w2v["conv_segments"], 0):
        spec = get_model(sys_cfg.model, dtype=torch.bfloat16,
                         **{**exp_cfg.kwargs, "w2v": {**w2v, "conv_segments": n}})
        spec.module.to(dev).load_state_dict(ref, strict=True)
        with torch.inference_mode():
            logits[n] = spec.module.eval()(wave).float()
        del spec
    seg = logits[w2v["conv_segments"]]
    err = (seg - logits[0]).abs().max().item()
    scale = max(1.0, logits[0].abs().max().item())
    log(f"realtime_b1 ({sys_cfg.model}, {exp_cfg.compute_dtype}, kwargs "
        f"{exp_cfg.kwargs}): one clip, logits conv_segments "
        f"{w2v['conv_segments']} vs 0 max|d| {err:.3g} (tol {0.05 * scale:.3g})")
    if not torch.isfinite(seg).all() or err > 0.05 * scale:
        raise RuntimeError("conv_segments logits differ from unsegmented")


STREAM_WINDOW, STREAM_HOP, STREAM_BATCH = 64000, 32000, 8   # 4 s, 2 s at 16 kHz
# (name, samples, rate): 61.31 s, its tail window at 916960, off the
# 320-sample frame grid; 2.5 s, shorter than a window (tiled); 20 s at
# 22.05 kHz (resampled to 320000 samples)
STREAM_FILES = (("long", 980960, 16000), ("short", 40000, 16000),
                ("resampled", 441000, 22050))


def write_stream_audio(root: str) -> dict:
    """The streaming files from seed 2 -> {path: samples at 16 kHz}."""
    from rtdsd_tpu_torch.data.dataset import resample
    from rtdsd_tpu_torch.data.io import load_audio, write_wav

    rng = np.random.default_rng(2)
    os.makedirs(root, exist_ok=True)
    lengths = {}
    for name, n, sr in STREAM_FILES:
        t = np.arange(n) / sr
        wave = (0.2 * np.sin(2 * np.pi * 300 * t) * (1 + np.sin(np.pi * t)) / 2
                + 0.1 * rng.standard_normal(n)).astype(np.float32)
        path = os.path.join(root, f"{name}.wav")
        write_wav(path, wave, sr)
        w, rate = load_audio(path)
        lengths[path] = len(w) if rate == 16000 else len(resample(w, rate, 16000))
    return lengths


def stream_plan(lengths: dict, incremental: bool) -> tuple:
    """The CLI's windows and dispatches, derived here from its rules ->
    ({path: window starts}, score batches of the run, warm-ups included,
    the incremental scorer's conv front-end calls): one warm-up window
    first; the incremental scorer snaps starts down to the 320-sample
    grid, drops duplicates and warms each new segment bucket (frames of
    max(T, window) in 256-frame segments, the count rounded up to a
    multiple of 4) with a wave of the file's length, and runs the front-end
    once a ``window_scores`` call."""
    from rtdsd_tpu_torch.engine.streaming import frame_starts
    from rtdsd_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    cfg = Wav2Vec2Config()
    starts, batches, buckets, frontends = {}, 1, set(), 1
    for path, t in lengths.items():
        s = frame_starts(t, STREAM_WINDOW, STREAM_HOP)
        if incremental:
            s = sorted({x - x % cfg.total_stride for x in s})
            segs = -(-cfg.num_frames(max(t, STREAM_WINDOW)) // 256)
            bucket = -(-segs // 4) * 4
            if bucket not in buckets:
                buckets.add(bucket)
                batches += -(-len(s) // STREAM_BATCH)
                frontends += 1
        starts[path] = s
        batches += -(-len(s) // STREAM_BATCH)
        frontends += 1
    return starts, batches, frontends


def run_stream(cfg: str, ckpt: str, lengths: dict, tag: str, extra=()) -> tuple:
    """Stream the files through ``rtdsd_tpu_torch.cli.stream`` with every
    launch counter zeroed just before -> (launches, {path: {start sample:
    score}}, wall s). The per-window lines must sit at the planned starts
    with finite scores, and each file must have a finite aggregate on
    stdout and in ``--out``."""
    from rtdsd_tpu_torch.cli import stream as cli

    out = os.path.join(WORK, "stream", f"{tag}.txt")
    paths = list(lengths)
    want_starts, _, _ = stream_plan(lengths, "--incremental" in extra)
    buf = io.StringIO()
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["--config", cfg, "--ckpt", ckpt, "--audio", *paths,
                  "--window_sec", str(STREAM_WINDOW / 16000), "--hop_sec",
                  str(STREAM_HOP / 16000), "--batch_size", str(STREAM_BATCH),
                  "--per_window", "--out", out, *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    with open(os.path.join(WORK, "stream", f"{tag}.stdout"), "w") as f:
        f.write(buf.getvalue())
    windows, files = {p: [] for p in paths}, {}
    for line in buf.getvalue().splitlines():
        head, *rest = line.split(" ")
        path = head.split("#")[0]
        if path not in windows:
            continue
        if "#" in head:
            windows[path].append((head, rest[0], float(rest[1])))
        else:
            files[path] = float(rest[0])
    with open(out) as f:
        out_files = [l.split(" ")[0] for l in f.read().splitlines()]
    scores = {}
    for path in paths:
        want = [(f"{path}#{i}", f"{s / 16000:.2f}")
                for i, s in enumerate(want_starts[path])]
        if [w[:2] for w in windows[path]] != want:
            raise RuntimeError(f"{tag}: {path} windows {[w[:2] for w in windows[path]]}"
                               f" != {want}")
        vals = [w[2] for w in windows[path]]
        if not (np.all(np.isfinite(vals)) and np.isfinite(files.get(path, np.nan))):
            raise RuntimeError(f"{tag}: {path} has a score that is not finite")
        scores[path] = dict(zip(want_starts[path], vals))
    if out_files != paths:
        raise RuntimeError(f"{tag}: --out lists {out_files}")
    return launches, scores, wall


def stream_path(ckpt: str, conformer_ckpt: str) -> dict:
    """4g: the three files streamed through the CLI, 4 s windows, 2 s hop,
    batch 8: the XLSR_AASIST of 4a in bf16 naive and ``--incremental``,
    ``--incremental --w8a8``, and the Conformer of 4d ``--incremental``.
    Launches exactly (score batches, warm-ups included) x (24, 2, 4), 144
    ``quantize_int8`` with ``--w8a8``, no GAT launch for the Conformer, no
    convstack launch, ``gelu_fast`` 32 a naive batch and 25 an incremental
    one plus 7 a front-end call; naive and incremental bf16 scores on windows that
    start at the same sample within the CLI-versus-forward tolerance.
    -> launches summed over the four runs."""
    lengths = write_stream_audio(os.path.join(WORK, "stream"))
    cfg = write_config(WORK, "bfloat16")
    cfg_c = write_config(WORK, "bfloat16", "ConformerModel", CONFORMER_KWARGS,
                         name="conformer")
    total, scores = {}, {}
    for tag, c, pt, extra, gat in (
            ("naive", cfg, ckpt, [], True),
            ("incremental", cfg, ckpt, ["--incremental"], True),
            ("incremental_w8a8", cfg, ckpt, ["--incremental", "--w8a8"], True),
            ("conformer_incremental", cfg_c, conformer_ckpt,
             ["--incremental"], False)):
        incremental = "--incremental" in extra
        starts, batches, frontends = stream_plan(lengths, incremental)
        launches, scores[tag], wall = run_stream(c, pt, lengths, tag, extra)
        # incremental: the front-end once a window_scores call, the
        # positional conv and the layers once a score batch
        gelu = (FRONTEND_GELU * frontends + (1 + 24) * batches
                if incremental else w2v_gelu(24) * batches)
        want = launches_want(24 * batches, batches if gat else 0,
                             144 if "--w8a8" in extra else 0, gelu)
        log(f"stream {tag}: {sum(map(len, starts.values()))} windows "
            f"({', '.join(str(len(s)) for s in starts.values())}), {batches} "
            f"score batches of {STREAM_BATCH} with the warm-ups; launches "
            f"{launches} (want {want}); CLI wall {wall:.2f} s incl. model "
            f"build and load")
        if launches != want:
            raise RuntimeError(f"kernel launches {launches} != {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    naive_starts, _, _ = stream_plan(lengths, False)
    on_grid = sum(s % 320 == 0 for v in naive_starts.values() for s in v)
    worst, shared = 0.0, 0
    for path, naive in scores["naive"].items():
        for start, s in naive.items():
            if start in scores["incremental"][path]:
                d = abs(scores["incremental"][path][start] - s)
                worst = max(worst, d / max(1.0, abs(s)))
                shared += 1
    log(f"stream naive vs incremental bf16: {shared} windows at the same "
        f"start, max |d| / max(1, |score|) {worst:.3g} (tol 0.05)")
    if worst > 0.05 or shared != on_grid:
        raise RuntimeError("naive and incremental streaming scores differ")
    return total, scores["incremental"]


@contextlib.contextmanager
def kernels_held_to_plain(worst: dict):
    """Every kernel call the model makes also runs the kernel's plain
    version on the same inputs and holds the output to it: attention at
    ATTN_TOL of its dtype (and ATTN_REL_NORM in bf16), GAT at GAT_TOL,
    ``gelu_fast`` bit for bit. ``worst`` collects {name: [calls, max |d|,
    shapes seen]}."""
    from rtdsd_tpu_torch.models import aasist, wav2vec2
    from rtdsd_tpu_torch.ops import attention, fastgelu, gat

    def attention_close(got, want):
        kind = "bf16" if got.dtype == torch.bfloat16 else "f32"
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, rtol=ATTN_TOL[kind][0],
                                   atol=ATTN_TOL[kind][1])
        rel = ((got - want).norm() / want.norm()).item()
        if kind == "bf16" and not rel <= ATTN_REL_NORM:
            raise AssertionError(f"mha_small_t bf16: relative norm {rel:.3g}")

    def gat_close(got, want):
        torch.testing.assert_close(got, want, rtol=GAT_TOL[0], atol=GAT_TOL[1])

    def same_bits(got, want):
        if not torch.equal(got, want) or got.stride() != want.stride():
            raise AssertionError(f"gelu_fast {tuple(got.shape)} differs from "
                                 f"the plain chain")

    def held(name, fn, ref, close):
        def call(*args, **kwargs):
            got, want = fn(*args, **kwargs), ref(*args, **kwargs)
            close(got, want)
            w = worst.setdefault(name, [0, 0.0, set()])
            w[0] += 1
            w[1] = max(w[1], (got.float() - want.float()).abs().max().item())
            w[2].add(tuple(args[0].shape))
            return got
        return call

    swaps = [(wav2vec2, "mha_small_t", attention.mha_small_t_reference,
              attention_close),
             (aasist, "fused_gat_aggregate", gat.fused_gat_aggregate_reference,
              gat_close),
             (aasist, "fused_htrg_gat_aggregate",
              gat.fused_htrg_gat_aggregate_reference, gat_close),
             (fastgelu, "gelu_fast", fastgelu.gelu_fast_reference, same_bits)]
    saved = [(m, n, getattr(m, n)) for m, n, _, _ in swaps]
    try:
        for m, n, ref, close in swaps:
            setattr(m, n, held(n, getattr(m, n), ref, close))
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def stream_against_plain(sc: dict, wave, tol) -> dict:
    """The kernels at the streaming batch of 8 on the path's own data:
    both scorers' ``window_scores`` once with every kernel call held to its
    plain version (kernels_held_to_plain), then again with every kernel
    swapped for its plain version (no launch counted), window scores held
    within ``tol`` (None: printed only) -> {scorer: (with the kernels,
    with the plain versions)}."""
    worst = {}
    with kernels_held_to_plain(worst):
        ws = {k: s.window_scores(wave) for k, s in sc.items()}
    log("  every kernel call against its plain version on the same inputs: "
        + "; ".join(f"{n} {c} calls at {sorted(shapes)}, max|d| {e:.3g}"
                    for n, (c, e, shapes) in worst.items()))
    reset_counters()
    with plain_kernels():
        plain = {k: s.window_scores(wave) for k, s in sc.items()}
    if any(read_counters().values()):
        raise RuntimeError(f"a kernel launched under plain_kernels(): "
                           f"{read_counters()}")
    for k in sc:
        d = np.abs(ws[k] - plain[k])
        log(f"  {k}: {len(d)} window scores, kernels vs plain max|d| "
            f"{d.max():.3g}" + ("" if tol is None else f" (tol {tol})"))
        if not np.all(np.isfinite(ws[k])) or (tol is not None and d.max() > tol):
            raise RuntimeError(f"{k} streaming scores with the kernels differ "
                               f"from the plain versions by {d.max()}")
    return {k: (ws[k], plain[k]) for k in sc}


def stream_device(sd: dict, dev, long_path: str) -> None:
    """Outside the CLI, on the 61.31 s file, in float32 (TF32 off) and in
    bf16: every kernel call of both scorers held to its plain version on
    the same inputs, and each scorer's window scores with the kernels
    against the same scorer with the plain versions, in float32 within
    LOGIT_TOL (in bf16 printed only: beside the float32 scores, both bf16
    paths are as far off, since 24 bf16 layers and the graph pooling's
    ranking turn one-step differences of attention outputs into changes
    of order 1 on random weights); the two float32 scorers against each
    other within LOGIT_TOL on windows at the same start; then in bf16 xRT
    (wall / audio s) of each, median [min, max] of STEADY_REPEATS rounds in
    turns, and the device ms by kernel class of one ``window_scores`` call
    of each and of its front-end alone (torch.profiler)."""
    from rtdsd_tpu_torch.data.io import load_audio
    from rtdsd_tpu_torch.engine.steps import make_score_step
    from rtdsd_tpu_torch.engine.streaming import (IncrementalStreamingScorer,
                                                  StreamingScorer, frame_windows)

    wave, _ = load_audio(long_path)
    audio_s = len(wave) / 16000
    kw = dict(duration=STREAM_WINDOW, hop=STREAM_HOP, batch_size=STREAM_BATCH)

    def scorers(model):
        return {"naive": StreamingScorer(make_score_step(model), device=dev, **kw),
                "incremental": IncrementalStreamingScorer(model, model.w2v_cfg, **kw)}

    model = build_model(sd, torch.float32, dev)
    sc = scorers(model)
    log(f"stream float32 (TF32 off), {audio_s:.2f} s, batch {STREAM_BATCH}: "
        f"kernels vs plain versions (tol {LOGIT_TOL})")
    f32 = stream_against_plain(sc, wave, LOGIT_TOL)
    ws = {k: v[0] for k, v in f32.items()}
    starts = {k: s.window_starts(len(wave)) for k, s in sc.items()}
    inc = dict(zip(starts["incremental"], ws["incremental"]))
    d = [abs(inc[s] - v) for s, v in zip(starts["naive"], ws["naive"]) if s in inc]
    log(f"stream float32 (TF32 off), {audio_s:.2f} s: {len(d)} windows at the "
        f"same start, naive vs incremental max|d| {max(d):.3g} (tol "
        f"{LOGIT_TOL}); |score| max {np.abs(ws['naive']).max():.3g}")
    if not np.all(np.isfinite(ws["naive"])) or max(d) > LOGIT_TOL:
        raise RuntimeError(f"float32 streaming scorers differ by {max(d)}")
    del model, sc

    model = build_model(sd, torch.bfloat16, dev)
    sc = scorers(model)
    log(f"stream bf16, {audio_s:.2f} s, batch {STREAM_BATCH}: kernels vs "
        f"plain versions")
    for k, (kern, plain) in stream_against_plain(sc, wave, None).items():
        log(f"  {k} bf16 vs float32 scores (information): with the kernels "
            f"max|d| {np.abs(kern - ws[k]).max():.3g}, with the plain "
            f"versions {np.abs(plain - ws[k]).max():.3g}")
    xrt = {k: [] for k in sc}
    for _ in range(STEADY_REPEATS):
        for k, s in sc.items():
            t0 = time.perf_counter()
            s.window_scores(wave)                # ends in the host readback
            xrt[k].append((time.perf_counter() - t0) / audio_s)
    log(f"stream bf16 xRT on {audio_s:.2f} s, median [min, max] of "
        f"{STEADY_REPEATS} rounds in turns: " + ", ".join(
            f"{k} {statistics.median(v):.5f} [{min(v):.5f}, {max(v):.5f}]"
            for k, v in xrt.items()))
    fe = model.ssl_model.model.feature_extractor
    windows = torch.from_numpy(frame_windows(wave, STREAM_WINDOW, STREAM_HOP)).to(dev)
    for k, fn, front in (
            ("naive", lambda: sc["naive"].window_scores(wave), lambda: fe(windows)),
            ("incremental", lambda: sc["incremental"].window_scores(wave),
             lambda: sc["incremental"].conv_features(wave))):
        rows, wall_ms = _profiled(fn)
        busy = sum(r[1] for r in rows)
        front_cls = by_class(_profiled(front)[0])
        front_ms = sum(ms for ms, _ in front_cls.values())
        log(f"stream profile, bf16 {k} window_scores on {audio_s:.2f} s: wall "
            f"{wall_ms:.2f} ms, kernels {busy:.2f} ms (device busy "
            f"{100 * busy / wall_ms:.1f}%), {sum(r[2] for r in rows)} launches; "
            f"its front-end alone {front_ms:.2f} ms of kernels "
            f"({100 * front_ms / busy:.1f}%): " + ", ".join(
                f"{cls} {ms:.3f} ms x{n}" for cls, (ms, n) in
                sorted(front_cls.items(), key=lambda kv: -kv[1][0])))
        for cls, (ms, n) in sorted(by_class(rows).items(), key=lambda kv: -kv[1][0]):
            log(f"  class {cls:22s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n}")


SERVE_WINDOW, SERVE_HOP = 16000, 8000       # 1 s windows, 0.5 s hop
SERVE_FRAMES = 49                           # conv frames of a 1 s window
SERVE_STREAMS = 32                          # files served through the CLI
SERVE_TIMED = (128, 512)                    # streams of the timed engines
SERVE_TICKS = 20
# the AASIST graphs at 49 frames (models/aasist.py): GAT_layer_S over the
# 42 spectral nodes, GAT_layer_T over 49 // 3 = 16 frames; the typed
# graphs after pooling by 0.5: 8 + 21 nodes (D 64, Do 32), then 4 + 10
# (D 32, Do 32); (N, D, Do, n1)
SERVE_GAT_NODES = (42, 16)
SERVE_HTRG_GRAPHS = ((29, 64, 32, 8), (14, 32, 32, 4))
SERVE_TOL = 1e-4                            # f32 engine vs direct scoring
# build_model's arguments for the screener of 4e
SCREENER_BUILD = {"name": "My_XLSR_AASIST", "layers": {
    k: SCREENER_KWARGS[k] for k in ("num_layers", "order", "custom_order")}}


def _serve_wave(rng, n: int, i: int) -> np.ndarray:
    """A 16 kHz test stream: a slowly modulated tone in noise; every third
    one has two seconds of exact silence from 2 s on (gated, and served by
    the zero-segment fastpath)."""
    t = np.arange(n) / 16000
    wave = (0.2 * np.sin(2 * np.pi * (200 + 10 * (i % 32)) * t)
            * (1 + np.sin(np.pi * t)) / 2 + 0.05 * rng.standard_normal(n))
    if i % 3 == 0:
        wave[32000:64000] = 0.0
    return wave.astype(np.float32)


def write_serve_audio(root: str) -> dict:
    """SERVE_STREAMS files of 6.0-9.9 s from seed 4 -> {path: wave as
    read back}."""
    from rtdsd_tpu_torch.data.io import load_audio, write_wav

    rng = np.random.default_rng(4)
    os.makedirs(root, exist_ok=True)
    waves = {}
    for i in range(SERVE_STREAMS):
        path = os.path.join(root, f"stream{i:02d}.wav")
        write_wav(path, _serve_wave(rng, 96000 + 2000 * i, i), 16000)
        waves[path] = load_audio(path)[0]
    return waves


def serve_starts(t: int) -> list:
    """Window starts of a flushed stream of t samples (close_stream's
    semantics): the hop grid, and a tail window snapped down to the
    320-sample grid where the grid does not reach the end."""
    last = (t - SERVE_WINDOW) // SERVE_HOP
    starts = [w * SERVE_HOP for w in range(last + 1)]
    tail = (t - SERVE_WINDOW) - (t - SERVE_WINDOW) % 320
    return starts + ([tail] if tail > starts[-1] else [])


def dispatch_sums(eng) -> dict:
    """Score and escalate dispatches (rungs included) a run made."""
    return {f: sum(v for k, v in eng.dispatch_counts.items()
                   if k == f or k.startswith(f + "_"))
            for f in ("score", "escalate")}


def warm_dispatches(eng) -> dict:
    """The dispatches ``eng.warmup()`` made, by family: each configured
    shape once (``extend_const`` runs no conv), and under the zero-segment
    fastpath the extend that derives the conv(0) rows. Read right after
    the warm-up, before the adaptive provisioning adds rungs."""
    n = {"extend": int(eng._fastpath), "score": 0, "escalate": 0}
    for name, _rows, _dispatch in eng._shapes():
        if name != "extend_const":
            n[name.split("_")[0]] += 1
    return n


def serve_gelu(eng, warm: dict, layers: int, esc_layers: int = 0) -> int:
    """gelu_fast launches of a served run: the front-end's a conv extend,
    the positional conv's and the layers' a score dispatch, a whole
    forward of the flagship an escalation; the warm-up's (``warm``) and a
    conv(0) rows' extend again after a weight swap included."""
    extends = sum(v for k, v in eng.dispatch_counts.items()
                  if k.split("_")[0] == "extend" and k != "extend_const")
    extends += int(eng.model_swaps > 0 and eng._const_rows is not None)
    n = dispatch_sums(eng)
    return (FRONTEND_GELU * (warm["extend"] + extends)
            + (1 + layers) * (warm["score"] + n["score"])
            + w2v_gelu(esc_layers) * (warm["escalate"] + n["escalate"]))


def run_serve(cfg: str, ckpt: str, waves: dict, tag: str, extra=(),
              source=None) -> dict:
    """Serve the files through ``rtdsd_tpu_torch.cli.serve`` (1 s windows,
    0.5 s hop, ``--per_window --out``) with every launch counter zeroed
    just before -> launches, the engine, the window lines, the stderr
    lines and the wall; ``source`` (``["--artifact", prefix]``) serves a
    bundle, whose geometry is baked, in place of ``cfg`` and ``ckpt``.
    Every file's windows must sit at serve_starts with finite scores, and
    its aggregate be finite, on stdout and in --out."""
    from rtdsd_tpu_torch.cli import serve as cli

    out = os.path.join(WORK, "serve", f"{tag}.txt")
    paths = list(waves)
    engines, build, warm = [], cli.build_engine, []

    def capture(args, n):
        eng, sr = build(args, n)
        engines.append(eng)
        warm.append(warm_dispatches(eng))
        return eng, sr

    buf, err = io.StringIO(), io.StringIO()
    cli.build_engine = capture
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_counters()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            head = source or ["--config", cfg, "--ckpt", ckpt,
                              "--window_sec", str(SERVE_WINDOW / 16000),
                              "--hop_sec", str(SERVE_HOP / 16000)]
            cli.main([*head, "--audio", *paths, "--per_window", "--out", out,
                      *extra])
        torch.cuda.synchronize()
    finally:
        cli.build_engine = build
    wall = time.perf_counter() - t0
    launches = read_counters()
    with open(os.path.join(WORK, "serve", f"{tag}.stdout"), "w") as f:
        f.write(buf.getvalue())
    windows, files = {p: [] for p in paths}, {}
    for line in buf.getvalue().splitlines():
        head, *rest = line.split(" ")
        path = head.split("#")[0]
        if path not in windows:
            continue
        if "#" in head:
            windows[path].append((round(float(rest[0]) * 16000), float(rest[1]),
                                  rest[2:]))
        else:
            files[path] = float(rest[0])
    for path, wave in waves.items():
        got = sorted(w[0] for w in windows[path])
        if got != serve_starts(len(wave)):
            raise RuntimeError(f"serve {tag}: {path} windows at {got}")
        if not (all(np.isfinite(w[1]) for w in windows[path])
                and np.isfinite(files.get(path, np.nan))):
            raise RuntimeError(f"serve {tag}: {path} has a score that is "
                               f"not finite")
    with open(out) as f:
        if [l.split(" ")[0] for l in f.read().splitlines()] != paths:
            raise RuntimeError(f"serve {tag}: --out lists other files")
    return dict(launches=launches, eng=engines[0], warm=warm[0],
                windows=windows, err=err.getvalue().splitlines(), wall=wall)


def serve_path(ckpt: str, screener_ckpt: str, sd: dict, screener_sd: dict,
               dev) -> dict:
    """4h through the CLI: (a) the XLSR_AASIST of 4a in bf16 with
    ``--gate_db -50``, (b) a cascade, the 6-layer screener of 4e primary
    and that XLSR_AASIST escalating over a band around the screener's
    median score that holds about half of its scores, (c) ``--w8a8``.
    Launches exactly: attention (24 or 6 a dispatch) and GAT (2 + 4 an
    AASIST dispatch) over the score and escalate dispatches, the warm-up's
    one of each included; 144 ``quantize_int8`` under ``--w8a8``; no
    convstack launch. -> (launches summed over the three runs, {path:
    wave})."""
    waves = write_serve_audio(os.path.join(WORK, "serve"))
    cfg = write_config(WORK, "bfloat16")
    cfg_s = write_config(WORK, "bfloat16", "My_XLSR_AASIST", SCREENER_KWARGS,
                         name="screener")
    # the band: the screener's bf16 scores of each file's first window
    screener = build_model(screener_sd, torch.bfloat16, dev, **SCREENER_BUILD)
    with torch.inference_mode():
        first = torch.from_numpy(np.stack([w[:SERVE_WINDOW]
                                           for w in waves.values()])).to(dev)
        s = screener(first)[:, 1].float().cpu().numpy()
    del screener
    center = float(np.median(s))
    band = float(np.median(np.abs(s - center)))
    total = {}
    # (tag, flags, layers of the primary and of the flagship); in the
    # cascade --ckpt is the flagship and --config its config
    for tag, extra, layers in (
            ("bf16_gate", ["--gate_db", "-50"], (24, 0)),
            ("cascade", ["--cascade_ckpt", screener_ckpt, "--cascade_config",
                         cfg_s, "--cascade_band", repr(band),
                         "--cascade_center", repr(center)], (6, 24)),
            ("w8a8", ["--w8a8"], (24, 0))):
        r = run_serve(cfg, ckpt, waves, tag, extra)
        eng, n = r["eng"], dispatch_sums(r["eng"])
        score, esc = n["score"] + 1, (n["escalate"] + 1 if layers[1] else 0)
        want = launches_want(layers[0] * score + layers[1] * esc, score + esc,
                             144 if tag == "w8a8" else 0,
                             serve_gelu(eng, r["warm"], *layers))
        marks = [m for ws in r["windows"].values() for w in ws for m in w[2]]
        n_win = sum(map(len, r["windows"].values()))
        tick = next(l for l in r["err"] if "tick p50" in l)
        log(f"serve {tag}: {n_win} windows of {SERVE_STREAMS} streams, "
            f"{marks.count('gated')} gated, {marks.count('escalated')} "
            f"escalated; dispatches {eng.dispatch_counts} (+1 score"
            f"{' and 1 escalate' if layers[1] else ''} warm-up); launches "
            f"{r['launches']} (want {want}); zero segments "
            f"{eng.zero_segments}; {tick.strip()}; CLI wall {r['wall']:.2f} s "
            f"incl. model build, load{' and quantization' if tag == 'w8a8' else ''}")
        if r["launches"] != want:
            raise RuntimeError(f"kernel launches {r['launches']} != {want}")
        if tag == "bf16_gate" and not (marks.count("gated") and eng.zero_segments):
            raise RuntimeError("the gate or the zero-segment fastpath did not engage")
        if tag == "cascade" and not 0 < marks.count("escalated") < n_win:
            raise RuntimeError(f"cascade escalated {marks.count('escalated')} "
                               f"of {n_win} windows (band {band} around {center})")
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total, waves, (center, band)


def serve_all(eng, waves: list) -> list:
    """Push every stream one hop a tick, polling each tick; then flush and
    drain -> [(stream index, start sample, score, escalated)]."""
    out = []
    handles = [eng.open_stream(i) for i in range(len(waves))]
    for c in range(0, max(map(len, waves)), SERVE_HOP):
        for h, w in zip(handles, waves):
            if c < len(w):
                eng.push(h, w[c:c + SERVE_HOP])
        out += eng.poll()
    for h in handles:
        eng.close_stream(h, flush=True)
    out += eng.drain()
    return [(w.stream_id, w.start_sample, w.score, w.escalated) for w in out]


def serve_direct(model, waves: list, res: list) -> np.ndarray:
    """The engine's own oracle: each served window cut from its raw wave
    and scored through the wave entry (make_score_step), in the engine's
    order."""
    from rtdsd_tpu_torch.engine.steps import make_score_step

    step = make_score_step(model)
    cuts = np.stack([waves[i][s:s + SERVE_WINDOW] for i, s, _, _ in res])
    return np.concatenate([step(torch.from_numpy(cuts[j:j + SERVE_STREAMS]).to(
        next(model.parameters()).device)).float().cpu().numpy()
        for j in range(0, len(cuts), SERVE_STREAMS)])


def log_held(what: str, worst: dict, bf16: bool = False) -> None:
    """Log the held calls; every kernel of the forward must be among them
    (``gelu_fast`` only in bf16: float32 takes the exact erf)."""
    log(f"  {what}: every kernel call against its plain version on the same "
        "inputs: " + "; ".join(f"{n} {c} calls at {sorted(shapes)}, max|d| "
                               f"{e:.3g}" for n, (c, e, shapes) in worst.items()))
    want = {"mha_small_t", "fused_gat_aggregate", "fused_htrg_gat_aggregate"}
    if set(worst) != (want | {"gelu_fast"} if bf16 else want):
        raise RuntimeError(f"{what}: kernels held {sorted(worst)}")


def serve_device(sd: dict, screener_sd: dict, dev, files: dict) -> None:
    """4h outside the CLI. float32 (TF32 off) at SERVE_STREAMS streams:
    the engine's window scores against direct scoring of the same windows
    (SERVE_TOL), with every kernel call held to its plain version; the
    same pushes with the zero-segment fastpath off (max |d| printed, held
    to SERVE_TOL: cuDNN may pick another algorithm at another batch); a
    cascade (the screener and the flagship, every window escalated, on 8
    streams) held to the plain versions in float32 and bf16. bf16 at
    SERVE_TIMED streams: the first tick held to the plain versions, then
    SERVE_TICKS ticks paced to the hop, device_costs, device ms per tick
    and busy share, one tick's kernels by class, the memory estimate and
    the peak allocated."""
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer

    waves = list(files.values())

    def engine(model, n, **kw):
        return MultiStreamScorer(model, model.w2v_cfg, duration=SERVE_WINDOW,
                                 hop=SERVE_HOP, max_streams=n, **kw)

    model = build_model(sd, torch.float32, dev)
    worst = {}
    with kernels_held_to_plain(worst):
        res = serve_all(engine(model, SERVE_STREAMS), waves)
    direct = serve_direct(model, waves, res)
    d = np.abs(np.array([r[2] for r in res]) - direct)
    log(f"serve float32 (TF32 off), {SERVE_STREAMS} streams: {len(res)} "
        f"windows, engine vs direct scoring max|d| {d.max():.3g} (tol "
        f"{SERVE_TOL}); |score| max {np.abs(direct).max():.3g}")
    log_held("serve float32", worst)
    if not np.all(np.isfinite(direct)) or d.max() > SERVE_TOL:
        raise RuntimeError(f"served scores differ from direct scoring by {d.max()}")
    plain_eng = engine(model, SERVE_STREAMS, extend_fastpath=False)
    slow = serve_all(plain_eng, waves)
    fast_eng = engine(model, SERVE_STREAMS)
    fast = serve_all(fast_eng, waves)
    d = max(abs(a[2] - b[2]) for a, b in zip(fast, slow))
    log(f"serve float32 zero-segment fastpath on vs off: {len(fast)} windows, "
        f"{fast_eng.zero_segments} zero segments, max|d| {d:.3g} (tol "
        f"{SERVE_TOL}; bit for bit on the CPU)")
    if [a[:2] for a in fast] != [b[:2] for b in slow] or d > SERVE_TOL \
            or not fast_eng.zero_segments:
        raise RuntimeError(f"fastpath scores differ by {d}")
    bf16 = build_model(sd, torch.bfloat16, dev)
    for kind, flagship in (("float32", model), ("bf16", bf16)):
        screener = build_model(screener_sd, flagship.ssl_model.model.dtype,
                               dev, **SCREENER_BUILD)
        worst = {}
        with kernels_held_to_plain(worst):
            res = serve_all(engine(screener, 8, escalate=flagship,
                                   escalate_band=1e9), waves[:8])
        log_held(f"serve cascade {kind}, 8 streams, {len(res)} windows "
                 f"escalated", worst, bf16=kind == "bf16")
        if not all(r[3] for r in res) or not np.all(np.isfinite([r[2] for r in res])):
            raise RuntimeError("cascade windows not escalated or not finite")
        del screener
    del model, plain_eng, fast_eng
    serve_timed(bf16)
    return bf16


def dispatch_peaks(eng) -> dict:
    """{dispatch shape: bytes the allocator's peak rose above what was
    allocated just before one dispatch of that shape on scratch rows}."""
    out = {}
    for name, _rows, dispatch in eng._shapes():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        dispatch()
        torch.cuda.synchronize()
        out[name] = torch.cuda.max_memory_allocated() - base
    return out


def serve_timed(model) -> None:
    """bf16 at each of SERVE_TIMED streams: one second pushed per stream,
    a first tick held to the plain versions, then SERVE_TICKS ticks paced
    to the hop, each pushing a hop per stream and polling once."""
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer, dispatch_detail_keys

    hop_ms = SERVE_HOP / 16
    model_bytes = sum(t.numel() * t.element_size()
                      for t in model.state_dict().values())
    rng = np.random.default_rng(5)
    n = SERVE_WINDOW + (SERVE_TICKS + 4) * SERVE_HOP
    bank = [_serve_wave(rng, n, i) for i in range(32)]
    for streams in SERVE_TIMED:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        eng = MultiStreamScorer(model, model.w2v_cfg, duration=SERVE_WINDOW,
                                hop=SERVE_HOP, max_streams=streams)
        eng.warmup()
        hs = [eng.open_stream(i) for i in range(streams)]
        waves = [np.roll(bank[i % 32], 800 * i) for i in range(streams)]
        pos = [0]

        def tick():
            c = pos[0]
            for h, w in zip(hs, waves):
                eng.push(h, w[c:c + SERVE_HOP])
            pos[0] = c + SERVE_HOP
            return eng.poll()

        tick(), tick()                      # one second of audio
        worst = {}
        with kernels_held_to_plain(worst):
            first = tick()
        log_held(f"serve bf16, {streams} streams, one tick ({len(first)} "
                 f"windows)", worst, bf16=True)
        counts0 = dict(eng.dispatch_counts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ticks, start = [], time.perf_counter()
        for k in range(SERVE_TICKS):
            t0 = time.perf_counter()
            got = tick()
            ticks.append((time.perf_counter() - t0) * 1e3)
            if len(got) != streams or not np.all(np.isfinite([w.score for w in got])):
                raise RuntimeError(f"tick {k}: {len(got)} windows of {streams}")
            rest = start + (k + 1) * hop_ms / 1e3 - time.perf_counter()
            if rest > 0:
                time.sleep(rest)
        elapsed = (time.perf_counter() - start) * 1e3
        peak = torch.cuda.max_memory_allocated()
        per_tick = {k: (v - counts0[k]) / SERVE_TICKS
                    for k, v in eng.dispatch_counts.items()}
        peaks = dispatch_peaks(eng)
        costs = eng.device_costs(n=5)
        dev_ms = sum(costs.get(k, 0.0) * v for k, v in per_tick.items())
        rows, wall_ms = _profiled(tick)
        busy = sum(r[1] for r in rows)
        log(f"serve bf16, {streams} streams, {SERVE_TICKS} ticks paced to the "
            f"{hop_ms:.0f} ms hop: tick p50 {np.percentile(ticks, 50):.2f} ms / "
            f"p95 {np.percentile(ticks, 95):.2f} ms (max {max(ticks):.2f}); "
            f"device_costs " + " ".join(
                f"{k}:{costs[k]:.3f}ms" for k in dispatch_detail_keys(costs))
            + f"; dispatches per tick " + " ".join(
                f"{k}:{v:g}" for k, v in per_tick.items() if v)
            + f"; device {dev_ms:.2f} ms/tick, busy {100 * dev_ms * SERVE_TICKS / elapsed:.1f}% "
            f"of the paced run's {elapsed:.0f} ms and "
            f"{100 * dev_ms / np.mean(ticks):.1f}% of the mean tick; "
            f"memory: {base / 2**30:.2f} GiB allocated before the engine, "
            f"max_memory_allocated over the paced ticks {peak / 2**30:.2f} GiB "
            f"({(peak - base) / 2**30:.2f} above that), hbm_estimate "
            f"{eng.hbm_estimate / 2**30:.2f} GiB (the model's parameters and "
            f"buffers {model_bytes / 2**30:.2f} GiB of it)")
        log(f"  memory guard: hbm_estimate {eng.hbm_estimate / 2**30:.3f} GiB = "
            f"JAX's formula {eng.hbm_estimate_jax / 2**30:.3f} + the eager term "
            f"{eng.hbm_estimate_eager / 2**30:.3f}; estimate / peak "
            f"{eng.hbm_estimate / peak:.3f}; the limit the engine read "
            f"{eng.hbm_limit / 2**30:.2f} GiB (free + reserved); one dispatch's "
            f"peak above what was allocated before it, per row: " + " ".join(
                f"{k} {v / eng.rung_rows[k] / 2**20:.2f} MiB"
                for k, v in peaks.items() if v))
        if eng.hbm_estimate < peak:
            raise RuntimeError(f"hbm_estimate {eng.hbm_estimate} is below the "
                               f"peak allocated {peak} at {streams} streams")
        log(f"  one profiled tick: wall {wall_ms:.2f} ms, kernels {busy:.2f} ms "
            f"(device busy {100 * busy / wall_ms:.1f}%), "
            f"{sum(r[2] for r in rows)} launches")
        for cls, (ms, cnt) in sorted(by_class(rows).items(), key=lambda kv: -kv[1][0]):
            log(f"  class {cls:22s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{cnt}")
        del eng, hs


# ------------------------------------------------------------ phase 4i

DAEMON_STREAMS = 512                        # 4i (c), as 4h's largest engine
DAEMON_CONNS = 4                            # connections of 4i (c)'s client
DAEMON_HOPS = 20
RF_TAIL = 80                                # receptive field beyond a frame


def _sock_path(name: str) -> str:
    """A socket path under WORK, relative where the absolute one would
    pass the 107 bytes AF_UNIX takes."""
    path = os.path.join(WORK, "daemon", name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.unlink(path)
    return path if len(path) < 100 else os.path.relpath(path)


class DaemonThread:
    """A ServeDaemon of the port on its own asyncio loop in a background
    thread, on a Unix socket."""

    def __init__(self, eng, sock: str, **kw):
        import asyncio
        import threading

        from rtdsd_tpu_torch.engine.netserve import ServeDaemon

        self.daemon = ServeDaemon(eng, 16000, **kw)
        self.loop = asyncio.new_event_loop()
        started, self.errors = threading.Event(), []

        def run():
            asyncio.set_event_loop(self.loop)
            try:
                self.loop.run_until_complete(self.daemon.start(unix_path=sock))
            except Exception as e:      # re-raised by __init__
                self.errors.append(e)
                return
            finally:
                started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        started.wait(60)
        if self.errors:
            raise self.errors[0]

    def stop(self) -> None:
        import asyncio

        try:
            asyncio.run_coroutine_threadsafe(self.daemon.stop(),
                                             self.loop).result(60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)
            self.loop.close()


def _check_daemon_windows(what: str, got: dict, lengths: dict) -> None:
    """Every stream's windows at serve_starts, each once, scores finite."""
    for key, n in lengths.items():
        starts = sorted(w[0] for w in got.get(key, []))
        if starts != serve_starts(n):
            raise RuntimeError(f"{what}: {key} windows at {starts}, want "
                               f"{serve_starts(n)}")
        if not all(np.isfinite(w[1]) for w in got[key]):
            raise RuntimeError(f"{what}: {key} has a score that is not finite")


def daemon_parity(sd: dict, dev, files: dict) -> None:
    """4i (a): an in-process daemon serving the float32 XLSR_AASIST (TF32
    off) over int16 to 8 of 4h's files, four through the port's
    ServeClient and four through its NativeServeClient, every kernel call
    held to its plain version; each window once at serve_starts, within
    SERVE_TOL of direct scoring of the int16-quantized window, and every
    handle CLOSED."""
    from rtdsd_tpu_torch.engine.netserve import ServeClient
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer
    from rtdsd_tpu_torch.native import client as native

    t0 = time.perf_counter()
    native.build()
    model = build_model(sd, torch.float32, dev)
    eng = MultiStreamScorer(model, model.w2v_cfg, duration=SERVE_WINDOW,
                            hop=SERVE_HOP, max_streams=8,
                            transport_dtype="int16")
    eng.warmup()
    waves = [np.clip(np.rint(w * 32768.0), -32768, 32767) / 32768.0
             for w in list(files.values())[:8]]
    sock = _sock_path("parity.sock")
    served = DaemonThread(eng, sock, tick_sec=0.05)
    worst, got, closed = {}, {}, set()
    try:
        with kernels_held_to_plain(worst):
            clients = [ServeClient(unix_path=sock),
                       native.NativeServeClient(unix_path=sock)]
            owner = {}
            for i, w in enumerate(waves):
                cli = clients[i % 2]
                h = cli.open(f"file{i}")
                owner[h] = i
                for c in range(0, len(w), SERVE_HOP):
                    cli.push(h, w[c:c + SERVE_HOP].astype(np.float32))
                cli.close(h, flush=True)
            for cli in clients:
                mine = {h for h in owner if owner[h] % 2 == clients.index(cli)}
                for h, ws in cli.collect(mine).items():
                    got[owner[h]] = ws
                    closed.add(h)
                cli.close_socket()
    finally:
        served.stop()
    _check_daemon_windows("daemon parity", got,
                          {i: len(w) for i, w in enumerate(waves)})
    if len(closed) != len(waves):
        raise RuntimeError(f"daemon parity: {len(closed)} handles CLOSED of "
                           f"{len(waves)}")
    res = [(i, s, v, False) for i in sorted(got) for s, v, _ in sorted(got[i])]
    direct = serve_direct(model, [w.astype(np.float32) for w in waves], res)
    d = np.abs(np.array([r[2] for r in res]) - direct)
    log(f"daemon float32 (TF32 off), 8 streams over a Unix socket (4 Python, "
        f"4 native clients, int16): {len(res)} windows once each at "
        f"serve_starts, all 8 CLOSED; wire vs direct scoring of the "
        f"int16-quantized windows max|d| {d.max():.3g} (tol {SERVE_TOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    log_held("daemon float32", worst)
    if not np.all(np.isfinite(direct)) or d.max() > SERVE_TOL:
        raise RuntimeError(f"wire scores differ from direct scoring by {d.max()}")


def daemon_cli(ckpt: str, files: dict) -> dict:
    """4i (b): ``rtdsd_tpu_torch.cli.daemon.main`` in this (main) thread in
    bf16, 1 s windows, 0.5 s hop, 32 slots, stats every second, on a Unix
    socket; the 32 files of 4h streamed by the port's feeder binary with
    ``--realtime``; mid-run the --ckpt file is replaced by seed-2 weights
    and this process sends itself SIGHUP, then SIGTERM once the feeders are
    done. Launches exactly (24, 2, 4) x the score dispatches (the warm-up's
    included) -> (launches, peak bytes allocated during the reload)."""
    import signal
    import threading

    from rtdsd_tpu_torch.cli import daemon as cli
    from rtdsd_tpu_torch.models.registry import get_model
    from rtdsd_tpu_torch.native import client as native

    feed = native.build_feeder()
    root = os.path.join(WORK, "daemon")
    model_pt, seed2 = os.path.join(root, "model.pt"), os.path.join(root, "seed2.pt")
    with open(ckpt, "rb") as src, open(model_pt, "wb") as dst:
        dst.write(src.read())
    torch.save(random_reference_state_dict(get_model("XLSR_AASIST").module,
                                           seed=2), seed2)
    sock = _sock_path("cli.sock")
    err_path = os.path.join(root, "daemon_cli.stderr")
    engines, build = [], cli.build_engine
    state = {"errors": [], "outs": {}, "reload_peak": None,
             "serve_peak": None}

    def capture(args, n):
        eng, sr = build(args, n)
        engines.append((eng, warm_dispatches(eng)))
        return eng, sr

    def stderr_text():
        with open(err_path) as f:
            return f.read()

    def wait_for(cond, what, timeout):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise RuntimeError(f"daemon CLI: {what}")
            time.sleep(0.05)

    def drive():
        procs = {}
        try:
            wait_for(lambda: os.path.exists(sock), "no socket", 300)
            torch.cuda.reset_peak_memory_stats()
            procs = {p: subprocess.Popen([feed, f"unix:{sock}", p, "--realtime"],
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE, text=True)
                     for p in files}
            time.sleep(4.0)
            state["serve_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            os.replace(seed2, model_pt)
            os.kill(os.getpid(), signal.SIGHUP)
            wait_for(lambda: "reloaded" in stderr_text(), "no reload line", 120)
            state["reload_peak"] = torch.cuda.max_memory_allocated()
            for p, proc in procs.items():
                out, err = proc.communicate(timeout=120)
                if proc.returncode:
                    raise RuntimeError(f"feeder {p}: rc {proc.returncode}: {err}")
                state["outs"][p] = out
            n = stderr_text().count("] streams=")
            wait_for(lambda: stderr_text().count("] streams=") > n + 1,
                     "no stats line after the feeders", 30)
        except Exception as e:      # raised by daemon_cli after the stop
            state["errors"].append(e)
            for proc in procs.values():
                proc.kill()
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    cli.build_engine = capture
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    reset_counters()
    t0 = time.perf_counter()
    helper = threading.Thread(target=drive, daemon=True)
    try:
        with open(err_path, "w") as err, contextlib.redirect_stderr(err):
            helper.start()
            cli.main(["--config", write_config(WORK, "bfloat16"), "--ckpt",
                      model_pt, "--window_sec", str(SERVE_WINDOW / 16000),
                      "--hop_sec", str(SERVE_HOP / 16000), "--max_streams",
                      str(SERVE_STREAMS), "--stats_every", "1", "--listen",
                      f"unix:{sock}"])
    finally:
        cli.build_engine = build
        helper.join(60)
    launches = read_counters()
    wall = time.perf_counter() - t0
    text = stderr_text()
    if state["errors"] or "Traceback" in text:
        log(f"daemon CLI stderr, its end:\n{text[-6000:]}")
    if state["errors"]:
        raise state["errors"][0]
    stats = [l for l in text.splitlines() if "] streams=" in l]
    eng, warm = engines[0]
    score = dispatch_sums(eng)["score"] + 1
    want = launches_want(24 * score, score, gelu=serve_gelu(eng, warm, 24))
    got = {}
    for p, out in state["outs"].items():
        lines = out.splitlines()
        got[p] = [(int(l.split()[1][1:]), float(l.split()[3]))
                  for l in lines if l.startswith("window @")]
        if lines[-1].split()[0] != p or not np.isfinite(float(lines[-1].split()[1])):
            raise RuntimeError(f"daemon CLI: feeder of {p} ended with {lines[-1]!r}")
    _check_daemon_windows("daemon CLI", got, {p: len(w) for p, w in files.items()})
    last = stats[-1] if stats else ""
    log(f"daemon CLI bf16, {len(files)} feeders --realtime: "
        f"{sum(map(len, got.values()))} windows once each, finite; "
        f"dispatches {eng.dispatch_counts} (+1 score warm-up); launches "
        f"{launches} (want {want}); {len(stats)} stats lines, the last: "
        f"{last.split('provisioning=')[0].strip()}; wall {wall:.1f} s incl. "
        f"model build, load and the reload")
    log("  " + next(l for l in text.splitlines() if "serving on" in l))
    log("  " + next(l for l in text.splitlines() if "reloaded" in l))
    log(f"  memory: {base / 2**30:.3f} GiB allocated before the daemon "
        f"started; max_memory_allocated serving before the reload "
        f"{state['serve_peak'] / 2**30:.3f} GiB, during the reload (ticks "
        f"going on) {state['reload_peak'] / 2**30:.3f} GiB, the reload "
        f"{(state['reload_peak'] - state['serve_peak']) / 2**30:.3f} GiB "
        f"above serving; the daemon's hbm_estimate "
        f"{eng.hbm_estimate / 2**30:.3f} GiB (the reload's second copy is "
        f"not in it)")
    if "reloads=1 " not in last or "overruns=0 " not in last \
            or "idle_sheds=0 " not in last:
        raise RuntimeError(f"daemon CLI: last stats line {last!r}")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    return launches, state["reload_peak"]


CAPACITY_CLIENT = r"""
import json, sys, threading, time
import numpy as np
from rtdsd_tpu_torch.engine.netserve import ServeClient

sock, streams, conns, hops, out = sys.argv[1:6]
streams, conns, hops = int(streams), int(conns), int(hops)
HOP, DUR, TAIL = 8000, 16000, 80
rng = np.random.default_rng(6)
bank = [(rng.standard_normal((2 + hops) * HOP) * 0.1).astype(np.float32)
        for _ in range(32)]
clients = [ServeClient(unix_path=sock) for _ in range(conns)]
handles = [[c.open(f"c{i}s{j}") for j in range(streams // conns)]
           for i, c in enumerate(clients)]
push_t = {h: [] for hs in handles for h in hs}
recv, errors = {h: [] for h in push_t}, []

def reader(cli, hs):
    try:
        pending = set(hs)
        for ev in cli.events():
            if ev[0] == "score":
                recv[ev[1]].append((ev[2], ev[3], time.monotonic()))
            elif ev[0] == "closed":
                pending.discard(ev[1])
                if not pending:
                    return
    except Exception as e:
        errors.append(repr(e))

def pusher(cli, hs, t0):
    try:
        for k in range(hops + 1):
            time.sleep(max(0.0, t0 + 0.5 * k - time.monotonic()))
            lo, hi = (0, 2 * HOP) if k == 0 else ((k + 1) * HOP, (k + 2) * HOP)
            for h in hs:
                cli.push(h, bank[h % 32][lo:hi])
                push_t[h].append(time.monotonic())
        for h in hs:
            cli.close(h, flush=True)
    except Exception as e:
        errors.append(repr(e))

t0 = time.monotonic() + 0.5
readers = [threading.Thread(target=reader, args=(c, hs)) for c, hs in zip(clients, handles)]
pushers = [threading.Thread(target=pusher, args=(c, hs, t0)) for c, hs in zip(clients, handles)]
for t in readers + pushers:
    t.start()
for t in pushers + readers:
    t.join(120)
lat = []
for h, evs in recv.items():
    for start, score, t in evs:
        last = start + DUR + TAIL - 1
        k = 0 if last < 2 * HOP else 1 + (last - 2 * HOP) // HOP
        if k <= hops:
            lat.append((k, (t - push_t[h][k]) * 1e3))
json.dump({"windows": {str(h): [e[:2] for e in evs] for h, evs in recv.items()},
           "latency_ms": lat, "errors": errors,
           "alive": sum(t.is_alive() for t in readers + pushers)}, open(out, "w"))
"""


def daemon_capacity(model, reload_peak) -> None:
    """4i (c): an in-process daemon on the bf16 model at DAEMON_STREAMS
    streams; a child process (its own interpreter, so that it does not
    share the daemon's GIL) runs the port's ServeClient over DAEMON_CONNS
    connections, prefills 1 s per stream, then pushes a hop per stream
    every 500 ms for DAEMON_HOPS hops, and closes. Printed: the per-window
    score latency from the push that completed a window (its last sample
    and the 80-sample receptive-field tail) to its SCORE frame, the tick
    wall, overruns, the memory peak beside hbm_estimate. Missing,
    duplicated or non-finite windows and overruns raise; the latencies are
    information."""
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer

    eng = MultiStreamScorer(model, model.w2v_cfg, duration=SERVE_WINDOW,
                            hop=SERVE_HOP, max_streams=DAEMON_STREAMS,
                            transport_dtype="int16")
    eng.warmup()
    ticks, poll = [], eng.poll

    def timed_poll():
        t = time.perf_counter()
        out = poll()
        torch.cuda.synchronize()
        if out:                     # a tick that scored windows
            ticks.append((time.perf_counter() - t) * 1e3)
        return out

    eng.poll = timed_poll
    sock = _sock_path("capacity.sock")
    out = os.path.join(WORK, "daemon", "capacity.json")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served = DaemonThread(eng, sock)
    try:
        child = subprocess.run(
            [sys.executable, "-c", CAPACITY_CLIENT, sock, str(DAEMON_STREAMS),
             str(DAEMON_CONNS), str(DAEMON_HOPS), out],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
    finally:
        served.stop()
    peak = torch.cuda.max_memory_allocated()
    if child.returncode:
        raise RuntimeError(f"capacity client rc {child.returncode}: "
                           f"{child.stderr[-2000:]}")
    with open(out) as f:
        res = json.load(f)
    if res["errors"] or res["alive"]:
        raise RuntimeError(f"capacity client: {res['errors']}, "
                           f"{res['alive']} threads left")
    n = (2 + DAEMON_HOPS) * SERVE_HOP
    _check_daemon_windows("daemon capacity", res["windows"],
                          {h: n for h in res["windows"]})
    d = served.daemon
    hop_of, lat = np.asarray(res["latency_ms"]).T
    worst = [int(k) for k in sorted(set(hop_of[lat > 1000]))]
    log(f"daemon bf16, {DAEMON_STREAMS} streams over {DAEMON_CONNS} Unix "
        f"connections from a child process, 1 s prefill then a hop per "
        f"stream every {SERVE_HOP / 16:.0f} ms for {DAEMON_HOPS} hops: "
        f"{sum(map(len, res['windows'].values()))} windows once each, "
        f"finite; score latency from the completing push to the SCORE frame "
        f"p50 {np.percentile(lat, 50):.1f} ms / p95 "
        f"{np.percentile(lat, 95):.1f} ms (p99 {np.percentile(lat, 99):.1f}, "
        f"max {lat.max():.1f}; {len(lat)} windows, {(lat > 1000).sum()} over "
        f"1 s, completed by push rounds {worst}; from round 3 on p50 "
        f"{np.percentile(lat[hop_of >= 3], 50):.1f} / p95 "
        f"{np.percentile(lat[hop_of >= 3], 95):.1f} ms); tick wall p50 {np.percentile(ticks, 50):.2f} ms "
        f"/ p95 {np.percentile(ticks, 95):.2f} ms over {len(ticks)} ticks; "
        f"overruns {d.overruns}, idle sheds {d.idle_sheds}; "
        f"max_memory_allocated {peak / 2**30:.3f} GiB, hbm_estimate "
        f"{eng.hbm_estimate / 2**30:.3f} GiB (JAX's formula "
        f"{eng.hbm_estimate_jax / 2**30:.3f} + eager "
        f"{eng.hbm_estimate_eager / 2**30:.3f}); a reload's peak in (b) "
        f"{reload_peak / 2**30:.3f} GiB at {SERVE_STREAMS} streams")
    if d.overruns:
        raise RuntimeError(f"daemon capacity: {d.overruns} overruns")


# ------------------------------------------------------------ phase 4j

TRAIN_CLIPS, DEV_CLIPS, TRAIN_BATCH = 64, 32, 32
TRAIN_LR = 1e-6                     # configs/xlsr_aasist.yaml
TRAIN_SEED = 1024
PARITY_BATCH = 4                    # the float32 kernels-vs-plain step
# float32 train step, kernels vs plain versions: the attention kernel and
# the einsum sum in other orders (phase 3: 1e-6 relative)
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3               # of each tensor's max |g|
# a gradient whose max is at most this share of the largest gradient's is
# zero in exact arithmetic (a bias feeding a batch-statistics BatchNorm or
# constant along a softmax's axis): held under it, as the CPU test holds it
TRAIN_ZERO_TOL = 1e-6
TRAIN_STATS_TOL = 1e-4
# Adam's first step moves a parameter by under lr either way, so a gradient
# near zero may flip it: 2 lr, plus float32 rounding of parameters up to 8.
# This bound shows that lr and the decay were applied; the moments are the
# parity check of the optimizer
PARAM_TOL = 2 * TRAIN_LR + 1e-6
# the gated float32 step runs on the first PARITY_LAYERS transformer layers
# of the same weights at full width (the registry's My_XLSR_AASIST): at 24
# layers float32 leaves hundreds of the random-weight model's gradients
# undetermined to 1e-3 for any attention (the math SDPA's step misses the
# plain step there as the kernels' does), which the full-depth step prints
PARITY_LAYERS = 4
TRAIN_STEPS_TIMED = 5


def write_train_set(root: str) -> None:
    """64 train and 32 dev four-second clips (sine bonafide, noise spoof,
    from seed 3) with ASVspoof 2019 LA protocols under ``root``."""
    from rtdsd_tpu_torch.data.io import write_wav

    rng = np.random.default_rng(3)
    os.makedirs(os.path.join(root, "audio"), exist_ok=True)
    for prefix, n in (("LA_T", TRAIN_CLIPS), ("LA_D", DEV_CLIPS)):
        lines = []
        for i in range(n):
            t = np.arange(SAMPLES) / 16000
            bona = i % 2 == 1
            wave = (0.3 * np.sin(2 * np.pi * (200 + 15 * i) * t) if bona
                    else 0.2 * rng.standard_normal(SAMPLES)).astype(np.float32)
            uid = f"{prefix}_{i:07d}"
            write_wav(os.path.join(root, "audio", uid + ".flac"), wave, 16000)
            lines.append(f"LA_0079 {uid} - A0{1 + i % 6} "
                         f"{'bonafide' if bona else 'spoof'}")
        with open(os.path.join(root, f"{prefix}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


def write_train_config(root: str, ssl_pt: str) -> str:
    """The default recipe (configs/xlsr_aasist.yaml: XLSR_AASIST, bf16,
    RawBoost4, AdamW, batch 32, 4 s crops) with the kernels on the path."""
    audio = os.path.join(root, "audio")
    cfg = {"SysConfig": {
        "model": "XLSR_AASIST", "wandb_disabled": True, "num_workers": 4,
        "path_label_asv_spoof_2019_la_train": os.path.join(root, "LA_T.txt"),
        "path_asv_spoof_2019_la_train": audio,
        "path_label_asv_spoof_2019_la_dev": os.path.join(root, "LA_D.txt"),
        "path_asv_spoof_2019_la_dev": audio,
        "path_label_asv_spoof_2019_la_eval": os.path.join(root, "LA_D.txt"),
        "path_asv_spoof_2019_la_eval": audio,
        "la19_score_save_path": os.path.join(root, "scores_la19.txt"),
        "path_to_save_model": os.path.join(root, "runs"),
        "ssl_ckpt_path": ssl_pt, "ssl_pytree_path": ""},
        "ExpConfig": {
            "random_seed": TRAIN_SEED, "train_duration_sec": SAMPLES / 16000,
            "test_duration_sec": SAMPLES / 16000, "la19_eval_random_start": False,
            "batch_size_train": TRAIN_BATCH, "batch_size_test": TRAIN_BATCH,
            "lr": TRAIN_LR, "weight_decay": 1e-4,
            "allow_data_augmentation": True, "data_augmentation": ["RawBoost4"],
            "compute_dtype": "bfloat16",
            "kwargs": {"fused_gat": True, "w2v": {"fast_softmax": False}}}}
    path = os.path.join(root, "train.json")
    with open(path, "w") as f:
        # PyYAML reads 1e-06 as a string: YAML 1.1 floats need a dot
        f.write(json.dumps(cfg, indent=1).replace(": 1e-06", ": 1.0e-06"))
    return path


def train_model(sd: dict, dtype: torch.dtype, dev, w2v=None):
    """The main-path XLSR_AASIST built to train (remat, kernels on);
    ``w2v``, overrides of its encoder config (a remat policy)."""
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.registry import get_model

    spec = get_model("XLSR_AASIST", dtype=dtype, remat=True, fused_gat=True,
                     w2v={"fast_softmax": False, **(w2v or {})})
    spec.module.to(dev).load_state_dict(load_reference_state_dict(sd),
                                        strict=True)
    return spec.module.train()


def train_cli(sd: dict, dev) -> dict:
    """4j: the SSL part of the seed-0 weights as a fairseq ``.pt``, then
    ``cli.main --max_epoch 1`` on the synthetic set (2 train steps, 1 dev
    batch) and ``--is_eval --is_score --ckpt runs/last`` on the dev clips,
    each with the counters zeroed just before."""
    from rtdsd_tpu_torch.cli import main as cli

    root = os.path.join(WORK, "train")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    write_train_set(root)
    prefix = "ssl_model.model."
    ssl_pt = os.path.join(root, "xlsr_fairseq_seed0.pt")
    torch.save({"model": {k[len(prefix):]: v for k, v in sd.items()
                          if k.startswith(prefix)}}, ssl_pt)
    cfg = write_train_config(root, ssl_pt)
    log(f"4j: {TRAIN_CLIPS} train + {DEV_CLIPS} dev clips and the fairseq "
        f"SSL .pt written in {time.perf_counter() - t0:.1f} s")
    reset_counters()
    t0 = time.perf_counter()
    cli.main(["--config", cfg, "--max_epoch", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    steps_, dev_batches = TRAIN_CLIPS // TRAIN_BATCH, -(-DEV_CLIPS // TRAIN_BATCH)
    want = launches_want(48 * steps_ + 24 * dev_batches, dev_batches,
                         gelu=TRAIN_STEP_GELU * steps_
                         + w2v_gelu(24) * dev_batches)
    with open(os.path.join(root, "runs", "metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    losses = [r["Loss"] for r in recs if "Loss" in r]
    last = os.path.join(root, "runs", "last")
    log(f"4j train CLI (bf16, RawBoost4, batch {TRAIN_BATCH}, 1 epoch: "
        f"{steps_} steps + {dev_batches} dev batch): launches {launches} "
        f"(want {want}: 48 attention and 56 GELU a step, forward and remat "
        f"recompute, no GAT; 24, 2, 4 and 32 a dev batch); losses {losses}; dev "
        f"{[(r['Dev Loss'], r['Dev Acc']) for r in recs if 'Dev Loss' in r]}; "
        f"last/ {sorted(os.listdir(last))}; wall {wall:.1f} s incl. build, "
        f"SSL load and the checkpoint write")
    if launches != want:
        raise RuntimeError(f"train launches {launches} != {want}")
    if len(losses) != steps_ or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"train losses {losses}")
    if sorted(os.listdir(last)) != ["meta.json", "state.pt"]:
        raise RuntimeError(f"last/ holds {os.listdir(last)}")
    reset_counters()
    cli.main(["--config", cfg, "--is_eval", "--is_score", "--ckpt", last,
              "--tracks", "LA19"])
    torch.cuda.synchronize()
    score_launches = read_counters()
    with open(os.path.join(root, "scores_la19.txt")) as f:
        lines = f.read().splitlines()
    vals = np.array([float(l.split(" ")[1]) for l in lines])
    want = launches_want(24 * dev_batches, dev_batches,
                         gelu=w2v_gelu(24) * dev_batches)
    log(f"4j scoring from last/: {len(lines)} scores, finite "
        f"{int(np.isfinite(vals).sum())}; launches {score_launches} "
        f"(want {want})")
    if len(lines) != DEV_CLIPS or not np.all(np.isfinite(vals)) \
            or score_launches != want:
        raise RuntimeError("4j scoring from the trained checkpoint failed")
    return launches, ssl_pt, losses


def _train_step_outputs(model, waves, labels, lr, step_kw=None) -> dict:
    """One train step (``step_kw``, default RawBoost4; seed TRAIN_SEED) on
    a fresh AdamW: the loss, the gradients, the state dict after the step
    and AdamW's moments (the first, and the square root of the second,
    both linear in |g|)."""
    from rtdsd_tpu_torch.engine import steps

    state = steps.TrainState(model, steps.make_optimizer(model, lr, 1e-4))
    step = steps.make_train_step(**(step_kw or {"rawboost_algo": 4}))
    loss = float(step(state, waves, labels, TRAIN_SEED)["loss"])
    params = dict(model.named_parameters())
    out = {"loss": loss,
           "grads": {n: p.grad.detach().clone() for n, p in params.items()},
           "state": {k: v.detach().clone()
                     for k, v in model.state_dict().items()},
           "mu": {n: state.optimizer.state[p]["exp_avg"].clone()
                  for n, p in params.items()},
           "sqrt_nu": {n: state.optimizer.state[p]["exp_avg_sq"].sqrt()
                       for n, p in params.items()}}
    del state
    return out


def sdpa_math(q, k, v, scale=None):
    """The yardstick attention of 4j (a): PyTorch's math SDPA, the same
    function summed in another order (timed and used nowhere else)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel(SDPBackend.MATH):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale).transpose(1, 2)


@contextlib.contextmanager
def attention_swapped(fn):
    from rtdsd_tpu_torch.models import wav2vec2

    saved = wav2vec2.mha_small_t
    wav2vec2.mha_small_t = fn
    try:
        yield
    finally:
        wav2vec2.mha_small_t = saved


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms (cuDNN's too), so that atomics in
    a backward pass (the pools' gather, convolution weight gradients) give
    no run-to-run noise; the warnings of ops that have no deterministic
    version are recorded and printed once each."""
    import warnings

    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
        for msg in sorted({str(w.message).split(".")[0][:120] for w in caught}):
            log(f"  deterministic mode: {msg}")
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def held_per_tensor(got: dict, want: dict, rel: float) -> dict:
    """Each tensor of ``got`` against ``want``: within ``rel`` of its max
    |want|, or, where that max is at most TRAIN_ZERO_TOL of the largest
    one's (zero in exact arithmetic), under TRAIN_ZERO_TOL of the largest.
    -> {"zero": names, "gap": {name: |d| over its bound's scale}, "over":
    {name: that share} for the tensors past their bound}."""
    top = max(float(w.abs().max()) for w in want.values())
    zero, gap, over = [], {}, {}
    for n, w in want.items():
        scale = float(w.abs().max())
        if scale <= TRAIN_ZERO_TOL * top:
            zero.append(n)
            gap[n] = float(got[n].abs().max()) / top
            if gap[n] > TRAIN_ZERO_TOL:
                over[n] = gap[n]
        else:
            gap[n] = float((got[n] - w).abs().max()) / scale
            if gap[n] > rel:
                over[n] = gap[n]
    return {"zero": zero, "gap": gap, "over": over}


def _parity_runs(model, ref: dict, waves, labels, names, step_kw=None
                 ) -> tuple:
    """The train step (``step_kw``) from ``ref`` once for each of
    ``names`` ("kernels", "plain", "again": plain repeated, "sdpa": math
    SDPA attention), under deterministic algorithms; -> (runs, the kernels
    run's launches)."""
    ctxs = {"kernels": contextlib.nullcontext, "plain": plain_kernels,
            "again": plain_kernels,
            "sdpa": lambda: attention_swapped(sdpa_math)}
    runs, launches = {}, None
    with deterministic():
        for name in names:
            model.load_state_dict(ref, strict=True)
            reset_counters()
            with ctxs[name]():
                runs[name] = _train_step_outputs(model, waves, labels,
                                                 TRAIN_LR, step_kw)
            if name == "kernels":
                launches = read_counters()
    return runs, launches


def _stats_and_params(got: dict, want: dict) -> tuple:
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    d_stats = max(float((got[k] - want[k]).abs().max()) for k in stats)
    d_params = max(float((got[k] - want[k]).abs().max()) for k in want
                   if k not in stats and not k.endswith("num_batches_tracked"))
    return d_stats, d_params


def _worst(gap: dict, names, n: int = 3) -> str:
    return ", ".join(f"{k} {gap[k]:.3g}" for k in
                     sorted(names, key=lambda k: -gap[k])[:n])


def train_parity(sd: dict, dev) -> None:
    """4j (a): one float32 train step (TF32 off, deterministic algorithms)
    at batch 4 with the kernels against the same step with the plain
    versions, same seed. Gated, on the first PARITY_LAYERS layers of the
    weights at full width: loss, every gradient and AdamW's moments within
    TRAIN_GRAD_TOL of their tensor's max (the zero rule of
    ``held_per_tensor`` for those zero in exact arithmetic), BatchNorm
    statistics, parameters within 2 lr. At full depth: the loss, the zero
    gradients and the statistics are gated; how many other gradients lie
    past TRAIN_GRAD_TOL is printed, for the kernels and for a step with
    the math SDPA in place of the attention (no kernel), which measures
    float32's conditioning of the random-weight model."""
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.registry import get_model
    from rtdsd_tpu_torch.models.wav2vec2 import select_layers

    waves, labels = train_batch(dev, PARITY_BATCH)
    ref = load_reference_state_dict(sd)
    failed = []

    runs, launches = _parity_runs(train_model(sd, torch.float32, dev), ref,
                                  waves, labels, ("kernels", "plain", "sdpa"))
    torch.cuda.empty_cache()
    plain = runs["plain"]
    held = {k: held_per_tensor(runs[k]["grads"], plain["grads"],
                               TRAIN_GRAD_TOL) for k in ("kernels", "sdpa")}
    real = [n for n in plain["grads"] if n not in held["kernels"]["zero"]]
    zero_over = {n: g for n, g in held["kernels"]["over"].items()
                 if n in held["kernels"]["zero"]}
    d_loss = abs(runs["kernels"]["loss"] - plain["loss"])
    d_stats, d_params = _stats_and_params(runs["kernels"]["state"],
                                          plain["state"])
    log(f"4j (a) f32 train step at full depth (24 layers), batch "
        f"{PARITY_BATCH} (TF32 off, deterministic algorithms): launches "
        f"{launches}; loss kernels {runs['kernels']['loss']:.7f}, plain "
        f"{plain['loss']:.7f}, math SDPA {runs['sdpa']['loss']:.7f} (tol "
        f"{TRAIN_LOSS_TOL}); {len(held['kernels']['zero'])} gradients zero "
        f"in exact arithmetic (max under {TRAIN_ZERO_TOL:g} of the largest), "
        f"held under it: worst {_worst(held['kernels']['gap'], held['kernels']['zero'], 1)}; "
        f"BN statistics max|d| {d_stats:.3g} (tol {TRAIN_STATS_TOL}); "
        f"parameters after AdamW max|d| {d_params:.3g}")
    for k, what in (("kernels", "kernels"), ("sdpa", "math SDPA, no kernel")):
        past = [n for n in real if n in held[k]["over"]]
        log(f"  full depth, not gated ({what}): {len(past)} of {len(real)} "
            f"other gradients past {TRAIN_GRAD_TOL} of their max; worst "
            f"{_worst(held[k]['gap'], real)}; in the graph head (past the "
            f"SSL and the residual encoder) worst "
            f"{_worst(held[k]['gap'], [n for n in real if not n.startswith(('ssl_model', 'encoder.', 'LL', 'first_bn.'))], 1)}")
    log(f"  zero in exact arithmetic: {sorted(held['kernels']['zero'])}")
    if launches != launches_want(48):
        failed.append(f"full-depth launches {launches}")
    if d_loss > TRAIN_LOSS_TOL or zero_over or d_stats > TRAIN_STATS_TOL:
        failed.append(f"full depth: loss {d_loss:.3g}, zero gradients "
                      f"{zero_over}, statistics {d_stats:.3g}")
    del runs, plain, held
    torch.cuda.empty_cache()

    spec = get_model("My_XLSR_AASIST", dtype=torch.float32, remat=True,
                     num_layers=PARITY_LAYERS, fused_gat=True,
                     w2v={"fast_softmax": False})
    model = spec.module.to(dev).train()
    runs, launches = _parity_runs(
        model, select_layers(ref, spec.layer_indices), waves, labels,
        ("kernels", "plain", "again"))
    del model
    torch.cuda.empty_cache()
    plain, got = runs["plain"], runs["kernels"]
    held = {k: held_per_tensor(got[k], plain[k], TRAIN_GRAD_TOL)
            for k in ("grads", "mu", "sqrt_nu")}
    g = held["grads"]
    real = [n for n in g["gap"] if n not in g["zero"]]
    again = max(float((runs["again"]["grads"][n] - t).abs().max())
                for n, t in plain["grads"].items())
    d_loss = abs(got["loss"] - plain["loss"])
    d_stats, d_params = _stats_and_params(got["state"], plain["state"])
    log(f"4j (a) f32 train step, layers {spec.layer_indices} at full width, "
        f"batch {PARITY_BATCH} (gated): launches {launches}; loss kernels "
        f"{got['loss']:.7f}, plain {plain['loss']:.7f} (tol "
        f"{TRAIN_LOSS_TOL}); plain repeated max|d| of gradients {again:.3g}; "
        f"{len(real)} gradients held to {TRAIN_GRAD_TOL} of their max: worst "
        f"{_worst(g['gap'], real)}; {len(g['zero'])} zero in exact "
        f"arithmetic held under {TRAIN_ZERO_TOL:g} of the largest: worst "
        f"{_worst(g['gap'], g['zero'], 1)}; AdamW moments held so: first "
        f"worst {_worst(held['mu']['gap'], held['mu']['gap'], 1)}, square "
        f"root of the second worst "
        f"{_worst(held['sqrt_nu']['gap'], held['sqrt_nu']['gap'], 1)}; BN "
        f"statistics max|d| {d_stats:.3g} (tol {TRAIN_STATS_TOL}); parameters "
        f"after AdamW max|d| {d_params:.3g} (2 lr + 1e-6 = {PARAM_TOL:g})")
    log(f"  zero in exact arithmetic: {sorted(g['zero'])}")
    over = {k: h["over"] for k, h in held.items() if h["over"]}
    if launches != launches_want(2 * PARITY_LAYERS):
        failed.append(f"{PARITY_LAYERS}-layer launches {launches}")
    if (d_loss > TRAIN_LOSS_TOL or over or d_stats > TRAIN_STATS_TOL
            or d_params > PARAM_TOL):
        failed.append(f"{PARITY_LAYERS} layers: loss {d_loss:.3g}, past "
                      f"their bounds {over}, statistics {d_stats:.3g}, "
                      f"parameters {d_params:.3g}")
    if failed:
        raise RuntimeError("4j (a): the kernels' train step disagrees with "
                           f"the plain one: {failed}")


def attention_grad_check(dev) -> dict:
    """4j (b): ``mha_small_t``'s autograd function at the train step's
    shape against autograd through ``mha_small_t_reference``, float32 and
    bf16, forward and dQ, dK, dV at phase 3's tolerances."""
    from rtdsd_tpu_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for kind, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v, do = (torch.randn((TRAIN_BATCH, 199, 16, 64), generator=g,
                                   device=dev).to(dt) for _ in range(4))
        res = []
        for fn in (attention.mha_small_t, attention.mha_small_t_reference):
            xs = [t.clone().requires_grad_() for t in (q, k, v)]
            y = fn(*xs)
            y.backward(do)
            res.append([y.detach()] + [t.grad for t in xs])
        rtol, atol = ATTN_TOL[kind]
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(*res)]
        out[kind] = errs
        for a, b, what in zip(*res, ("out", "dq", "dk", "dv")):
            torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                       msg=f"mha_small_t {kind} {what}")
    log(f"4j (b) mha_small_t autograd at ({TRAIN_BATCH}, 199, 16, 64) vs "
        f"autograd through the plain version, max|d| (out, dQ, dK, dV): "
        + "; ".join(f"{k} {', '.join(f'{e:.3g}' for e in v)}"
                    for k, v in out.items()))
    return out


def train_batch(dev, n: int):
    from rtdsd_tpu_torch.config import load_yaml_config
    from rtdsd_tpu_torch.data.dataset import ASVspoof2019LA

    root = os.path.join(WORK, "train")
    sys_cfg, exp_cfg = load_yaml_config(os.path.join(root, "train.json"))
    ds = ASVspoof2019LA(sys_cfg, exp_cfg, is_train=True)
    waves = np.stack([ds.get(i)[1] for i in range(n)])
    labels = np.array([ds.trials[i].label for i in range(n)])
    return (torch.from_numpy(waves).to(dev),
            torch.from_numpy(labels).to(dev).long())


def train_timed(sd: dict, dev, card: str) -> None:
    """4j (c): bf16 train steps at batch 32 (RawBoost4, the kernels on):
    ms a step, the allocator's peak, one step's launches, device busy share
    and device ms by kernel class."""
    from rtdsd_tpu_torch.engine import steps

    waves, labels = train_batch(dev, TRAIN_BATCH)
    model = train_model(sd, torch.bfloat16, dev)
    state = steps.TrainState(model, steps.make_optimizer(model, TRAIN_LR, 1e-4))
    step = steps.make_train_step(rawboost_algo=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(2):
        step(state, waves, labels, TRAIN_SEED)
    torch.cuda.synchronize()
    times = []
    for _ in range(TRAIN_STEPS_TIMED):
        t0 = time.perf_counter()
        step(state, waves, labels, TRAIN_SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    reset_counters()
    step(state, waves, labels, TRAIN_SEED)
    launches = read_counters()
    rows, wall_ms = _profiled(lambda: step(state, waves, labels, TRAIN_SEED),
                              inference=False)
    busy = sum(r[1] for r in rows)
    median = statistics.median(times)
    log(f"4j (c) bf16 train step, batch {TRAIN_BATCH} (RawBoost4, remat, "
        f"fused_gat, fast_softmax off), {card}: {median:.1f} ms median "
        f"[{min(times):.1f}, {max(times):.1f}] of {TRAIN_STEPS_TIMED} after 2 "
        f"warm-ups; max_memory_allocated {peak / 2**30:.2f} GiB "
        f"({base / 2**30:.2f} before the first step: parameters); one step's "
        f"launches {launches}; profiled step: kernels {busy:.1f} ms, "
        f"{sum(r[2] for r in rows)} kernel launches, wall {wall_ms:.1f} ms "
        f"(device busy {100 * busy / wall_ms:.1f}% under the profiler, "
        f"{100 * busy / median:.1f}% of the median unprofiled step)")
    for cls, (ms, n) in sorted(by_class(rows).items(), key=lambda kv: -kv[1][0]):
        log(f"  class {cls:22s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<5d} {key[:90]}")
    if launches != launches_want(48, gelu=TRAIN_STEP_GELU):
        raise RuntimeError(f"4j (c): a train step launched {launches}")
    del state, model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 4n

DDP_LAYERS = 4          # (b): the gated depth of 4j (a), at full width
DDP_LOCAL = 4           # (b): clips a process a step; the global batch 8
DDP_STEPS = 3           # (b): DDP steps checked for agreement
DDP_TIMED = 3           # (b): rounds of the step and its no_sync twin
DDP_SCORE_BATCH = 8     # (b): clips a process a scoring batch


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        env.pop(var, None)
    return env


def torchrun_cli(args, tag: str) -> float:
    """``cli.main args`` under ``torch.distributed.run`` with one process;
    -> its wall s. A failure raises with the child's output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           "1", "--master_addr", "127.0.0.1", "--master_port",
           str(free_port()), "-m", "rtdsd_tpu_torch.cli.main", *args]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=child_env(), capture_output=True,
                       text=True, timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode:
        raise RuntimeError(f"4n (a) torchrun {tag} exited {r.returncode}:\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return wall


def ddp_world1(sd: dict, dev, card: str, losses_4j: list) -> None:
    """4n (a): see the module note."""
    from rtdsd_tpu_torch.engine import steps
    from rtdsd_tpu_torch.parallel import distributed
    from rtdsd_tpu_torch.parallel.mesh import make_mesh, place_state

    root = os.path.join(WORK, "train")
    with open(os.path.join(root, "train.json")) as f:
        cfg = json.load(f)
    cfg["ExpConfig"]["parallel_mode"] = "dp"
    cfg["SysConfig"]["path_to_save_model"] = os.path.join(root, "runs_ddp")
    cfg["SysConfig"]["la19_score_save_path"] = os.path.join(
        root, "scores_la19_ddp.txt")
    path = os.path.join(root, "train_ddp.json")
    with open(path, "w") as f:
        f.write(json.dumps(cfg, indent=1).replace(": 1e-06", ": 1.0e-06"))
    torch.cuda.empty_cache()
    train_wall = torchrun_cli(["--config", path, "--max_epoch", "1"], "train")
    with open(os.path.join(root, "runs_ddp", "metrics.jsonl")) as f:
        losses = [r["Loss"] for r in map(json.loads, f) if "Loss" in r]
    score_wall = torchrun_cli(
        ["--config", path, "--is_eval", "--is_score", "--ckpt",
         os.path.join(root, "runs", "last"), "--tracks", "LA19"], "score")
    with open(os.path.join(root, "scores_la19.txt"), "rb") as f:
        want = f.read()
    with open(os.path.join(root, "scores_la19_ddp.txt"), "rb") as f:
        got = f.read()
    log(f"4n (a) torchrun, 1 process, NCCL, parallel_mode dp, {card}: train "
        f"epoch losses {losses} against 4j's {losses_4j} (first bit for "
        f"bit: {losses[:1] == losses_4j[:1]}); wall {train_wall:.1f} s; "
        f"scoring 4j's last/: {len(got.splitlines())} lines, file equal to "
        f"4j's byte for byte: {got == want}; wall {score_wall:.1f} s")
    if losses[:1] != losses_4j[:1] or len(losses) != len(losses_4j):
        raise RuntimeError(f"4n (a): DDP losses {losses} vs {losses_4j}")
    if got != want:
        raise RuntimeError("4n (a): the torchrun score file differs from 4j's")

    if not distributed.maybe_initialize_distributed(
            coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
            process_id=0, backend="nccl"):
        raise RuntimeError("4n (a): no process group")
    try:
        waves, labels = train_batch(dev, TRAIN_BATCH)
        runs = {}
        for key in ("4j", "ddp"):
            model = train_model(sd, torch.bfloat16, dev)
            state = steps.TrainState(model, steps.make_optimizer(
                model, TRAIN_LR, 1e-4))
            if key == "ddp":
                state = place_state(state, make_mesh(), "dp", dev)
            runs[key] = state
        step = steps.make_train_step(rawboost_algo=4)
        times = {k: [] for k in runs}
        for _ in range(2):
            for state in runs.values():
                step(state, waves, labels, TRAIN_SEED)
        for _ in range(TRAIN_STEPS_TIMED):
            for k, state in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(state, waves, labels, TRAIN_SEED)
                torch.cuda.synchronize()
                times[k].append((time.perf_counter() - t0) * 1e3)
        reset_counters()
        step(runs["ddp"], waves, labels, TRAIN_SEED)
        torch.cuda.synchronize()
        launches = read_counters()
    finally:
        torch.distributed.destroy_process_group()
    log(f"4n (a) bf16 train step at batch {TRAIN_BATCH}, {card}, in turns "
        f"(median [min, max] of {TRAIN_STEPS_TIMED} after 2 warm-ups): " +
        ", ".join(f"{k} {statistics.median(t):.1f} ms [{min(t):.1f}, "
                  f"{max(t):.1f}]" for k, t in times.items()) +
        f"; one DDP step's launches {launches}")
    if launches != launches_want(48, gelu=TRAIN_STEP_GELU):
        raise RuntimeError(f"4n (a): a DDP step launched {launches}")
    del runs, state, model
    torch.cuda.empty_cache()


def ddp_inputs(sd: dict, dev, root: str) -> tuple:
    """4n (b)'s weights (the first DDP_LAYERS layers), global batch and
    scoring config under ``root``."""
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.wav2vec2 import select_layers

    os.makedirs(root, exist_ok=True)
    weights = os.path.join(root, "weights.pt")
    torch.save(select_layers(load_reference_state_dict(sd),
                             list(range(DDP_LAYERS))), weights)
    waves, labels = train_batch(dev, 2 * DDP_LOCAL)
    torch.save({"waves": waves.cpu(), "labels": labels.cpu()},
               os.path.join(root, "batch.pt"))
    with open(os.path.join(WORK, "train", "train.json")) as f:
        cfg = json.load(f)
    cfg["SysConfig"]["model"] = "My_XLSR_AASIST"
    cfg["ExpConfig"].update(compute_dtype="float32",
                            batch_size_test=DDP_SCORE_BATCH)
    cfg["ExpConfig"]["kwargs"]["num_layers"] = DDP_LAYERS
    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        f.write(json.dumps(cfg, indent=1).replace(": 1e-06", ": 1.0e-06"))
    return weights, path


def ddp_model(weights: str, cfg: str, dev, train: bool):
    from rtdsd_tpu_torch.cli.common import build_model
    from rtdsd_tpu_torch.config import load_yaml_config

    sys_cfg, exp_cfg = load_yaml_config(cfg)
    spec = build_model(sys_cfg, exp_cfg, dev, train=train)
    spec.module.load_state_dict(torch.load(weights), strict=True)
    return spec, sys_cfg, exp_cfg


@contextlib.contextmanager
def no_dropout():
    from rtdsd_tpu_torch.models import dropout

    drop = dropout.drop
    dropout.drop = lambda x, p, src: x
    try:
        yield
    finally:
        dropout.drop = drop


def wait_all(procs, timeout: float) -> None:
    """Wait for every process; the first to fail, or the deadline, kills
    the rest (a peer left waiting in a collective would hang)."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
                or any(p.poll() not in (None, 0) for p in procs)):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.2)
    for p in procs:
        p.wait()


def ddp_worker(rank: int, port: int, root: str) -> int:
    """One of 4n (b)'s two gloo processes on the card (``chip_smoke.py
    --ddp-worker RANK PORT DIR``): writes ``DIR/report_RANK.json``."""
    from rtdsd_tpu_torch.cli.common import produce_evaluation_file
    from rtdsd_tpu_torch.data.dataset import ASVspoof2019LA_eval
    from rtdsd_tpu_torch.engine import steps
    from rtdsd_tpu_torch.parallel import distributed
    from rtdsd_tpu_torch.parallel.mesh import make_mesh, place_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    if not distributed.maybe_initialize_distributed(
            coordinator=f"127.0.0.1:{port}", num_processes=2,
            process_id=rank, backend="gloo",
            timeout=datetime.timedelta(seconds=300)):
        raise RuntimeError("4n (b): no process group")
    dev = torch.device("cuda", 0)
    weights, cfg = os.path.join(root, "weights.pt"), os.path.join(root,
                                                                  "cfg.json")
    batch = torch.load(os.path.join(root, "batch.pt"))
    rows = slice(rank * DDP_LOCAL, (rank + 1) * DDP_LOCAL)
    waves, labels = batch["waves"][rows].to(dev), batch["labels"][rows].to(dev)
    spec, sys_cfg, exp_cfg = ddp_model(weights, cfg, dev, train=True)
    state = steps.TrainState(spec.module, steps.make_optimizer(
        spec.module, TRAIN_LR, 1e-4))
    state = place_state(state, make_mesh(), "dp", dev)
    step = steps.make_train_step()
    with no_dropout():
        losses = [float(step(state, waves, labels, TRAIN_SEED)["loss"])
                  for _ in range(DDP_STEPS)]
        same = True
        for p in state.model.parameters():
            ref = p.detach().clone()
            torch.distributed.broadcast(ref, 0)
            same = same and torch.equal(ref, p.detach())
        times = {"step": [], "no_sync": []}
        for _ in range(DDP_TIMED):
            for key in times:
                ctx = (state.forward.no_sync() if key == "no_sync"
                       else contextlib.nullcontext())
                torch.distributed.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ctx:
                    step(state, waves, labels, TRAIN_SEED)
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - t0) * 1e3)
    del state
    spec, sys_cfg, exp_cfg = ddp_model(weights, cfg, dev, train=False)
    produce_evaluation_file(ASVspoof2019LA_eval(sys_cfg, exp_cfg), spec,
                            os.path.join(root, "scores_2p.txt"),
                            DDP_SCORE_BATCH, dev)
    with open(os.path.join(root, f"report_{rank}.json"), "w") as f:
        json.dump({"losses": losses, "params_equal": bool(same),
                   "times": times}, f)
    torch.distributed.destroy_process_group()
    return 0


def ddp_gloo(sd: dict, dev, card: str) -> None:
    """4n (b): see the module note."""
    from rtdsd_tpu_torch.cli.common import produce_evaluation_file
    from rtdsd_tpu_torch.data.dataset import ASVspoof2019LA_eval
    from rtdsd_tpu_torch.engine import steps

    root = os.path.join(WORK, "ddp")
    weights, cfg = ddp_inputs(sd, dev, root)
    port = free_port()
    env = dict(child_env(), CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    logs = [os.path.join(root, f"worker_{r}.log") for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                 "--ddp-worker", str(r), str(port), root], cwd=ROOT, env=env,
                stdout=out, stderr=subprocess.STDOUT))
    wait_all(procs, 600)
    wall = time.perf_counter() - t0
    bad = []
    for r, p in enumerate(procs):
        if p.returncode:
            with open(logs[r]) as f:
                bad.append(f"worker {r} exited {p.returncode}:\n"
                           f"{f.read()[-3000:]}")
    if bad:
        raise RuntimeError("4n (b): " + "\n".join(bad))
    reports = []
    for r in range(2):
        with open(os.path.join(root, f"report_{r}.json")) as f:
            reports.append(json.load(f))

    with deterministic(), no_dropout():
        spec, sys_cfg, exp_cfg = ddp_model(weights, cfg, dev, train=True)
        state = steps.TrainState(spec.module, steps.make_optimizer(
            spec.module, TRAIN_LR, 1e-4))
        batch = torch.load(os.path.join(root, "batch.pt"))
        one = float(steps.make_train_step()(
            state, batch["waves"].to(dev), batch["labels"].to(dev),
            TRAIN_SEED)["loss"])
        del state
        spec, sys_cfg, exp_cfg = ddp_model(weights, cfg, dev, train=False)
        produce_evaluation_file(ASVspoof2019LA_eval(sys_cfg, exp_cfg), spec,
                                os.path.join(root, "scores_1p.txt"),
                                DDP_SCORE_BATCH, dev)
    del spec
    torch.cuda.empty_cache()
    files = []
    for name in ("scores_2p.txt", "scores_1p.txt"):
        with open(os.path.join(root, name), "rb") as f:
            files.append(f.read())
    a, b = reports
    d_loss = abs(a["losses"][0] - one)
    coll = [s - n for s, n in zip(a["times"]["step"], a["times"]["no_sync"])]
    log(f"4n (b) 2 gloo processes on one card, {card}, XLSR_AASIST "
        f"{DDP_LAYERS} layers at full width, float32 (TF32 off, "
        f"deterministic), {DDP_LOCAL} clips a process: losses {a['losses']} "
        f"and {b['losses']} (equal: {a['losses'] == b['losses']}); "
        f"parameters identical after {DDP_STEPS} steps: "
        f"{a['params_equal'] and b['params_equal']}; first loss against one "
        f"process on the 8 clips {one:.7f}: |d| {d_loss:.3g} (tol 1e-4); "
        f"step ms (process 0, in turns) {[round(t, 1) for t in a['times']['step']]}"
        f", under no_sync {[round(t, 1) for t in a['times']['no_sync']]}: "
        f"gradient collectives {statistics.median(coll):.1f} ms a step "
        f"(median); merged score file of {len(files[0].splitlines())} lines "
        f"equal to one process's at {DDP_SCORE_BATCH} byte for byte: "
        f"{files[0] == files[1]}; wall of the two processes {wall:.1f} s")
    if (a["losses"] != b["losses"] or not (a["params_equal"]
                                           and b["params_equal"])
            or d_loss > 1e-4 or files[0] != files[1]):
        raise RuntimeError("4n (b): the two-process run disagrees")


# 4j (e): the remat settings, each a schedule of what the backward keeps
REMAT_SETTINGS = (("full", {}), ("hidden", {"remat_policy": "hidden"}),
                  ("dots", {"remat_policy": "dots"}),
                  ("save_every_4", {"remat_save_every": 4}))
# of each gradient's max: a policy keeps other tensors, the arithmetic is
# the same, so a larger gap is a fault
REMAT_GRAD_TOL = 1e-6
REMAT_STEPS = 3


def remat_path(sd: dict, dev, card: str) -> None:
    """4j (e): (1) one float32 train step (TF32 off, deterministic
    algorithms, batch 4) on the first 4 layers at full width under each
    remat setting: every gradient within REMAT_GRAD_TOL of its max of the
    ``full`` step's; (2) bf16 train steps at batch 32 at full depth under
    each setting: ms a step (median [min, max] of REMAT_STEPS after a
    warm-up), ``max_memory_allocated`` and one step's launches."""
    from rtdsd_tpu_torch.engine import steps
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.registry import get_model
    from rtdsd_tpu_torch.models.wav2vec2 import select_layers

    waves, labels = train_batch(dev, PARITY_BATCH)
    ref = load_reference_state_dict(sd)
    grads = {}
    for name, w2v in REMAT_SETTINGS:
        spec = get_model("My_XLSR_AASIST", dtype=torch.float32, remat=True,
                         num_layers=PARITY_LAYERS, fused_gat=True,
                         w2v={"fast_softmax": False, **w2v})
        model = spec.module.to(dev)
        model.load_state_dict(select_layers(ref, spec.layer_indices),
                              strict=True)
        with deterministic():
            grads[name] = _train_step_outputs(model.train(), waves, labels,
                                              TRAIN_LR)["grads"]
        del model
    full = grads["full"]
    gaps, bad = {}, []
    for name in grads:
        if name == "full":
            continue
        rel = {}
        for k, g in full.items():
            d = float((grads[name][k] - g).abs().max())
            top = float(g.abs().max())
            rel[k] = (d, d / top if top else (0.0 if d == 0 else float("inf")))
        worst = max(rel, key=lambda k: rel[k][1])
        gaps[name] = (max(v[0] for v in rel.values()), worst, rel[worst][1],
                      sum(v[0] == 0 for v in rel.values()), len(rel))
        if rel[worst][1] > REMAT_GRAD_TOL:
            bad.append(name)
    log(f"4j (e) f32 train step on layers 0-{PARITY_LAYERS - 1} at full "
        f"width, batch {PARITY_BATCH} (TF32 off, deterministic algorithms), "
        f"each remat setting against full: " + "; ".join(
            f"{n} max|d| {a:.3g}, worst {k} at {r:.3g} of its max (tol "
            f"{REMAT_GRAD_TOL:g}), {z}/{t} gradients bit for bit"
            for n, (a, k, r, z, t) in gaps.items()))
    if bad:
        raise RuntimeError(f"4j (e): remat settings {bad} change gradients")
    del grads, full
    torch.cuda.empty_cache()

    waves, labels = train_batch(dev, TRAIN_BATCH)
    rows = []
    for name, w2v in REMAT_SETTINGS:
        model = train_model(sd, torch.bfloat16, dev, w2v)
        state = steps.TrainState(model, steps.make_optimizer(model, TRAIN_LR,
                                                             1e-4))
        step = steps.make_train_step(rawboost_algo=4)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        step(state, waves, labels, TRAIN_SEED)
        torch.cuda.synchronize()
        launches = read_counters()
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            step(state, waves, labels, TRAIN_SEED)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rows.append((name, times, torch.cuda.max_memory_allocated(), base,
                     launches["mha_small_t"]))
        del state, model, step
        torch.cuda.empty_cache()
    peak_full = rows[0][2]
    log(f"4j (e) bf16 train step, batch {TRAIN_BATCH}, 24 layers (RawBoost4, "
        f"fused_gat, fast_softmax off), {card}, per remat setting: " + "; ".join(
            f"{n} {statistics.median(t):.1f} ms [{min(t):.1f}, {max(t):.1f}], "
            f"max_memory_allocated {p / 2**30:.3f} GiB ({(p - peak_full) / 1e9:+.3f} "
            f"GB vs full; {b / 2**30:.2f} GiB before the first step), "
            f"{a} mha_small_t launches a step"
            for n, t, p, b, a in rows))


# ------------------------------------------------------------ phase 4k

# configs/xlsr_conformer.yaml's model with the reference's other recipe:
# the mul_augment chain (host noise, then TST GAN AIR TMK on the card)
# before pre-emphasis and the trainer-side chain after it
CONFORMER_AUGS = ["mul_augment", "ACN", "HPF", "LPF", "GAN", "TMK"]
CONFORMER_TRAIN_KWARGS = {"w2v": {"fast_softmax": False}}
NOISE_FILES = 4


def write_noise(root: str) -> str:
    """Four noise WAVs of 2-5 s (white, and three coloured by a first-order
    filter, from seed 4) under ``root/noise``."""
    from scipy.signal import lfilter

    from rtdsd_tpu_torch.data.io import write_wav

    rng = np.random.default_rng(4)
    out = os.path.join(root, "noise")
    os.makedirs(out, exist_ok=True)
    for i in range(NOISE_FILES):
        n = 16000 * (2 + i)
        x = lfilter([1.0], [1.0, -0.3 * i], rng.standard_normal(n))
        write_wav(os.path.join(out, f"noise_{i}.wav"),
                  (0.1 * x / np.abs(x).max()).astype(np.float32), 16000)
    return out


def convert_ssl(ssl_pt: str) -> tuple:
    """4k (a): ``python -m rtdsd_tpu_torch.cli.convert --fairseq`` on 4j's
    full-width ``.pt`` -> a pytree directory, read back by the port bit
    for bit against the ``.pt``'s own conversion; -> (the directory, the
    encoder state dict read back)."""
    from rtdsd_tpu_torch.cli.common import load_ssl_state_dict
    from rtdsd_tpu_torch.models.convert_fairseq import encoder_state_dict

    out = os.path.join(os.path.dirname(ssl_pt), "xlsr_pytree")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "rtdsd_tpu_torch.cli.convert",
                        "--fairseq", ssl_pt, "--out", out], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode:
        raise RuntimeError(f"4k (a) convert failed:\n{r.stdout}{r.stderr}")
    t0 = time.perf_counter()
    got = load_ssl_state_dict(out)
    read_s = time.perf_counter() - t0
    want = encoder_state_dict(ssl_pt)
    same = got.keys() == want.keys() and all(torch.equal(got[k], want[k])
                                             for k in want)
    size = os.path.getsize(os.path.join(out, "weights.msgpack"))
    log(f"4k (a) cli.convert --fairseq: {r.stdout.strip()}; weights.msgpack "
        f"{size / 2**30:.3f} GiB in {wall:.1f} s (a subprocess); read back in "
        f"{read_s:.1f} s: {len(got)} tensors bit for bit equal to the .pt's: "
        f"{same}")
    if not same:
        raise RuntimeError("4k (a): the pytree read back differs from the .pt")
    os.remove(ssl_pt)
    return out, got


def write_conformer_train_config(root: str, pytree: str, noise: str) -> str:
    """4j's set and batch with ``model: XLSR_Conformer`` from
    ``ssl_pytree_path`` and the CONFORMER_AUGS chains on ``noise``."""
    with open(os.path.join(root, "train.json")) as f:
        cfg = json.load(f)
    cfg["SysConfig"].update({
        "model": "XLSR_Conformer", "ssl_ckpt_path": "",
        "ssl_pytree_path": pytree, "noise_path": noise,
        "path_to_save_model": os.path.join(root, "runs_conformer"),
        "la19_score_save_path": os.path.join(root, "scores_conformer.txt")})
    cfg["ExpConfig"].update({"data_augmentation": CONFORMER_AUGS,
                             "allow_data_augmentation": True,
                             "kwargs": CONFORMER_TRAIN_KWARGS})
    path = os.path.join(root, "train_conformer.json")
    with open(path, "w") as f:
        f.write(json.dumps(cfg, indent=1).replace(": 1e-06", ": 1.0e-06"))
    return path


def conformer_train_cli(cfg: str) -> dict:
    """4k (b): ``cli.main --max_epoch 1`` on the XLSR_Conformer config, then
    scoring from ``last/``, the counters zeroed just before each."""
    from rtdsd_tpu_torch.cli import main as cli

    root = os.path.dirname(cfg)
    reset_counters()
    t0 = time.perf_counter()
    cli.main(["--config", cfg, "--max_epoch", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    steps_, dev_batches = TRAIN_CLIPS // TRAIN_BATCH, -(-DEV_CLIPS // TRAIN_BATCH)
    want = launches_want(48 * steps_ + 24 * dev_batches,
                         gelu=TRAIN_STEP_GELU * steps_
                         + w2v_gelu(24) * dev_batches)
    runs = os.path.join(root, "runs_conformer")
    with open(os.path.join(runs, "metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    losses = [r["Loss"] for r in recs if "Loss" in r]
    last = os.path.join(runs, "last")
    log(f"4k (b) XLSR_Conformer train CLI (bf16, ssl_pytree_path, "
        f"{'+'.join(CONFORMER_AUGS)}, {NOISE_FILES} noise files, batch "
        f"{TRAIN_BATCH}, 1 epoch: {steps_} steps + {dev_batches} dev batch): "
        f"launches {launches} (want {want}: 48 attention and 56 GELU a step, "
        f"forward and remat recompute, 24 and 32 a dev batch, no GAT); losses "
        f"{losses}; dev "
        f"{[(r['Dev Loss'], r['Dev Acc']) for r in recs if 'Dev Loss' in r]}; "
        f"last/ {sorted(os.listdir(last))}; wall {wall:.1f} s incl. the "
        f"pytree read, the host chain and the checkpoint write")
    if launches != want:
        raise RuntimeError(f"4k (b): train launches {launches} != {want}")
    if len(losses) != steps_ or not np.all(np.isfinite(losses)):
        raise RuntimeError(f"4k (b): train losses {losses}")
    if sorted(os.listdir(last)) != ["meta.json", "state.pt"]:
        raise RuntimeError(f"4k (b): last/ holds {os.listdir(last)}")
    reset_counters()
    cli.main(["--config", cfg, "--is_eval", "--is_score", "--ckpt", last,
              "--tracks", "LA19"])
    torch.cuda.synchronize()
    score_launches = read_counters()
    with open(os.path.join(root, "scores_conformer.txt")) as f:
        vals = np.array([float(l.split(" ")[1]) for l in f.read().splitlines()])
    want = launches_want(24 * dev_batches, gelu=w2v_gelu(24) * dev_batches)
    log(f"4k (b) scoring from last/: {len(vals)} scores, finite "
        f"{int(np.isfinite(vals).sum())}; launches {score_launches} (want "
        f"{want})")
    if len(vals) != DEV_CLIPS or not np.all(np.isfinite(vals)) \
            or score_launches != want:
        raise RuntimeError("4k (b): scoring from the trained checkpoint failed")
    shutil.rmtree(runs)
    return launches


def conformer_model(ssl_sd: dict, dtype: torch.dtype, dev, layers=None):
    """A train-mode XLSR_Conformer (``layers``: the first that many of a
    pruned My_XLSR_Conformer) as ``init_state`` makes it: the JAX
    initialisers from TRAIN_SEED, the encoder from ``ssl_sd`` (the pytree
    directory's)."""
    from rtdsd_tpu_torch.models.registry import get_model
    from rtdsd_tpu_torch.models.wav2vec2 import select_layers
    from rtdsd_tpu_torch.models.zoo import init_weights

    spec = get_model("My_XLSR_Conformer" if layers else "XLSR_Conformer",
                     dtype=dtype, remat=True, **CONFORMER_TRAIN_KWARGS,
                     **({"num_layers": layers} if layers else {}))
    init_weights(spec.module, TRAIN_SEED)
    spec.module.ssl_model.model.load_state_dict(select_layers(
        ssl_sd, spec.layer_indices, prefix=""))
    return spec.module.to(dev).train()


def conformer_step_kw() -> dict:
    from rtdsd_tpu_torch.engine import steps

    return {"pre_aug_list": steps.pre_device_augs(CONFORMER_AUGS),
            "aug_list": steps.post_device_augs(CONFORMER_AUGS, True)}


def conformer_parity(ssl_sd: dict, dev) -> None:
    """4k (c): one float32 XLSR_Conformer train step (both chains on, TF32
    off, deterministic algorithms) at batch 4 with the kernels against the
    same step with the plain versions, same seed, on the first
    PARITY_LAYERS layers at full width, gated as 4j (a)."""
    waves, labels = train_batch(dev, PARITY_BATCH)
    model = conformer_model(ssl_sd, torch.float32, dev, PARITY_LAYERS)
    ref = {k: v.detach().clone() for k, v in model.state_dict().items()}
    runs, launches = _parity_runs(model, ref, waves, labels,
                                  ("kernels", "plain", "again"),
                                  conformer_step_kw())
    del model
    torch.cuda.empty_cache()
    plain, got = runs["plain"], runs["kernels"]
    held = {k: held_per_tensor(got[k], plain[k], TRAIN_GRAD_TOL)
            for k in ("grads", "mu", "sqrt_nu")}
    g = held["grads"]
    real = [n for n in g["gap"] if n not in g["zero"]]
    again = max(float((runs["again"]["grads"][n] - t).abs().max())
                for n, t in plain["grads"].items())
    d_loss = abs(got["loss"] - plain["loss"])
    d_stats, d_params = _stats_and_params(got["state"], plain["state"])
    log(f"4k (c) f32 XLSR_Conformer train step, layers 0-{PARITY_LAYERS - 1} "
        f"at full width, batch {PARITY_BATCH}, both chains (gated): launches "
        f"{launches}; loss kernels {got['loss']:.7f}, plain "
        f"{plain['loss']:.7f} (tol {TRAIN_LOSS_TOL}); plain repeated max|d| "
        f"of gradients {again:.3g}; {len(real)} gradients held to "
        f"{TRAIN_GRAD_TOL} of their max: worst {_worst(g['gap'], real)}; "
        f"{len(g['zero'])} zero in exact arithmetic held under "
        f"{TRAIN_ZERO_TOL:g} of the largest: worst "
        f"{_worst(g['gap'], g['zero'], 1)}; AdamW moments: first worst "
        f"{_worst(held['mu']['gap'], held['mu']['gap'], 1)}, square root of "
        f"the second worst "
        f"{_worst(held['sqrt_nu']['gap'], held['sqrt_nu']['gap'], 1)}; BN "
        f"statistics max|d| {d_stats:.3g} (tol {TRAIN_STATS_TOL}); parameters "
        f"after AdamW max|d| {d_params:.3g} (tol {PARAM_TOL:g})")
    over = {k: h["over"] for k, h in held.items() if h["over"]}
    failed = []
    if launches != launches_want(2 * PARITY_LAYERS):
        failed.append(f"launches {launches}")
    if (d_loss > TRAIN_LOSS_TOL or over or d_stats > TRAIN_STATS_TOL
            or d_params > PARAM_TOL):
        failed.append(f"loss {d_loss:.3g}, past their bounds {over}, "
                      f"statistics {d_stats:.3g}, parameters {d_params:.3g}")
    if failed:
        raise RuntimeError("4k (c): the kernels' Conformer train step "
                           f"disagrees with the plain one: {failed}")


def conformer_train_timed(ssl_sd: dict, noise: str, dev, card: str) -> None:
    """4k (d): bf16 XLSR_Conformer train steps at batch 32 with both chains:
    ms a step, the allocator's peak, one step's launches, busy share,
    device ms by kernel class, the chains' own device ms (profiled alone on
    the same batch) and the host chain's ms a batch."""
    import warnings

    from rtdsd_tpu_torch.data.host_augment import build_host_chain
    from rtdsd_tpu_torch.engine import steps
    from rtdsd_tpu_torch.ops.augment import augment
    from rtdsd_tpu_torch.ops.preemphasis import pre_emphasis

    waves, labels = train_batch(dev, TRAIN_BATCH)
    model = conformer_model(ssl_sd, torch.bfloat16, dev)
    state = steps.TrainState(model, steps.make_optimizer(model, TRAIN_LR, 1e-4))
    kw = conformer_step_kw()
    step = steps.make_train_step(**kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(2):
        step(state, waves, labels, TRAIN_SEED)
    torch.cuda.synchronize()
    times = []
    for _ in range(TRAIN_STEPS_TIMED):
        t0 = time.perf_counter()
        step(state, waves, labels, TRAIN_SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    reset_counters()
    step(state, waves, labels, TRAIN_SEED)
    launches = read_counters()
    rows, wall_ms = _profiled(lambda: step(state, waves, labels, TRAIN_SEED),
                              inference=False)
    busy = sum(r[1] for r in rows)

    def chains():
        gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
        x = augment(waves, kw["pre_aug_list"], gen)
        return augment(pre_emphasis(x, 0.97), kw["aug_list"], gen)
    aug_rows, aug_wall = _profiled(chains)
    aug_ms = sum(r[1] for r in aug_rows)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # the warning of a missing codec
        chain = build_host_chain(noise, 16000)
    host = waves.cpu().numpy()
    host_ms = []
    for i in range(3):
        rng = np.random.default_rng(i)
        t0 = time.perf_counter()
        np.stack([chain(w, rng) for w in host])
        host_ms.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times)
    log(f"4k (d) bf16 XLSR_Conformer train step, batch {TRAIN_BATCH} "
        f"({'+'.join(CONFORMER_AUGS)}, remat, fast_softmax off), {card}: "
        f"{median:.1f} ms median [{min(times):.1f}, {max(times):.1f}] of "
        f"{TRAIN_STEPS_TIMED} after 2 warm-ups; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} before the first step); "
        f"one step's launches {launches}; profiled step: kernels {busy:.1f} "
        f"ms, {sum(r[2] for r in rows)} kernel launches, wall {wall_ms:.1f} "
        f"ms (device busy {100 * busy / wall_ms:.1f}% under the profiler, "
        f"{100 * busy / median:.1f}% of the median unprofiled step)")
    log(f"  the chains alone on the batch (TST GAN AIR TMK, pre-emphasis, "
        f"ACN HPF LPF GAN TMK): kernels {aug_ms:.2f} ms "
        f"({100 * aug_ms / busy:.1f}% of the step's), "
        f"{sum(r[2] for r in aug_rows)} launches, wall {aug_wall:.1f} ms; "
        f"top: " + "; ".join(f"{k[:40]} {ms:.2f} ms x{n}" for k, ms, n in
                             sorted(aug_rows, key=lambda r: -r[1])[:4]))
    log(f"  host chain ({', '.join(type(t).__name__ for t in chain.transforms)}"
        f"; {NOISE_FILES} noise files) on {TRAIN_BATCH} four-second clips: "
        f"{statistics.median(host_ms):.1f} ms a batch, median of 3 "
        f"[{min(host_ms):.1f}, {max(host_ms):.1f}]")
    for cls, (ms, n) in sorted(by_class(rows).items(), key=lambda kv: -kv[1][0]):
        log(f"  class {cls:22s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<5d} {key[:90]}")
    if launches != launches_want(48, gelu=TRAIN_STEP_GELU):
        raise RuntimeError(f"4k (d): a train step launched {launches}")
    del state, model
    torch.cuda.empty_cache()


def conformer_train_path(ssl_pt: str, dev, card: str) -> dict:
    """Phase 4k; -> the launches of its train CLI epoch."""
    root = os.path.join(WORK, "train")
    pytree, ssl_sd = convert_ssl(ssl_pt)
    noise = write_noise(root)
    launches = conformer_train_cli(write_conformer_train_config(root, pytree,
                                                                noise))
    torch.cuda.empty_cache()
    shutil.rmtree(pytree)
    conformer_parity(ssl_sd, dev)
    conformer_train_timed(ssl_sd, noise, dev, card)
    return launches


# ------------------------------------------------------------ phase 4l

KD_RECIPE = os.path.join("configs", "kd_xlsr6_aasist.yaml")
KD_SAMPLES = 16000                  # the recipe's 1 s crops
KD_ORDER = [0, 1, 2, 3, 4, 23]      # the recipe's student layers
# on the card every kernel of the path: fused GAT, the attention kernel
KD_MODEL_KWARGS = {"fused_gat": True, "w2v": {"fast_softmax": False}}
# the float32 kernels-vs-plain KD step: a 4-layer teacher (the first four
# layers at full width, the gate of 4j (a)) and a 2-layer student
KD_PARITY_ORDER = [0, 3]
KD_PARITY_KWARGS = {
    "ce_loss_weight": 1.0,
    "kd_criterions": [
        {"key": "KDLoss", "kwargs": {"student_module_path": "logits",
                                     "teacher_module_path": "logits",
                                     "temperature": 4.0}},
        {"key": "MSELoss", "kwargs": {
            "student_module_path": "ssl_model.model.encoder.layers.1",
            "teacher_module_path": "ssl_model.model.encoder.layers.3"}}],
    "kd_criterion_weights": [0.5, 1.0]}
KD_OPT_STEPS = 3                    # timed steps of each optimizer in 4l (d)


def kd_recipe() -> tuple:
    """(ExpConfig, kd_kwargs) of ``configs/kd_xlsr6_aasist.yaml``, its
    student kwargs with the kernels on the path."""
    from rtdsd_tpu_torch.config import load_yaml_config

    _, exp = load_yaml_config(os.path.join(ROOT, KD_RECIPE))
    kd = json.loads(json.dumps(exp.kd_kwargs))
    kd["student_kwargs"] = {**kd["student_kwargs"], **KD_MODEL_KWARGS}
    return exp, kd


def write_kd_config(root: str, ssl_pt: str) -> str:
    """The recipe (XLSR_AASIST teacher, My_XLSR_AASIST student, its
    kd_kwargs, RawBoost4, lr, 1 s crops) on 4j's clips at batch 32, bf16,
    the student's SSL init from 4j's fairseq ``.pt``."""
    exp, kd = kd_recipe()
    audio = os.path.join(root, "audio")
    cfg = {"SysConfig": {
        "model": "XLSR_AASIST", "student_model": "My_XLSR_AASIST",
        "wandb_disabled": True, "num_workers": 4,
        "path_label_asv_spoof_2019_la_train": os.path.join(root, "LA_T.txt"),
        "path_asv_spoof_2019_la_train": audio,
        "path_label_asv_spoof_2019_la_dev": os.path.join(root, "LA_D.txt"),
        "path_asv_spoof_2019_la_dev": audio,
        "path_label_asv_spoof_2019_la_eval": os.path.join(root, "LA_D.txt"),
        "path_asv_spoof_2019_la_eval": audio,
        "la19_score_save_path": os.path.join(root, "kd_scores_la19.txt"),
        "path_to_save_model": os.path.join(root, "kd_runs"),
        "ssl_ckpt_path": ssl_pt, "ssl_pytree_path": ""},
        "ExpConfig": {
            "random_seed": exp.random_seed,
            "train_duration_sec": exp.train_duration_sec,
            "test_duration_sec": exp.test_duration_sec,
            "la19_eval_random_start": False,
            "batch_size_train": TRAIN_BATCH, "batch_size_test": TRAIN_BATCH,
            "lr": exp.lr, "weight_decay": exp.weight_decay,
            "allow_data_augmentation": exp.allow_data_augmentation,
            "data_augmentation": list(exp.data_augmentation),
            "compute_dtype": exp.compute_dtype, "kwargs": KD_MODEL_KWARGS,
            "kd_kwargs": kd}}
    path = os.path.join(root, "kd.json")
    with open(path, "w") as f:
        # PyYAML reads 1e-06 as a string: YAML 1.1 floats need a dot
        f.write(json.dumps(cfg, indent=1).replace(": 1e-06", ": 1.0e-06"))
    return path


@contextlib.contextmanager
def copy_checked(found: dict):
    """Wrap the KD CLI's teacher-to-student copy: right after it, before
    the first step, the student's layer j must equal the teacher's layer
    ``indices[j]`` bit for bit, every other student parameter the
    teacher's of its name, and its BatchNorm statistics their init."""
    from rtdsd_tpu_torch.cli import main_kd

    saved = main_kd.copy_teacher_weights

    def checked(student, teacher, indices):
        copied = saved(student, teacher, indices)
        s_sd, t_sd = student.state_dict(), teacher.state_dict()
        layer = "ssl_model.model.encoder.layers."
        unequal, stats_moved = [], []
        for k, v in s_sd.items():
            if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                init = 1 if k.endswith("running_var") else 0
                if not torch.equal(v, torch.full_like(v, init)):
                    stats_moved.append(k)
                continue
            src = k
            if k.startswith(layer):
                j, rest = k[len(layer):].split(".", 1)
                src = f"{layer}{indices[int(j)]}.{rest}"
            if not torch.equal(v, t_sd[src]):
                unequal.append(k)
        found.update(indices=list(indices), copied=len(copied),
                     params=len(list(student.parameters())),
                     unequal=unequal, stats_moved=stats_moved)
        return copied

    main_kd.copy_teacher_weights = checked
    try:
        yield
    finally:
        main_kd.copy_teacher_weights = saved


def kd_cli(ckpt: str, ssl_pt: str, card: str) -> dict:
    """4l (a): ``cli.main_kd --max_epoch 1`` with the seed-0 full-width
    XLSR_AASIST as the teacher (``--ckpt``, a reference ``.pt``) and the
    recipe's student, then ``--is_eval --eval student --is_score`` from
    ``last_kd/`` in bf16 and ``--w8a8``, each with the counters zeroed
    just before; -> the epoch's launches."""
    from rtdsd_tpu_torch.cli import main_kd

    root = os.path.join(WORK, "train")
    cfg = write_kd_config(root, ssl_pt)
    found = {}
    reset_counters()
    t0 = time.perf_counter()
    with copy_checked(found):
        main_kd.main(["--config", cfg, "--ckpt", ckpt, "--max_epoch", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    steps_, dev_batches = TRAIN_CLIPS // TRAIN_BATCH, -(-DEV_CLIPS // TRAIN_BATCH)
    want = launches_want((24 + 6 + 6) * steps_ + 6 * dev_batches,
                         steps_ + dev_batches,
                         gelu=KD_STEP_GELU * steps_ + w2v_gelu(6) * dev_batches)
    runs = os.path.join(root, "kd_runs")
    with open(os.path.join(runs, "kd_metrics.jsonl")) as f:
        recs = [json.loads(l) for l in f]
    step_recs = [r for r in recs if "total_loss" in r]
    terms = ("total_loss", "ce_loss", "KDLoss_logits_logits",
             "MSELoss_ssl_hidden:5_ssl_hidden:23")
    last = os.path.join(runs, "last_kd")
    best = [n for n in os.listdir(runs) if n.startswith("student_best_epoch0_")]
    log(f"4l (a) KD CLI (bf16, XLSR_AASIST teacher from the seed-0 .pt, "
        f"My_XLSR_AASIST student, {KD_RECIPE}'s kd_kwargs + fused_gat and "
        f"fast_softmax off, RawBoost4, batch {TRAIN_BATCH}, 1 s crops, 1 "
        f"epoch: {steps_} steps + {dev_batches} dev batch): copy before the "
        f"first step {found}; {card}: launches {launches} (want {want}: 24 teacher "
        f"+ 6 + 6 student forward and recompute attention, 2 + 4 teacher "
        f"GAT and 32 + 20 GELU a step, 6, 2, 4 and 14 a dev batch); logged "
        + "; ".join(", ".join(f"{k} {r[k]:.5g}" for k in terms)
                    for r in step_recs)
        + f"; dev {[(r['Dev Loss'], r['Dev Acc']) for r in recs if 'Dev Loss' in r]}"
        f"; last_kd/ {sorted(os.listdir(last))}, {best}; wall {wall:.1f} s "
        f"incl. the teacher load, the student's SSL load and the saves")
    if (found.get("indices") != KD_ORDER or found["unequal"]
            or found["stats_moved"] or found["copied"] != found["params"]):
        raise RuntimeError(f"4l (a): the teacher-to-student copy: {found}")
    if launches != want:
        raise RuntimeError(f"KD launches {launches} != {want}")
    if len(step_recs) != steps_ or not all(
            np.isfinite(r[k]) for r in step_recs for k in terms):
        raise RuntimeError(f"KD step records {step_recs}")
    if sorted(os.listdir(last)) != ["meta.json", "state.pt"] or len(best) != 1:
        raise RuntimeError(f"KD checkpoints {os.listdir(runs)}")
    for mode, quant in (("bf16", 0), ("w8a8", 36)):
        scores = os.path.join(root, f"kd_scores_la19_{mode}.txt")
        reset_counters()
        main_kd.main(["--config", cfg, "--is_eval", "--eval", "student",
                      "--is_score", "--ckpt", last, "--tracks", "LA19",
                      "--comment", mode] + (["--w8a8"] if quant else []))
        torch.cuda.synchronize()
        got = read_counters()
        with open(scores) as f:
            vals = np.array([float(l.split(" ")[1]) for l in f])
        want = launches_want(6 * dev_batches, dev_batches, quant,
                             w2v_gelu(6) * dev_batches)
        log(f"4l (a) student scoring from last_kd/ ({mode}), {card}: {len(vals)} "
            f"scores, finite {int(np.isfinite(vals).sum())}, |score| max "
            f"{np.abs(vals).max():.4g}; launches {got} (want {want})")
        if len(vals) != DEV_CLIPS or not np.all(np.isfinite(vals)) \
                or got != want:
            raise RuntimeError(f"4l (a): student scoring ({mode}) failed")
    shutil.copytree(last, os.path.join(WORK, "kd_last"), dirs_exist_ok=True)
    shutil.rmtree(runs)
    return launches


def kd_models(sd: dict, dtype: torch.dtype, dev, teacher_layers=None,
              order=None):
    """(teacher in eval mode, student in train mode with remat) on the
    seed-0 weights: the teacher XLSR_AASIST (or its first
    ``teacher_layers`` layers), the student My_XLSR_AASIST on ``order``
    (the recipe's by default) initialised from TRAIN_SEED and filled from
    the teacher by ``copy_teacher_weights``, the kernels on the path."""
    from rtdsd_tpu_torch.engine.kd import copy_teacher_weights
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.registry import get_model
    from rtdsd_tpu_torch.models.wav2vec2 import select_layers
    from rtdsd_tpu_torch.models.zoo import init_weights

    order = order or KD_ORDER
    ref = load_reference_state_dict(sd)
    if teacher_layers:
        t_spec = get_model("My_XLSR_AASIST", dtype=dtype,
                           num_layers=teacher_layers, **KD_MODEL_KWARGS)
        ref = select_layers(ref, t_spec.layer_indices)
    else:
        t_spec = get_model("XLSR_AASIST", dtype=dtype, **KD_MODEL_KWARGS)
    teacher = t_spec.module
    teacher.load_state_dict(ref, strict=True)
    teacher.to(dev).eval().requires_grad_(False)
    s_spec = get_model("My_XLSR_AASIST", dtype=dtype, remat=True,
                       num_layers=len(order), order="custom",
                       custom_order=order, **KD_MODEL_KWARGS)
    init_weights(s_spec.module, TRAIN_SEED)
    student = s_spec.module.to(dev).train()
    copy_teacher_weights(student, teacher, order)
    return teacher, student


def kd_batch(dev, n: int):
    """``n`` of 4j's clips cut to the recipe's 1 s (their first second)."""
    waves, labels = train_batch(dev, n)
    return waves[:, :KD_SAMPLES].contiguous(), labels


def _kd_step_outputs(teacher, student, ref, waves, labels, step) -> dict:
    """One KD step of ``student`` from ``ref`` on a fresh AdamW: the
    metrics, gradients, state after the step and AdamW's moments."""
    from rtdsd_tpu_torch.engine import steps

    student.load_state_dict(ref, strict=True)
    state = steps.TrainState(student, steps.make_optimizer(student, TRAIN_LR,
                                                           1e-4))
    metrics = {k: float(v) for k, v in
               step(state, teacher, waves, labels, TRAIN_SEED).items()}
    params = dict(student.named_parameters())
    out = {"metrics": metrics,
           "grads": {n: p.grad.detach().clone() for n, p in params.items()},
           "state": {k: v.detach().clone()
                     for k, v in student.state_dict().items()},
           "mu": {n: state.optimizer.state[p]["exp_avg"].clone()
                  for n, p in params.items()},
           "sqrt_nu": {n: state.optimizer.state[p]["exp_avg_sq"].sqrt()
                       for n, p in params.items()}}
    del state
    return out


def kd_parity(sd: dict, dev, card: str) -> None:
    """4l (b): one float32 KD step (TF32 off, deterministic algorithms) at
    batch 4, 1 s clips, RawBoost4, a 4-layer full-width teacher and a
    2-layer student (layers 0 and 3), with the kernels against the same
    step with the plain versions: every loss term within TRAIN_LOSS_TOL,
    the student's gradients and AdamW's moments within TRAIN_GRAD_TOL of
    their max (``held_per_tensor``), its statistics and parameters as 4j
    (a); the teacher bit for bit unchanged; then every kernel call of a
    third step held to its plain version on the same inputs."""
    from rtdsd_tpu_torch.engine import kd

    waves, labels = kd_batch(dev, PARITY_BATCH)
    teacher, student = kd_models(sd, torch.float32, dev,
                                 teacher_layers=PARITY_LAYERS,
                                 order=KD_PARITY_ORDER)
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    ref = {k: v.detach().clone() for k, v in student.state_dict().items()}
    step = kd.make_kd_train_step(KD_PARITY_KWARGS, rawboost_algo=4)
    runs, launches = {}, None
    with deterministic():
        for name, ctx in (("kernels", contextlib.nullcontext),
                          ("plain", plain_kernels), ("again", plain_kernels)):
            reset_counters()
            with ctx():
                runs[name] = _kd_step_outputs(teacher, student, ref, waves,
                                              labels, step)
            if name == "kernels":
                launches = read_counters()
        worst = {}
        with kernels_held_to_plain(worst):
            _kd_step_outputs(teacher, student, ref, waves, labels, step)
    teacher_same = all(torch.equal(v, t_before[k])
                       for k, v in teacher.state_dict().items())
    del teacher, student
    torch.cuda.empty_cache()
    plain, got = runs["plain"], runs["kernels"]
    d_terms = {k: abs(got["metrics"][k] - plain["metrics"][k])
               for k in plain["metrics"] if k != "num_correct"}
    held = {k: held_per_tensor(got[k], plain[k], TRAIN_GRAD_TOL)
            for k in ("grads", "mu", "sqrt_nu")}
    g = held["grads"]
    real = [n for n in g["gap"] if n not in g["zero"]]
    again = max(float((runs["again"]["grads"][n] - t).abs().max())
                for n, t in plain["grads"].items())
    d_stats, d_params = _stats_and_params(got["state"], plain["state"])
    want = launches_want(PARITY_LAYERS + 2 * len(KD_PARITY_ORDER), 1)
    log(f"4l (b) f32 KD step, teacher layers 0-{PARITY_LAYERS - 1} and "
        f"student layers {KD_PARITY_ORDER} at full width, batch "
        f"{PARITY_BATCH}, 1 s, RawBoost4 (gated), {card}: launches {launches} (want "
        f"{want}); loss terms kernels "
        + ", ".join(f"{k} {got['metrics'][k]:.7f}" for k in d_terms)
        + f"; max|d| against plain {max(d_terms.values()):.3g} (tol "
        f"{TRAIN_LOSS_TOL}); plain repeated max|d| of gradients {again:.3g}; "
        f"{len(real)} gradients held to {TRAIN_GRAD_TOL} of their max: worst "
        f"{_worst(g['gap'], real)}; {len(g['zero'])} zero in exact "
        f"arithmetic: worst {_worst(g['gap'], g['zero'], 1)}; AdamW moments: "
        f"first worst {_worst(held['mu']['gap'], held['mu']['gap'], 1)}, "
        f"square root of the second worst "
        f"{_worst(held['sqrt_nu']['gap'], held['sqrt_nu']['gap'], 1)}; BN "
        f"statistics max|d| {d_stats:.3g}; parameters max|d| {d_params:.3g}; "
        f"teacher unchanged bit for bit: {teacher_same}")
    log_held(f"4l (b) every kernel call of a KD step, {card}", worst)
    over = {k: h["over"] for k, h in held.items() if h["over"]}
    failed = []
    if launches != want:
        failed.append(f"launches {launches}")
    if (max(d_terms.values()) > TRAIN_LOSS_TOL or over
            or d_stats > TRAIN_STATS_TOL or d_params > PARAM_TOL):
        failed.append(f"terms {d_terms}, past their bounds {over}, "
                      f"statistics {d_stats:.3g}, parameters {d_params:.3g}")
    if not teacher_same:
        failed.append("the teacher changed")
    if failed:
        raise RuntimeError(f"4l (b): the kernels' KD step disagrees with the "
                           f"plain one: {failed}")


def kd_timed(sd: dict, dev, card: str) -> None:
    """4l (c): bf16 KD steps of the recipe at batch 32, 1 s clips: ms a
    step, the allocator's peak, one step's launches, busy share, device ms
    by kernel class, and the teacher's forward alone on the batch."""
    from rtdsd_tpu_torch.engine import kd, steps
    from rtdsd_tpu_torch.ops.preemphasis import pre_emphasis

    _, recipe = kd_recipe()
    waves, labels = kd_batch(dev, TRAIN_BATCH)
    teacher, student = kd_models(sd, torch.bfloat16, dev)
    state = steps.TrainState(student, steps.make_optimizer(student, TRAIN_LR,
                                                           1e-4))
    step = kd.make_kd_train_step(recipe, rawboost_algo=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(2):
        step(state, teacher, waves, labels, TRAIN_SEED)
    torch.cuda.synchronize()
    times = []
    for _ in range(TRAIN_STEPS_TIMED):
        t0 = time.perf_counter()
        m = step(state, teacher, waves, labels, TRAIN_SEED)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    reset_counters()
    step(state, teacher, waves, labels, TRAIN_SEED)
    launches = read_counters()
    rows, wall_ms = _profiled(
        lambda: step(state, teacher, waves, labels, TRAIN_SEED),
        inference=False)
    busy = sum(r[1] for r in rows)
    pre = pre_emphasis(waves, 0.97)
    t_rows, t_wall = _profiled(lambda: teacher(pre))
    t_ms = sum(r[1] for r in t_rows)
    median = statistics.median(times)
    log(f"4l (c) bf16 KD step, batch {TRAIN_BATCH}, 1 s clips (24-layer "
        f"teacher, student layers {KD_ORDER}, RawBoost4, KDLoss + MSELoss, "
        f"remat, fused_gat, fast_softmax off), {card}: {median:.1f} ms median "
        f"[{min(times):.1f}, {max(times):.1f}] of {TRAIN_STEPS_TIMED} after 2 "
        f"warm-ups (last total_loss {float(m['total_loss']):.5g}); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({base / 2**30:.2f} "
        f"before the first step); one step's launches {launches}; profiled "
        f"step: kernels {busy:.1f} ms, {sum(r[2] for r in rows)} kernel "
        f"launches, wall {wall_ms:.1f} ms (device busy "
        f"{100 * busy / wall_ms:.1f}% under the profiler, "
        f"{100 * busy / median:.1f}% of the median unprofiled step); the "
        f"teacher's forward alone: {t_ms:.2f} ms of kernels "
        f"({100 * t_ms / busy:.1f}% of the step's), "
        f"{sum(r[2] for r in t_rows)} launches, wall {t_wall:.1f} ms")
    for cls, (ms, n) in sorted(by_class(rows).items(), key=lambda kv: -kv[1][0]):
        log(f"  class {cls:22s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<5d} {key[:90]}")
    if launches != launches_want(36, 1, gelu=KD_STEP_GELU):
        raise RuntimeError(f"4l (c): a KD step launched {launches}")
    if not all(np.isfinite(float(v)) for v in m.values()):
        raise RuntimeError(f"4l (c): KD step metrics {m}")
    del state, student, teacher
    torch.cuda.empty_cache()


def optimizer_timed(sd: dict, dev, card: str) -> None:
    """4l (d): 4j's bf16 train step (the default recipe, batch 32, 4 s
    clips) with AdamW, ``adam_mu_dtype: bfloat16`` and Adafactor: ms a step
    (median [min, max] of KD_OPT_STEPS after a warm-up) and the
    allocator's peak. Information."""
    from rtdsd_tpu_torch.engine import steps

    waves, labels = train_batch(dev, TRAIN_BATCH)
    model = train_model(sd, torch.bfloat16, dev)
    ref = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = steps.make_train_step(rawboost_algo=4)
    out = []
    for name, kw in (("AdamW float32", {}),
                     ("adam_mu_dtype bfloat16", {"mu_dtype": "bfloat16"}),
                     ("Adafactor", {"optimizer": "adafactor"})):
        model.load_state_dict(ref, strict=True)
        state = steps.TrainState(model, steps.make_optimizer(
            model, TRAIN_LR, 1e-4, **kw))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(state, waves, labels, TRAIN_SEED)["loss"])]
        times = []
        for _ in range(KD_OPT_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(state, waves, labels,
                                     TRAIN_SEED)["loss"]))
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        opt_bytes = sum(t.numel() * t.element_size()
                        for st in state.optimizer.state.values()
                        for t in st.values() if torch.is_tensor(t))
        out.append(f"{name} {statistics.median(times):.1f} ms "
                   f"[{min(times):.1f}, {max(times):.1f}], peak "
                   f"{peak / 2**30:.2f} GiB, optimizer state "
                   f"{opt_bytes / 2**30:.3f} GiB, losses "
                   f"{', '.join(f'{l:.4f}' for l in losses)}")
        if not np.all(np.isfinite(losses)):
            raise RuntimeError(f"4l (d) {name}: losses {losses}")
        del state
    log(f"4l (d) 4j's bf16 train step (XLSR_AASIST, batch {TRAIN_BATCH}, 4 s, "
        f"RawBoost4) by optimizer, median [min, max] of {KD_OPT_STEPS} after "
        f"a warm-up, {card} (information): " + "; ".join(out))
    del model
    torch.cuda.empty_cache()


def kd_path(ckpt: str, ssl_pt: str, sd: dict, dev, card: str) -> dict:
    """Phase 4l; -> the launches of its KD CLI epoch."""
    t0 = time.perf_counter()
    launches = kd_cli(ckpt, ssl_pt, card)
    torch.cuda.empty_cache()
    kd_parity(sd, dev, card)
    kd_timed(sd, dev, card)
    optimizer_timed(sd, dev, card)
    log(f"4l: {time.perf_counter() - t0:.1f} s, {card}")
    return launches


# ------------------------------------------------------------ phase 4m

# runs a CLI module in this fresh process, then writes its launch counters
# and the model-defining modules it imported to argv[1] as JSON
COUNTED_RUN = r"""
import json, runpy, sys
out, mod = sys.argv[1], sys.argv[2]
sys.argv = [mod] + sys.argv[3:]
code = 0
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
except SystemExit as e:
    code = e.code or 0
models = sorted(m for m in sys.modules if m in (
    "rtdsd_tpu_torch.models.wav2vec2", "rtdsd_tpu_torch.models.aasist",
    "rtdsd_tpu_torch.models.conformer", "rtdsd_tpu_torch.models.zoo")
    or m.split(".")[0] in ("jax", "flax", "rtdsd_tpu"))
import torch
from rtdsd_tpu_torch.ops import attention, convstack, fastgelu, gat, quant
if torch.cuda.is_available():
    torch.cuda.synchronize()
with open(out, "w") as f:
    json.dump({"models": models, "launches": {fn.__name__: fn.launches for fn in (
        attention.mha_small_t, gat.fused_gat_aggregate,
        gat.fused_htrg_gat_aggregate, quant.quantize_int8, convstack.ln_gelu,
        convstack.conv_ln_gelu_grouped, fastgelu.gelu_fast)}}, f)
sys.exit(code)
"""


def run_counted(module: str, args: list, tag: str) -> tuple:
    """``python -m module args`` in a fresh process, counted -> (launches,
    stdout, wall s, model-defining modules it imported)."""
    out = os.path.join(WORK, "export", f"{tag}.counts.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", COUNTED_RUN, out, module,
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise RuntimeError(f"{module} {tag}: rc {proc.returncode}\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    with open(out) as f:
        got = json.load(f)
    return got["launches"], proc.stdout, wall, got["models"]


def _sizes(prefix: str, exts) -> str:
    return ", ".join(f"{e} {os.path.getsize(prefix + e) / 2**20:.2f} MiB"
                     for e in exts)


def _score_file(path: str) -> dict:
    with open(path) as f:
        return {l.split(" ")[0]: float(l.split(" ")[1])
                for l in f.read().splitlines()}


def _held_scores(what: str, got: dict, want: dict) -> float:
    """max |d| of two {id: score} maps over the same ids, gated at the
    CLI-versus-forward check of main(): 0.05 x max(1, max |score|)."""
    if sorted(got) != sorted(want) or not np.all(np.isfinite(list(got.values()))):
        raise RuntimeError(f"{what}: ids or finite scores differ")
    d = max(abs(got[k] - want[k]) for k in want)
    scale = max(1.0, max(abs(v) for v in want.values()))
    if d > 0.05 * scale:
        raise RuntimeError(f"{what}: max|d| {d} > 0.05 x {scale}")
    return d


def export_batch(ckpt: str, cli_scores: dict, card: str) -> dict:
    """4m (a): ``cli.export`` in a fresh process on 4a's bf16 ``.pt``
    (``--batch sym --platforms cuda``), then ``cli.infer`` in another on
    4a's 32 clips, held to 4a's CLI scores; then 4l's student from
    ``last_kd/`` (``--student --w8a8 --batch 32``, in this process) and
    its artifact on 4l's dev clips, held to 4l's ``--w8a8`` student
    scores. -> the launches of the four runs."""
    from rtdsd_tpu_torch.cli import export, infer

    root = os.path.join(WORK, "export")
    art = os.path.join(root, "xlsr_aasist.tpex")
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    e_launches, _, e_wall, _ = run_counted(
        "rtdsd_tpu_torch.cli.export",
        ["--config", write_config(WORK, "bfloat16"), "--ckpt", ckpt, "--batch",
         "sym", "--platforms", "cuda", "--out", art], "export")
    meta = json.load(open(art + ".json"))
    files = [os.path.join(WORK, "audio", f"{u}.flac") for u in sorted(cli_scores)]
    out = os.path.join(root, "infer_scores.txt")
    i_launches, _, i_wall, models = run_counted(
        "rtdsd_tpu_torch.cli.infer",
        ["--artifact", art, "--audio", *files, "--batch_size", str(B), "--out",
         out], "infer")
    d = _held_scores("4m (a) infer", _score_file(out), cli_scores)
    batches = -(-N_CLIPS // B)
    want = launches_want(24 * batches, batches, gelu=w2v_gelu(24) * batches)
    log(f"4m (a) cli.export (fresh process) XLSR_AASIST bf16 --batch sym "
        f"--platforms cuda: wall {e_wall:.1f} s incl. start, load and trace; "
        f"program {meta['artifact_bytes'] / 2**20:.3f} MiB, params "
        f"{meta['params_bytes'] / 2**20:.1f} MiB, in_avals {meta['in_avals']}; "
        f"launches {e_launches}; cli.infer (fresh process) on {len(files)} "
        f"clips at batch {B}: wall {i_wall:.1f} s incl. start, program and "
        f"sidecar load; scores vs 4a's CLI scores max|d| {d:.4g} (tol 0.05 x "
        f"max(1, |score|)); launches {i_launches} (want {want}); model or JAX "
        f"modules imported by infer: {models}; {card}")
    if e_launches != launches_want() or i_launches != want or models:
        raise RuntimeError("4m (a): export or infer launches or imports")
    add(e_launches)
    add(i_launches)

    train = os.path.join(WORK, "train")
    sart = os.path.join(root, "student_w8a8.tpex")
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        export.main(["--config", os.path.join(train, "kd.json"), "--ckpt",
                     os.path.join(WORK, "kd_last"), "--student", "--w8a8",
                     "--batch", str(TRAIN_BATCH), "--platforms", "cuda",
                     "--out", sart])
    torch.cuda.synchronize()
    se_wall, se_launches = time.perf_counter() - t0, read_counters()
    smeta = json.load(open(sart + ".json"))
    want_kd = _score_file(os.path.join(train, "kd_scores_la19_w8a8.txt"))
    sfiles = [os.path.join(train, "audio", f"{u}.flac") for u in sorted(want_kd)]
    sout = os.path.join(root, "student_infer_scores.txt")
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        infer.main(["--artifact", sart, "--audio", *sfiles, "--out", sout])
    torch.cuda.synchronize()
    si_wall, si_launches = time.perf_counter() - t0, read_counters()
    d = _held_scores("4m (a) student infer", _score_file(sout), want_kd)
    sb = -(-len(sfiles) // TRAIN_BATCH)
    want_s = launches_want(6 * sb, sb, gelu=w2v_gelu(6) * sb)
    log(f"4m (a) student (last_kd/, --student --w8a8 --batch {TRAIN_BATCH}, "
        f"4l's scoring batch): export wall "
        f"{se_wall:.1f} s, program {smeta['artifact_bytes'] / 2**20:.3f} MiB, "
        f"params {smeta['params_bytes'] / 2**20:.1f} MiB (int8 vals), launches "
        f"{se_launches} (want 36 quantize_int8); infer on {len(sfiles)} dev "
        f"clips: wall {si_wall:.1f} s, scores vs 4l's --w8a8 student scores "
        f"max|d| {d:.4g}; launches {si_launches} (want {want_s})")
    if se_launches != launches_want(quantize=36) or si_launches != want_s:
        raise RuntimeError("4m (a): student export or infer launches")
    add(se_launches)
    add(si_launches)
    return total


def export_stream(ckpt: str, incremental: dict) -> dict:
    """4m (b): ``cli.export --streaming`` of 4a's model (4 s windows, 2 s
    hop, --platforms cuda), then ``cli.infer --per_window --batch_size 8``
    on 4g's 16 kHz files (4g's batches): windows at 4g's incremental starts,
    scores within 0.05 x max(1, |score|) of ``cli.stream --incremental``'s.
    -> launches of export and infer."""
    from rtdsd_tpu_torch.cli import export, infer

    prefix = os.path.join(WORK, "export", "stream_art")
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        export.main(["--config", write_config(WORK, "bfloat16"), "--ckpt", ckpt,
                     "--streaming", "--hop_sec", str(STREAM_HOP / 16000),
                     "--platforms", "cuda", "--out", prefix])
    torch.cuda.synchronize()
    e_wall, e_launches = time.perf_counter() - t0, read_counters()
    paths = [p for p in incremental
             if os.path.basename(p) in ("long.wav", "short.wav")]
    buf = io.StringIO()
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        infer.main(["--artifact", prefix, "--audio", *paths, "--per_window",
                    "--batch_size", str(STREAM_BATCH)])
    torch.cuda.synchronize()
    i_wall, launches = time.perf_counter() - t0, read_counters()
    worst, n = 0.0, 0
    for path in paths:
        uid = os.path.splitext(os.path.basename(path))[0]
        got = [l.split(" ") for l in buf.getvalue().splitlines()
               if l.startswith(uid + "#")]
        want = incremental[path]
        if [g[1] for g in got] != [f"{s / 16000:.2f}" for s in sorted(want)]:
            raise RuntimeError(f"4m (b) {uid}: windows {[g[1] for g in got]}")
        for g, s in zip(got, sorted(want)):
            worst = max(worst, abs(float(g[2]) - want[s]) / max(1.0, abs(want[s])))
            n += 1
    calls = sum(-(-len(incremental[p]) // STREAM_BATCH) for p in paths)
    # the conv program once a file, the score program once a call
    want_l = launches_want(24 * calls, calls, gelu=FRONTEND_GELU * len(paths)
                           + (1 + 24) * calls)
    log(f"4m (b) streaming bundle: export wall {e_wall:.1f} s ("
        f"{_sizes(prefix, ('.conv', '.score', '.params'))}), launches "
        f"{e_launches}; infer --per_window --batch_size {STREAM_BATCH} on "
        f"{len(paths)} files, {n} windows in {calls} score calls: wall "
        f"{i_wall:.2f} s; vs cli.stream "
        f"--incremental (batch {STREAM_BATCH}) max |d| / max(1, |score|) "
        f"{worst:.3g} (tol 0.05); launches {launches} (want {want_l})")
    if worst > 0.05 or launches != want_l or e_launches != launches_want():
        raise RuntimeError("4m (b): streaming bundle scores or launches")
    return launches


def export_engine_ticks(eng, bank: list, streams: int) -> tuple:
    """SERVE_TICKS ticks paced to the hop on ``streams`` streams (one
    second of audio first) -> (tick ms list, device ms a tick)."""
    hs = [eng.open_stream(i) for i in range(streams)]
    waves = [np.roll(bank[i % len(bank)], 800 * i) for i in range(streams)]
    pos = [0]

    def tick():
        c = pos[0]
        for h, w in zip(hs, waves):
            eng.push(h, w[c:c + SERVE_HOP])
        pos[0] = c + SERVE_HOP
        return eng.poll()

    tick(), tick()
    counts0 = dict(eng.dispatch_counts)
    ticks, start = [], time.perf_counter()
    for k in range(SERVE_TICKS):
        t0 = time.perf_counter()
        tick()
        ticks.append((time.perf_counter() - t0) * 1e3)
        rest = start + (k + 1) * SERVE_HOP / 16000 - time.perf_counter()
        if rest > 0:
            time.sleep(rest)
    costs = eng.device_costs(n=3)
    dev_ms = sum(costs.get(k, 0.0) * (v - counts0[k]) / SERVE_TICKS
                 for k, v in eng.dispatch_counts.items())
    for h in hs:
        eng.close_stream(h)
    return ticks, dev_ms


def export_serving(ckpt: str, screener_ckpt: str, sd: dict, screener_sd: dict,
                   dev, files: dict, band: tuple, card: str) -> dict:
    """4m (c): ``cli.export --serving`` at 4h's geometry (512 streams, 1 s
    windows, 0.5 s hop, bf16, int16) with 4h's cascade (the screener
    primary, 4a's XLSR_AASIST escalating over 4h's band); the artifact
    engine against the checkpoint-backed engine at the same fixed shapes
    on 4h's 32 files (the same windows, flags and dispatch counts, scores
    within 0.05 x max(1, |score|)); both engines timed in turns at 512
    streams; then ``cli.serve --artifact`` and ``cli.daemon --artifact``
    (a SIGHUP reload from the sidecars) with exact launches. -> launches
    of export, serve and daemon."""
    from rtdsd_tpu_torch.cli import export
    from rtdsd_tpu_torch.engine.serving import MultiStreamScorer

    center, half = band
    prefix = os.path.join(WORK, "export", "serve_art")
    cfg_s = write_config(WORK, "bfloat16", "My_XLSR_AASIST", SCREENER_KWARGS,
                         name="screener")
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        export.main(["--config", write_config(WORK, "bfloat16"), "--ckpt", ckpt,
                     "--serving", "--max_streams", "512", "--duration_sec",
                     str(SERVE_WINDOW / 16000), "--hop_sec",
                     str(SERVE_HOP / 16000), "--cascade_ckpt", screener_ckpt,
                     "--cascade_config", cfg_s, "--cascade_band", repr(half),
                     "--cascade_center", repr(center), "--platforms", "cuda",
                     "--out", prefix])
    torch.cuda.synchronize()
    e_wall, e_launches = time.perf_counter() - t0, read_counters()
    meta = json.load(open(prefix + ".json"))
    log(f"4m (c) serving bundle export (512 streams, extend "
        f"{meta['extend_batch']}, score {meta['score_batch']}, escalate "
        f"{meta['esc_batch']}, int16, cascade band {half:.4g} around "
        f"{center:.4g}): wall {e_wall:.1f} s, "
        f"{_sizes(prefix, ('.extend', '.score', '.escalate', '.params', '.esc.params'))}"
        f", launches {e_launches}")

    flagship = build_model(sd, torch.bfloat16, dev)
    screener = build_model(screener_sd, torch.bfloat16, dev, **SCREENER_BUILD)
    ckpt_eng = MultiStreamScorer(
        screener, screener.w2v_cfg, duration=SERVE_WINDOW, hop=SERVE_HOP,
        max_streams=512, escalate=flagship, escalate_band=half,
        escalate_center=center, transport_dtype="int16", extend_rungs=0,
        auto_provision=False)
    art_eng, _ = export.load_serving(prefix)
    waves = list(files.values())
    res = {}
    for name, eng in (("ckpt", ckpt_eng), ("artifact", art_eng)):
        eng.warmup()
        eng.dispatch_counts = dict.fromkeys(eng.dispatch_counts, 0)
        res[name] = serve_all(eng, waves)
    a, c = res["artifact"], res["ckpt"]
    same = sum(x[2] == y[2] for x, y in zip(a, c))
    d = max(abs(x[2] - y[2]) / max(1.0, abs(y[2])) for x, y in zip(a, c))
    counts = {n: {k: v for k, v in e.dispatch_counts.items() if v}
              for n, e in (("ckpt", ckpt_eng), ("artifact", art_eng))}
    log(f"4m (c) artifact engine vs checkpoint engine (fixed shapes), "
        f"{len(waves)} files: {len(a)} windows, {sum(x[3] for x in a)} "
        f"escalated; {same} scores equal bit for bit, max |d| / max(1, "
        f"|score|) {d:.3g} (tol 0.05); dispatches {counts}")
    if [x[:2] + x[3:] for x in a] != [y[:2] + y[3:] for y in c] or d > 0.05 \
            or counts["ckpt"] != counts["artifact"]:
        raise RuntimeError("4m (c): the artifact engine serves otherwise")
    rng = np.random.default_rng(5)
    bank = [_serve_wave(rng, SERVE_WINDOW + (SERVE_TICKS + 4) * SERVE_HOP, i)
            for i in range(32)]
    timed = {}
    for name, eng in (("ckpt", ckpt_eng), ("artifact", art_eng),
                      ("artifact", art_eng), ("ckpt", ckpt_eng)):
        ticks, dev_ms = export_engine_ticks(eng, bank, 512)
        eng.drain()
        timed.setdefault(name, []).append((ticks, dev_ms))
    log(f"4m (c) 512 streams with the cascade, {SERVE_TICKS} ticks paced to "
        f"the hop, in turns (ckpt, artifact, artifact, ckpt), {card}: " + "; ".join(
            f"{n} tick p50 {np.percentile(t, 50):.2f} / p95 "
            f"{np.percentile(t, 95):.2f} ms, device {dm:.2f} ms/tick"
            for n, runs in timed.items() for t, dm in runs))
    del ckpt_eng, art_eng, flagship, screener
    torch.cuda.empty_cache()

    total = dict(e_launches)
    r = run_serve(None, None, files, "artifact", source=["--artifact", prefix])
    n = dispatch_sums(r["eng"])
    score, esc = n["score"] + 1, n["escalate"] + 1
    want = launches_want(6 * score + 24 * esc, score + esc,
                         gelu=serve_gelu(r["eng"], r["warm"], 6, 24))
    marks = [m for ws in r["windows"].values() for w in ws for m in w[2]]
    tick = next(l for l in r["err"] if "tick p50" in l)
    log(f"4m (c) cli.serve --artifact: {sum(map(len, r['windows'].values()))} "
        f"windows, {marks.count('escalated')} escalated; dispatches "
        f"{r['eng'].dispatch_counts}; launches {r['launches']} (want {want}); "
        f"{tick.strip()}; CLI wall {r['wall']:.2f} s incl. program and "
        f"sidecar load")
    if r["launches"] != want:
        raise RuntimeError(f"kernel launches {r['launches']} != {want}")
    for k, v in r["launches"].items():
        total[k] = total.get(k, 0) + v
    for k, v in daemon_artifact(prefix, files).items():
        total[k] = total.get(k, 0) + v
    return total


def daemon_artifact(prefix: str, files: dict) -> dict:
    """4m (c): ``cli.daemon --artifact`` in this (main) thread: 8 of 4h's
    files streamed through ``ServeClient``, SIGHUP (the weight sidecars
    read again), 8 more, SIGTERM; every window once and finite, the reload
    line, launches exactly (6 + 24 escalation) x the dispatches, the
    warm-ups' included -> launches."""
    import signal
    import threading

    from rtdsd_tpu_torch.cli import daemon as cli
    from rtdsd_tpu_torch.engine.netserve import ServeClient

    sock = _sock_path("artifact.sock")
    err_path = os.path.join(WORK, "export", "daemon_artifact.stderr")
    engines, build = [], cli.build_engine
    state = {"errors": [], "windows": {}}
    paths = list(files)

    def capture(args, n):
        eng, sr = build(args, n)
        engines.append((eng, warm_dispatches(eng)))
        return eng, sr

    def text():
        with open(err_path) as f:
            return f.read()

    def wait_for(cond, what, timeout):
        deadline = time.monotonic() + timeout
        while not cond():
            if time.monotonic() > deadline:
                raise RuntimeError(f"daemon --artifact: {what}")
            time.sleep(0.05)

    def stream(batch):
        client = ServeClient(unix_path=sock)
        hs = {client.open(p): p for p in batch}
        for h, p in hs.items():
            client.push(h, files[p])
            client.close(h, flush=True)
        got = client.collect(set(hs))
        client.close_socket()
        for h, p in hs.items():
            state["windows"][p] = sorted(got[h])

    def drive():
        try:
            wait_for(lambda: os.path.exists(sock), "no socket", 300)
            stream(paths[:8])
            os.kill(os.getpid(), signal.SIGHUP)
            wait_for(lambda: "reloaded" in text(), "no reload line", 120)
            stream(paths[8:16])
        except Exception as e:      # raised after the stop
            state["errors"].append(e)
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    cli.build_engine = capture
    reset_counters()
    t0 = time.perf_counter()
    helper = threading.Thread(target=drive, daemon=True)
    try:
        with open(err_path, "w") as err, contextlib.redirect_stderr(err):
            helper.start()
            cli.main(["--artifact", prefix, "--listen", f"unix:{sock}",
                      "--stats_every", "0"])
    finally:
        cli.build_engine = build
        helper.join(60)
    torch.cuda.synchronize()
    launches, wall = read_counters(), time.perf_counter() - t0
    if state["errors"]:
        log(f"daemon --artifact stderr, its end:\n{text()[-4000:]}")
        raise state["errors"][0]
    eng, warm = engines[0]
    n = dispatch_sums(eng)
    score, esc = n["score"] + 1, n["escalate"] + 1
    want = launches_want(6 * score + 24 * esc, score + esc,
                         gelu=serve_gelu(eng, warm, 6, 24))
    wins = {p: [s for s, _, _ in w] for p, w in state["windows"].items()}
    ok = all(wins[p] == serve_starts(len(files[p])) and
             np.all(np.isfinite([v for _, v, _ in state["windows"][p]]))
             for p in wins)
    log(f"4m (c) cli.daemon --artifact: 16 files over the socket, 8 before "
        f"and 8 after a SIGHUP, {sum(map(len, wins.values()))} windows once "
        f"each and finite: {ok}; "
        + next(l for l in text().splitlines() if "reloaded" in l).strip()
        + f"; dispatches {eng.dispatch_counts}; launches {launches} (want "
        f"{want}); wall {wall:.1f} s incl. program and sidecar load")
    if not ok or launches != want or "[daemon] stopped" not in text():
        raise RuntimeError("4m (c): daemon --artifact windows or launches")
    return launches


def export_path(ckpt: str, screener_ckpt: str, sd: dict, screener_sd: dict,
                dev, cli_scores: dict, incremental: dict, serve_waves: dict,
                band: tuple, card: str) -> dict:
    """Phase 4m; -> the launches of its exports and artifact runs."""
    os.makedirs(os.path.join(WORK, "export"), exist_ok=True)
    t0 = time.perf_counter()
    total = {}
    for launches in (export_batch(ckpt, cli_scores, card),
                     export_stream(ckpt, incremental),
                     export_serving(ckpt, screener_ckpt, sd, screener_sd, dev,
                                    serve_waves, band, card)):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    shutil.rmtree(os.path.join(WORK, "kd_last"))
    log(f"4m: {time.perf_counter() - t0:.1f} s, {card}")
    return total


def frontend_path(sd: dict, dev) -> dict:
    """The op fused_conv_frontend at full width on the model's front-end
    weights, against the port's unfused ConvFeatureExtractor."""
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.wav2vec2 import (ConvFeatureExtractor,
                                                 Wav2Vec2Config)
    from rtdsd_tpu_torch.ops.convstack import fused_conv_frontend, supports_fused

    cfg = Wav2Vec2Config()
    if not supports_fused(cfg.conv_layers, cfg.extractor_mode):
        raise RuntimeError("supports_fused rejects the flagship front-end")
    prefix = "ssl_model.model.feature_extractor."
    fe_sd = {k[len(prefix):]: v for k, v in load_reference_state_dict(sd).items()
             if k.startswith(prefix)}
    lp = [{"conv": {"kernel": fe_sd[f"conv_layers.{i}.0.weight"].permute(2, 1, 0).to(dev),
                    "bias": fe_sd[f"conv_layers.{i}.0.bias"].to(dev)},
           "ln": {"scale": fe_sd[f"conv_layers.{i}.2.1.weight"].to(dev),
                  "bias": fe_sd[f"conv_layers.{i}.2.1.bias"].to(dev)}}
          for i in range(len(cfg.conv_layers))]
    waves = batch_waves(dev)
    out = {}
    with torch.inference_mode():
        for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            fe = ConvFeatureExtractor(cfg, dtype)
            fe.load_state_dict(fe_sd, strict=True)
            out[kind] = fe.to(dev)(waves).float()
        reset_counters()
        fused = {kind: fused_conv_frontend(waves, lp, cfg.conv_layers, dtype=dtype)
                 .float() for kind, dtype in (("f32", torch.float32),
                                              ("bf16", torch.bfloat16))}
        torch.cuda.synchronize()
    launches = read_counters()
    want = {"mha_small_t": 0, "fused_gat_aggregate": 0,
            "fused_htrg_gat_aggregate": 0, "quantize_int8": 0, "ln_gelu": 2,
            "conv_ln_gelu_grouped": 12, "gelu_fast": 0}
    err = {k: (fused[k] - out[k]).abs().max().item() for k in fused}
    gap = (out["bf16"] - out["f32"]).abs().max().item()
    bf16_tol = 2 * gap + 0.02
    log(f"fused_conv_frontend (B={B}, {SAMPLES} samples) -> "
        f"{tuple(fused['bf16'].shape)}: f32 vs ConvFeatureExtractor max|d| "
        f"{err['f32']:.3g} (atol {FRONTEND_F32_ATOL}); bf16 max|d| "
        f"{err['bf16']:.3g} (tol {bf16_tol:.3g}: twice the unfused module's "
        f"bf16-vs-f32 gap {gap:.3g}, + 0.02), median "
        f"{(fused['bf16'] - out['bf16']).abs().median().item():.3g}; "
        f"launches {launches} (want {want}, f32 and bf16 runs)")
    if fused["bf16"].shape != out["bf16"].shape:
        raise RuntimeError("fused front-end frame count differs")
    if err["f32"] > FRONTEND_F32_ATOL or err["bf16"] > bf16_tol:
        raise RuntimeError("fused front-end disagrees with the module")
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != {want}")
    return {k: v // 2 for k, v in launches.items()}     # per front-end call


def batch_waves(dev) -> torch.Tensor:
    from rtdsd_tpu_torch.config import load_yaml_config
    from rtdsd_tpu_torch.data.dataset import ASVspoof2021LA_eval

    sys_cfg, exp_cfg = load_yaml_config(write_config(WORK, "float32"))
    ds = ASVspoof2021LA_eval(sys_cfg, exp_cfg)
    return torch.from_numpy(np.stack([ds.get(i)[1] for i in range(B)])).to(dev)


def steady_ms_per_clip(model, waves) -> float:
    """Forward time per clip, CUDA events over 5 forwards after a warm-up."""
    with torch.inference_mode():
        model(waves)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            model(waves)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 5 / waves.shape[0]


KERNEL_CLASSES = (("mha_small_t kernel", ("mha_small_t",)),
                  ("GAT kernels", ("gat_tiled_kernel", "gat_rows_kernel")),
                  ("GEMM", ("gemm", "nvjet", "xmma", "cublas")),
                  ("convolution", ("conv", "fprop", "dgrad", "wgrad",
                                   "cudnn")),
                  ("norm/softmax/reduce", ("norm", "softmax", "reduce")),
                  ("copy/cast", ("copy", "cat")),
                  ("elementwise", ("elementwise",)))


def by_class(rows) -> dict:
    """Profiler rows (name, device ms, count) -> {class: (ms, count)} by
    KERNEL_CLASSES."""
    classes = {}
    for key, ms, n in rows:
        low = key.lower()
        cls = next((c for c, subs in KERNEL_CLASSES
                    if any(sub in low for sub in subs)), "other")
        t, c = classes.get(cls, (0.0, 0))
        classes[cls] = (t + ms, c + n)
    return classes


def _profiled(fn, inference: bool = True):
    """(kernel rows (name, device ms, count), wall ms) of one call of
    ``fn`` after a warm-up call, by torch.profiler (CUPTI); ``inference``
    runs both under ``torch.inference_mode``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(inference):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0], wall_ms


def profile_forward(model, waves, top: int = 12, label: str = "bf16",
                    head=None) -> None:
    """Where one batch's forward spends device time: kernels by device time
    (torch.profiler / CUPTI), grouped by class, and the device's busy share
    of the wall time. ``head``, a back-end's forward, is then profiled
    alone on the encoder's features of the same batch: its share of the
    batch's kernel time on a line of its own."""
    rows, wall_ms = _profiled(lambda: model(waves))
    busy = sum(r[1] for r in rows)
    log(f"profile, one {label} batch of {waves.shape[0]}: wall {wall_ms:.2f} ms, "
        f"kernels {busy:.2f} ms (device busy {100 * busy / wall_ms:.1f}%), "
        f"{sum(r[2] for r in rows)} kernel launches")
    for cls, (ms, n) in sorted(by_class(rows).items(), key=lambda kv: -kv[1][0]):
        log(f"  class {cls:22s} {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n}")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"  {ms:9.3f} ms {100 * ms / busy:5.1f}%  x{n:<5d} {key[:90]}")
    if head is not None:
        with torch.inference_mode():
            feats = model.ssl_model.model(waves)
        head_rows, head_wall = _profiled(lambda: head(feats))
        head_ms = sum(r[1] for r in head_rows)
        log(f"  head (the back-end alone on the encoder's features): "
            f"{head_ms:.3f} ms of kernels, {100 * head_ms / busy:.1f}% of the "
            f"batch's {busy:.2f} ms; wall {head_wall:.2f} ms, "
            f"{sum(r[2] for r in head_rows)} kernel launches; top: "
            + "; ".join(f"{k[:50]} {ms:.3f} ms x{n}" for k, ms, n in
                        sorted(head_rows, key=lambda r: -r[1])[:4]))


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel wrapper the model calls for its plain version."""
    from rtdsd_tpu_torch.models import aasist, wav2vec2
    from rtdsd_tpu_torch.ops import attention, fastgelu, gat

    swaps = [(wav2vec2, "mha_small_t", attention.mha_small_t_reference),
             (aasist, "fused_gat_aggregate", gat.fused_gat_aggregate_reference),
             (aasist, "fused_htrg_gat_aggregate",
              gat.fused_htrg_gat_aggregate_reference),
             (fastgelu, "gelu_fast", fastgelu.gelu_fast_reference)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


@contextlib.contextmanager
def ctypes_binding():
    """Swap the models' kernel calls for the kernels' ctypes launches
    called directly (``attention.launch``, ``gat.launch_gat``,
    ``gat.launch_htrg``, ``fastgelu.launch``), as the port bound them
    before they were ``torch.library`` operators: the same kernels without
    the dispatcher."""
    from rtdsd_tpu_torch.models import aasist, wav2vec2
    from rtdsd_tpu_torch.ops import attention, fastgelu, gat

    swaps = [(wav2vec2, "mha_small_t",
              lambda q, k, v, scale=None: attention.launch(
                  q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)),
             (aasist, "fused_gat_aggregate",
              lambda x, w, b, a, t=1.0: gat.launch_gat(x, w, b, a, t)),
             (aasist, "fused_htrg_gat_aggregate",
              lambda x, w, b, w11, w22, w12, n1, t=1.0: gat.launch_htrg(
                  x, w, b, w11, w22, w12, n1, t)),
             (fastgelu, "gelu_fast", fastgelu.launch)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    try:
        for m, n, f in swaps:
            setattr(m, n, f)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def binding_cost(model, waves, card: str) -> None:
    """The torch.library binding's cost: the bf16 forward at batch 16 and 1
    with the operators (the port's binding) and with the ctypes launches
    called directly, in turns (operator, ctypes, ctypes, operator) over
    STEADY_REPEATS rounds; both launch the same kernels the same number
    of times."""
    times = {(k, b): [] for k in ("operator", "ctypes") for b in (B, 1)}
    launches = {}
    for _ in range(STEADY_REPEATS):
        for kind in ("operator", "ctypes", "ctypes", "operator"):
            ctx = ctypes_binding if kind == "ctypes" else contextlib.nullcontext
            with ctx():
                for b in (B, 1):
                    times[(kind, b)].append(steady_ms_per_clip(model, waves[:b]))
            # counted outside the swap, which replaces fastgelu.gelu_fast
            reset_counters()
            with ctx(), torch.inference_mode():
                model(waves[:1])
            launches[kind] = read_counters()
    log(f"binding cost, bf16 forward ms/clip, median [min, max] of "
        f"{2 * STEADY_REPEATS} runs in turns, {card}: " + ", ".join(
            f"{k} batch {b} {statistics.median(t):.4f} [{min(t):.4f}, "
            f"{max(t):.4f}]" for (k, b), t in times.items())
        + f"; launches a batch-1 forward: {launches}")
    if launches["operator"] != launches["ctypes"] \
            or launches["operator"] != launches_want(24, 1, gelu=w2v_gelu(24)):
        raise RuntimeError(f"binding launches {launches}")


def build_model(sd: dict, dtype: torch.dtype, dev, fast_softmax=False,
                mode: str = "", name: str = "XLSR_AASIST", layers=None):
    """The main-path model (or the Conformer, ``name`` "XLSR_Conformer";
    ``layers``, the registry's layer kwargs of a pruned model); ``mode``
    "w8" / "w8a8" quantizes the weights on the card, as the CLI's ``--w8``
    / ``--w8a8`` do."""
    from rtdsd_tpu_torch.models.convert import load_reference_state_dict
    from rtdsd_tpu_torch.models.quantize import quantize_state_dict
    from rtdsd_tpu_torch.models.registry import get_model

    spec = get_model(name, dtype=dtype, fused_gat=True, **(layers or {}),
                     w2v={"fast_softmax": fast_softmax, "w8": bool(mode),
                          "a8": mode == "w8a8"})
    ref = load_reference_state_dict(sd)
    if mode:
        ref = quantize_state_dict({k: v.to(dev) for k, v in ref.items()})
    spec.module.to(dev).load_state_dict(ref, strict=True)
    return spec.module.eval()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from rtdsd_tpu_torch.ops import build
    from rtdsd_tpu_torch.models.registry import get_model

    dev = torch.device("cuda")
    kind, card = torch.cuda.get_device_name(0), smi()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {card}")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})")
    for line in ptxas_summary("mha_small_t", ("wgmma_kernelILi16ELb0E",
                                               "tiled_kernelILi64E",
                                               "rows_kernelIfLi64E")):
        log(line)
    for line in ptxas_summary("quant", ("quant_kernelILb1ELb1E",
                                        "quant_kernelILb0ELb1E")):
        log(line)
    for line in ptxas_summary("convstack", ("conv_mma_kernelILi256ELi2E",
                                            "conv_mma_kernelILi256ELi1E",
                                            "conv_mma_kernelILi128ELi1E",
                                            "conv_ln_gelu_kernelI13__nv_bfloat16Li512E")):
        log(line)
    for line in ptxas_summary("fastgelu", ("gelu_vec_kernelI13__nv_bfloat16E",
                                           "gelu_vec_kernelIfE")):
        log(line)
    for line in ptxas_summary("gat", ("gat_tiled_kernelILi64ELi1E",
                                      "gat_tiled_kernelILi64ELi2E",
                                      "gat_tiled_kernelILi32ELi1E",
                                      "gat_rows_kernelILi64E")):
        log(line)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    shell = get_model("XLSR_AASIST").module
    sd = random_reference_state_dict(shell, seed=0)
    del shell
    log(f"full-width XLSR_AASIST, random weights (seed 0): "
        f"{sum(v.numel() for k, v in sd.items() if 'running' not in k) / 1e6:.1f}"
        f" M values, made in {time.perf_counter() - t0:.1f} s")
    records = {"mha_small_t": (check_attention(dev), "cuda",
                               "rtdsd_tpu_torch/csrc/mha_small_t.cu",
                               "rtdsd_tpu/ops/pallas/attention.py:91"),
               "fused_gat_aggregate": (check_gat(dev, htrg=False), "cuda",
                                       "rtdsd_tpu_torch/csrc/gat.cu",
                                       "rtdsd_tpu/ops/pallas/gat.py:99"),
               "fused_htrg_gat_aggregate": (check_gat(dev, htrg=True), "cuda",
                                            "rtdsd_tpu_torch/csrc/gat.cu",
                                            "rtdsd_tpu/ops/pallas/gat.py:183"),
               "quantize_int8": (check_quant(dev, sd), "cuda",
                                 "rtdsd_tpu_torch/csrc/quant.cu",
                                 "rtdsd_tpu/ops/pallas/quant.py:71"),
               "ln_gelu": (check_ln_gelu(dev), "cuda",
                           "rtdsd_tpu_torch/csrc/convstack.cu",
                           "rtdsd_tpu/ops/pallas/convstack.py:83"),
               "conv_ln_gelu_grouped": (check_conv(dev), "cuda",
                                        "rtdsd_tpu_torch/csrc/convstack.cu",
                                        "rtdsd_tpu/ops/pallas/convstack.py:152"),
               "gelu_fast": (check_gelu(dev), "cuda",
                             "rtdsd_tpu_torch/csrc/fastgelu.cu",
                             "none (XLA fuses rtdsd_tpu/ops/fastgelu.py)")}

    t0 = time.perf_counter()
    ckpt = os.path.join(WORK, "xlsr_aasist_seed0.pt")
    torch.save(sd, ckpt)
    write_track(WORK)
    log(f"checkpoint and track saved in {time.perf_counter() - t0:.1f} s")
    loader_phase()

    run = main_path(ckpt)
    int8_runs = {mode: main_path(ckpt, mode) for mode in ("w8", "w8a8")}
    for mode, r in int8_runs.items():
        d = max(abs(r["scores"][u] - run["scores"][u]) for u in run["scores"])
        log(f"{mode} scores vs bf16 scores (random weights; information, not "
            f"a gate): max|d| {d:.4g}, |bf16 score| max "
            f"{max(abs(v) for v in run['scores'].values()):.4g}")
    frontend_launches = frontend_path(sd, dev)

    t0 = time.perf_counter()
    ckpts, sds = {}, {}
    for key, model_name, kwargs, seed in (
            ("conformer", "XLSR_Conformer", {}, 0),
            ("screener", "My_XLSR_AASIST", SCREENER_KWARGS, 1)):
        sds[key] = random_reference_state_dict(
            get_model(model_name, **kwargs).module, seed=seed)
        ckpts[key] = os.path.join(WORK, f"{key}_seed{seed}.pt")
        torch.save(sds[key], ckpts[key])
    log(f"full-width XLSR_Conformer (seed 0) and screener (seed 1), random "
        f"weights, made and saved in {time.perf_counter() - t0:.1f} s")
    conformer_scores = conformer_path(ckpts["conformer"])
    cascade_path(ckpts["conformer"], ckpts["screener"], conformer_scores)
    realtime_path(sd, dev)
    stream_launches, incremental = stream_path(ckpt, ckpts["conformer"])
    stream_device(sd, dev, os.path.join(WORK, "stream", "long.wav"))
    serve_launches, serve_waves, band = serve_path(
        ckpt, ckpts["screener"], sd, sds["screener"], dev)
    bf16_serving = serve_device(sd, sds["screener"], dev, serve_waves)
    daemon_parity(sd, dev, serve_waves)
    daemon_launches, reload_peak = daemon_cli(ckpt, serve_waves)
    daemon_capacity(bf16_serving, reload_peak)
    del bf16_serving
    torch.cuda.empty_cache()
    train_launches, ssl_pt, train_losses = train_cli(sd, dev)
    t0 = time.perf_counter()
    ddp_world1(sd, dev, card, train_losses)
    ddp_gloo(sd, dev, card)
    log(f"4n: {time.perf_counter() - t0:.1f} s")
    for name in ("runs", "runs_ddp"):
        shutil.rmtree(os.path.join(WORK, "train", name))
    train_parity(sd, dev)
    attention_grad_check(dev)
    train_timed(sd, dev, card)
    remat_path(sd, dev, card)
    kd_launches = kd_path(ckpt, ssl_pt, sd, dev, card)
    export_launches = export_path(ckpt, ckpts["screener"], sd, sds["screener"],
                                  dev, run["scores"], incremental, serve_waves,
                                  band, card)
    conformer_launches = conformer_train_path(ssl_pt, dev, card)

    # phase 5: one f32 batch, kernels against plain versions, TF32 off
    waves = batch_waves(dev)
    model = build_model(sd, torch.float32, dev)
    with torch.inference_mode():
        with_kernels = model(waves).float()
        with plain_kernels():
            plain = model(waves).float()
    torch.cuda.synchronize()
    drift = (with_kernels - plain).abs().max().item()
    log(f"f32 full-width batch: logits kernels vs plain max|d| {drift:.3g} "
        f"(tol {LOGIT_TOL}); |logits| max {plain.abs().max().item():.3g}")
    if not torch.isfinite(with_kernels).all() or drift > LOGIT_TOL:
        raise RuntimeError(f"f32 logits drift {drift} > {LOGIT_TOL}")
    f32_ms = steady_ms_per_clip(model, waves)
    profile_forward(model, waves, label="f32")
    del model
    model = build_model(sds["conformer"], torch.float32, dev,
                        name="XLSR_Conformer")
    with torch.inference_mode():
        with_kernels = model(waves).float()
        with plain_kernels():
            plain_c = model(waves).float()
    torch.cuda.synchronize()
    drift = (with_kernels - plain_c).abs().max().item()
    log(f"f32 full-width XLSR_Conformer batch: logits kernels vs plain max|d| "
        f"{drift:.3g} (tol {LOGIT_TOL}); |logits| max "
        f"{plain_c.abs().max().item():.3g}")
    if not torch.isfinite(with_kernels).all() or drift > LOGIT_TOL:
        raise RuntimeError(f"f32 Conformer logits drift {drift} > {LOGIT_TOL}")
    del model
    bf16 = build_model(sd, torch.bfloat16, dev)
    bf16_ms = steady_ms_per_clip(bf16, waves)
    with torch.inference_mode():
        bf16_scores = bf16(waves)[:, 1].float()
    cli_scores = torch.tensor([run["scores"][f"LA_E_{i:07d}"] for i in range(B)],
                              device=dev)
    log(f"steady forward, batch {B}: bf16 {bf16_ms:.4f} ms/clip, "
        f"f32 {f32_ms:.4f} ms/clip; bf16 CLI scores vs bf16 forward max|d| "
        f"{(cli_scores - bf16_scores).abs().max().item():.3g}; bf16 vs f32 "
        f"score max|d| {(bf16_scores - plain[:, 1]).abs().max().item():.3g}")
    # the CLI's first batch is these 16 clips through the same bf16 model;
    # only convolution algorithm choice may differ between the two builds
    scale = max(1.0, bf16_scores.abs().max().item())
    if (cli_scores - bf16_scores).abs().max().item() > 0.05 * scale:
        raise RuntimeError("CLI scores differ from the same model's forward")

    profile_forward(bf16, waves)
    gat_call_kernels(bf16, waves)
    models = {"bf16": bf16,
              **{mode: build_model(sd, torch.bfloat16, dev, mode=mode)
                 for mode in ("w8", "w8a8")},
              "conformer": build_model(sds["conformer"], torch.bfloat16, dev,
                                       name="XLSR_Conformer")}
    profile_forward(models["w8a8"], waves, label="w8a8")
    profile_forward(models["w8a8"], waves[:1], top=0, label="w8a8")
    from rtdsd_tpu_torch.models.conformer import ConformerBackend
    conformer = models["conformer"]
    profile_forward(conformer, waves, label="XLSR_Conformer bf16",
                    head=lambda feats: ConformerBackend.forward(conformer, feats))
    # the three modes in turns, STEADY_REPEATS rounds: the host launches
    # every kernel, and at batch 1 its speed, which varies between machines
    # and over a run, sets the time
    steady = {(m, b): [] for m in models for b in (B, 1)}
    for _ in range(STEADY_REPEATS):
        for (m, b), times in steady.items():
            times.append(steady_ms_per_clip(models[m], waves[:b]))
    binding_cost(bf16, waves, card)
    del models, bf16, conformer
    log(f"steady forward, ms/clip (bf16 compute; conformer: XLSR_Conformer), "
        f"median [min, max] of "
        f"{STEADY_REPEATS} rounds: " + ", ".join(
            f"{m} batch {b} {statistics.median(t):.4f} [{min(t):.4f}, "
            f"{max(t):.4f}]" for (m, b), t in steady.items()))
    # the JAX default, fast_softmax: true, keeps the bf16 softmax in plain
    # einsums (no kernel): its cost beside the kernel path
    fast_ms = steady_ms_per_clip(
        build_model(sd, torch.bfloat16, dev, fast_softmax=True), waves)
    log(f"steady forward, batch {B}, bf16 with fast_softmax (plain bf16 "
        f"softmax, no attention kernel): {fast_ms:.4f} ms/clip")

    launches = dict(run["launches"])
    launches["quantize_int8"] = int8_runs["w8"]["launches"]["quantize_int8"]
    launches.update({k: frontend_launches[k]
                     for k in ("ln_gelu", "conv_ln_gelu_grouped")})
    paths = {"quantize_int8": "--w8 CLI run (weights quantized at load)",
             "gelu_fast": "bf16 CLI scoring, 2 batches (32 a batch)",
             "ln_gelu": "fused_conv_frontend, one bf16 call",
             "conv_ln_gelu_grouped": "fused_conv_frontend, one bf16 call"}
    kernels = [dict(name=k, route=route, source=src, replaces=rep,
                    launches=launches[k], stream_launches=stream_launches[k],
                    serve_launches=serve_launches[k],
                    daemon_launches=daemon_launches[k],
                    train_launches=train_launches[k],
                    conformer_train_launches=conformer_launches[k],
                    kd_launches=kd_launches[k],
                    export_launches=export_launches[k],
                    path=paths.get(k, "bf16 CLI scoring, 2 batches"), **rec)
               for k, (rec, route, src, rep) in records.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())

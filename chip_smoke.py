#!/usr/bin/env python3
"""Drives the PyTorch port's serving, training (single-codebook float32 and
residual-VQ bf16), prior, vocoder, 3x3-convolution A/B, corpus
preprocessing and mel-inversion paths on one CUDA card and checks them.

Run from the root of the repository: ``python3 chip_smoke.py``. Phases:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles every CUDA kernel of the port from ``csrc/``, one
   ``nvcc`` per source, all started together;
3. kernels: holds each kernel against its plain PyTorch version at the
   shapes the serving path and the flagship training step give it, and
   times kernel, plain version, one PyTorch library call and the card's
   bound: the nearest-code search at serving and training shapes (each
   row also with its cluster size and CTA count, which must cover the
   SMs, its registers and spills, device-only times and a second call
   that must return the same indices bit for bit; four edge shapes held
   untimed, and a tie case), the
   fused Adam update at the flagship's parameter count in three
   configurations over three chained steps, and the causal-attention
   forward, dQ and dK/dV kernels at the prior's grids (T = 140, 560 in f32
   and bf16, 2240, a ragged T = 37, D = 128, and the contract's ends T = 1
   and bf16 D = 20), each run twice to show the backward is bit-identical
   run to run, with each kernel's launch plan (no spills) and times back to
   back and device-only beside SDPA's, and both 3x3 bf16 convolution
   kernels (phase 9 is their path);
4. serving: builds the mel VQ-VAE service at full width (dim 256, 512
   codes, 84-frame windows) on the card with seeded weights, serves it over
   HTTP, checks every response of /health, /encode, /reconstruct and
   /decode for 1 s, 3 s and 8 s chirps (TIMED_REPEATS timed requests per
   endpoint and length after a warm-up, reported as p50 and p90) and
   bursts of concurrent batched /reconstruct requests, reads each kernel's
   launch count over the HTTP requests alone and checks it against the
   count they must launch, then checks the float waveforms are finite and
   holds the card's codes and mels against the same model on the CPU;
5. training: writes a synthetic chirp corpus, trains through ``cli.main``
   at full width (batch 64 of 80 x 28 mel crops, dim 256, 512 codes) for
   two epochs with --multi-steps 1, two with --multi-steps 4, then
   --resume for a third; reads each kernel's launch count over each run
   and checks it against the optimizer steps and batches the run must
   launch; checks the loss is finite and falls, the checkpoint and its
   metadata, one train step on the card against the same step on the CPU,
   times train steps/s, and serves /reconstruct from the trained
   checkpoint with --ema;
6. residual VQ and bf16: trains through ``cli.main`` at the same width
   with --num-quantizers 4 --bf16 --ema-codebook --restart-dead-threshold
   1.0 --codebook-init data for two epochs; checks the loss is finite and
   falls, the launch counts (nearest-code: 3 for data init, 8 per step, 8
   per eval batch; fused Adam: steps), the checkpoint (float32, 4 stages in
   its metadata), ``cli.evaluate --num-quantizers 4 --bf16`` on it, one
   float32 and one bf16 RVQ step on the card against the CPU (every code
   flip a near-tie between the two devices' residuals, at most 1e-3 of
   the assignments flipped decisions, rows of one value counted once;
   the float32 loss terms within 1e-5 once what flipped codes change in
   the quantization error is taken out), and times steps/s with 4 stages
   and 1, in bf16 and float32;
7. prior: on that VQ-VAE checkpoint and corpus, trains the transformer
   prior through ``cli.prior train --arch transformer`` (dim 128, 4 layers
   of 2 heads, 512 codes, batch 32 of 20 x 7 code grids) for three epochs,
   then once more with --resume; reads every kernel's launch count over
   each run (attention kernels: layers x steps each, fused Adam: steps,
   nearest-code: encoded batches); checks the loss falls, one step on the
   card against the same step on the CPU, the KV-cached decode against
   the kernel's forward, times train steps/s, runs ``cli.prior sample``
   and serves /sample at n = 1 and n = 4 from ``serve --prior-ckpt``;
8. vocoder: holds both variants of the whole-loop WaveNet kernel (sampling
   and teacher-forced) against their plain versions at its production
   configuration (24 layers, R 128, G 256, S 128, cin 80; T = 4096 and a
   ragged 1000), the CPU tests' 4-layer one (T = 64) and an 8-layer one
   at R 256, G 512, S 256 whose chain weights are partly read from device
   memory, 2 of its 8 layers not resident (T = 64): the teacher's
   logits within a tolerance, both against the float32 incremental_forward,
   and the kernel's samples reproduced by the plain teacher on its own
   trajectory with the same noise, each variant launched twice for
   bit-identical output, with its launch plan (one cluster, no spills, an
   active cluster); times both back to back and device-only, the plain
   versions and the bound. Then the kernel's main path,
   ``make_generate_fn(use_kernel=True)`` generating one second twice with
   injected noise, with its launch count, each call's samples reproduced by
   the plain teacher, a third launch on the first call's noise bit-identical
   to it, and the kernel's device-only time at that length; then the CLI's
   default vocoder at full width (24 layers, R = G = 512, S = 256) from a
   seeded-init artifact: ``cli.vocoder synthesize``, and ``cli.serve
   --vocoder wavenet`` on the trained VQ-VAE and prior answering
   /reconstruct_stream, /decode and /sample_stream, and with
   --stream-slots 2 two concurrent /reconstruct_stream;
9. conv A/B: runs ``scripts/torch_ab_conv3x3.py``'s ``main()``, the
   entry point of the 3x3 bf16 convolution's two kernels (taps and im2col;
   held against their plain version in phase 3 at the A/B shape (64, 20, 7,
   256), a ragged (3, 13, 5, 64) and four shapes at the ends of their
   contract, each run twice for bit-identical output, with each launch's
   CTAs, registers and spills, and timed beside cuDNN, back to back and
   device-only): parity, then cuDNN, taps, im2col and cuDNN legs of 400
   chained convolutions, with each kernel's launch count over it;
10. preprocessing and inversion: writes an LJSpeech-layout corpus (128
    int16 WAVs of 1-10 s at 22050 Hz: chirps with a little noise between
    near-silences) and a two-speaker cmu_arctic one at 16 kHz, runs
    ``cli.preprocess`` on each on the card and with ``--device cpu`` (the
    cmu_arctic corpus under the cmu_arctic_8bit settings from a preset the
    script writes: mu-law integers at 256 levels; the corpus binds LWS and
    no preemphasis), and holds the two runs against each other: train.txt
    identical, float audio shards bit-equal, mu-law integers equal but at
    truncation boundaries, both runs' mels against float64 from the same
    prepared blocks (above the floor, near it, and in linear magnitude
    over each frame's largest); prints frames/s and
    the batch transform's device ms per length bucket. Then
    ``extract_units`` over every 84-frame window of the card's mels through
    the serving phase's seeded full-width VQ-VAE, ``reconstruct_audio`` and
    ``codes_to_audio``, with vq_nearest's launch count (one per encode
    batch) and card vs CPU codes (mismatches only at near-ties);
    ``cli.invert`` on one mel; and ``inv_mel_spectrogram`` by Griffin-Lim
    (60 iterations from injected phases) and by LWS (100) on the card and
    the CPU, their spectral convergence held against each other and timed;
11. summary: one JSON line per kernel, then the result line.

Exits non-zero, printing no result, when CUDA is unavailable, when the
port is not beside this script, or when any check fails.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# Peak rates of one H100 SXM (NVIDIA data sheet): f32 outside the tensor
# cores, dense TF32 and bf16 on the tensor cores and HBM bandwidth. An f32
# kernel's bound takes the f32 rate, a bf16 input's the bf16 rate; the
# nearest-code search, which multiplies in 3xTF32, also reports its bound at
# the TF32 rate.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SEED = 0
VQ_D = 256
# (N, K): serving at 1 s (2 windows x 420 latents), serving at 8 s (16
# windows), the flagship training step (batch 64 of 28-frame crops:
# 64 x 20 x 7 latents, bench.py:22 and data/collate.py:30-45), 64 serving
# windows of 84 frames, K past one 512-code tile, and quantize_channels
# scale.
VQ_SHAPES = [(840, 512), (6720, 512), (8960, 512), (26880, 512), (1500, 1536),
             (8192, 65536)]
# (N, K, D) held against the plain version but not timed: one row and one
# code, D not a multiple of 4 (the threads stage instead of TMA), D = MAX_D,
# ragged tiles
VQ_EDGE_SHAPES = [(1, 1, 1), (333, 77, 37), (100, 300, 1024), (65, 129, 4)]
VQ_MAIN_SHAPE = (6720, 512)  # what an 8 s request gives the kernel
VQ_TRAIN_SHAPE = (8960, 512)
NEAR_TIE_REL = 1e-5
CHIRP_SECONDS = (1.0, 3.0, 8.0)
TIMED_REPEATS = 40  # timed requests per endpoint and length
BURST = 4
BURST_ROUNDS = 10


# the training phase: full width, cut in depth (steps) only. DEVICE is the
# card; a rehearsal of the phase on the CPU at small sizes may set it.
DEVICE = "cuda"
TRAIN_DIM, TRAIN_CODES, TRAIN_BATCH = 256, 512, 64
CORPUS_UTTERANCES = 560  # 535 train (8 batches of 64), 25 test (1 batch)
BATCHES_PER_EPOCH = 8
TIMED_STEPS = 50
# fused Adam: (name, bf16 moments, clip, weight decay, EMA)
ADAM_CONFIGS = [("f32_clip_wd_ema", False, True, 0.01, True),
                ("bf16_moments", True, True, 0.01, True),
                ("f32_plain", False, False, 0.0, False)]
ADAM_STEPS = 3
# p and ema within 4 float32 ulps (relative 2**-21); moments in bf16 equal
# or one bf16 ulp apart
ADAM_P_RTOL = 4 * 2.0**-23
ADAM_BF16_ULPS = 1
# causal attention: (name, BH, T, D, bf16). BH = batch 32 x 2 heads of 64
# for the prior the smoke trains; T = 140 is the CLI's 20 x 7 training
# grid, 560 the flagship 20 x 28 grid (cli.prior sample's default), 2240
# the hierarchical bottom grid; then the ends of the kernels' contract: one
# row (T = 1), and bf16 rows of 40 bytes (D = 20), which TMA cannot stage
ATTN_SHAPES = [("train_T140", 64, 140, 64, False), ("flagship_T560", 64, 560, 64, False),
               ("flagship_T560_bf16", 64, 560, 64, True), ("hier_T2240", 16, 2240, 64, False),
               ("ragged_T37_D32", 64, 37, 32, False), ("D128_T560", 64, 560, 128, False),
               ("T1", 64, 1, 64, False), ("D20_bf16", 64, 300, 20, True)]
ATTN_MAIN = "train_T140"
# error against the plain pair, relative to the plain output's largest
# magnitude floored at 1, the unit-normal inputs' scale (at T = 1 dQ and dK
# are zero up to rounding, in both): f32 sums in another order; bf16 P and
# dS rounded at other sums
ATTN_F32_REL, ATTN_BF16_REL = 1e-5, 2e-2

# the 3x3 bf16 convolution (kernel 6): the A/B shape, the ResBlock's conv
# at the flagship's training step (batch 64 of 80 x 28 crops after two
# stride-2 convs), a ragged one, and the ends of the contract: C = 16 (the
# least, under one 128-channel tile), C = 512, W > 66 (the taps route's
# halo in three segments), and H = 1 with 150 pixels (not a multiple of 64)
# and C = 48 (a partial 64-channel chunk); each held to the A/B script's
# limits (ULP_LIMIT, BIT_EQUAL_MIN) and run twice for bit-identical output
CONV_SHAPES = [("ab_64x20x7x256", (64, 20, 7, 256)), ("ragged_3x13x5x64", (3, 13, 5, 64)),
               ("c16_2x5x3x16", (2, 5, 3, 16)), ("c512_4x9x11x512", (4, 9, 11, 512)),
               ("w70_1x3x70x32", (1, 3, 70, 32)), ("h1_3x1x50x48", (3, 1, 50, 48))]
CONV_MAIN = "ab_64x20x7x256"

# the residual-VQ / bf16 training phase: the training phase's shape with
# --num-quantizers 4 --bf16 and EMA codebooks with restarts
RVQ_Q = 4
RVQ_EPOCHS = 2
RVQ_TIMED_STEPS = 50
# one bf16 step, card vs CPU: the loss terms within 2e-2 relative (bf16
# roundings flip where float32 sums run in another order, as the CPU tests
# hold the port's bf16 step against JAX's)
RVQ_BF16_LOSS_REL = 2e-2

# the prior phase: the configuration the JAX package measured (--prior-dim
# 128 --prior-layers 4: 2 heads of 64), full width, cut in depth only
PRIOR_DIM, PRIOR_LAYERS, PRIOR_HEADS, PRIOR_BATCH = 128, 4, 2, 32
PRIOR_EPOCHS, PRIOR_BATCHES_PER_EPOCH = 3, 8
PRIOR_TIMED_STEPS = 50
SAMPLE_REPEATS = 5  # timed /sample requests per n

# the vocoder phase. Kernel 5's production configuration (the Pallas
# kernel's docstring, ops/pallas/wavenet_gen.py:19, and
# tests/test_wavenet.py:359-363) and the CPU tests' 4-layer one
WN_PROD = dict(out_channels=30, layers=24, stacks=4, residual_channels=128,
               gate_channels=256, skip_out_channels=128, kernel_size=3, cin_channels=80,
               upsample_scales=(4, 4, 4, 4))
WN_TESTS = {**WN_PROD, "layers": 4, "stacks": 2, "upsample_scales": (2, 2)}
# a shape inside generate_supported whose chain weights do not all fit the
# cluster's shared memory: 6 of its 8 layers are resident, the other 2 and
# their [W_res | W_skip] are read from device memory
WN_STREAMED = {**WN_TESTS, "layers": 8, "residual_channels": 256, "gate_channels": 512,
               "skip_out_channels": 256}
WN_SHAPES = [("production_T4096", WN_PROD, 4096), ("production_T1000", WN_PROD, 1000),
             ("tests_T64", WN_TESTS, 64), ("streamed_T64", WN_STREAMED, 64)]
WN_MAIN = "production_T4096"
# teacher logits, kernel vs plain: the same rounding points and order of
# sums, so they differ only where CUDA's tanhf/expf/log1pf and PyTorch's
# differ in a last bit (bit-equal at every shape so far). The limit sits
# well under the gap between the bf16 math and the float32
# incremental_forward (on an H100: 0.0037 at the tests' T = 64, 0.017-0.020
# at the production config), so a kernel that dropped its bf16 rounding points
# would fail it; each row reports whether that float32 control does
WN_TEACHER_TOL = 1e-3
# the sampler's one-step consistency: samples within 1e-3 on 99.9% of
# steps, and a mismatch only where the Gumbel-max gap is below 1e-3
WN_SAMPLE_TOL, WN_AGREE = 1e-3, 0.999
WN_PLAIN_STEPS = 32  # steps of the plain sampler timed (launch-bound)
WN_API_SAMPLES, WN_API_CALLS = 22050, 2  # one second per call
# the CLI's default vocoder (24 layers, R = G = 512, S = 256) is served with
# a 16-frame window: /sample_stream's 20 x 4 code grid then decodes to 16
# mel frames, one 4096-sample chunk, as the 0.1 s chirp of
# /reconstruct_stream and its /decode are; the scan sampler takes some
# 25 s per chunk on the card (launch-bound), so one chunk per request keeps
# the phase near 150 s
WN_SERVE_FRAMES = 16
WN_CHIRP_SECONDS = (0.1, 0.15)
WN_SYNTH_FRAMES = 4

# the preprocessing phase: an LJSpeech-layout corpus at 22050 Hz with
# LJSpeech's range of lengths, and a two-speaker cmu_arctic-layout one at
# 16 kHz under the cmu_arctic_8bit settings (mulaw-quantize at 256 levels;
# the corpus binds LWS and no preemphasis), each preprocessed on the card
# and on the CPU with the default batching (16 a batch, 32768-sample buckets)
PREP_UTTERANCES = 128
PREP_SECONDS = (1.0, 10.0)
CMU_SPEAKERS = ("awb", "slt")
CMU_PER_SPEAKER = 16
CMU_SECONDS = (1.0, 4.0)
CMU_PRESET = {"name": "vocoder", "input_type": "mulaw-quantize", "quantize_channels": 256,
              "sample_rate": 16000, "silence_threshold": 2, "num_mels": 80, "fmin": 125,
              "fmax": 7600, "fft_size": 1024, "hop_size": 256, "min_level_db": -100,
              "ref_level_db": 20, "rescaling": True, "rescaling_max": 0.999,
              "allow_clipping_in_normalization": True}
# mels on the card and on the CPU against float64 from the same prepared
# block (normalized units, [0, 1]): at bins 20 dB or more above the floor
# (min_level_db) within PREP_MEL_ABOVE_FLOOR_ATOL; at the quieter rest,
# where the dB turns the FFT's absolute rounding into a large relative
# error, within PREP_MEL_NEAR_FLOOR_ATOL; and every bin in linear magnitude
# within PREP_MEL_LIN_REL of its frame's largest, where a TF32 or bf16 mel
# product shows. Each about twice the H100's largest reading over both
# corpora (scripts/torch_prep_mel_precision.py: 2.3e-5, 9.8e-5, 3.7e-6;
# the CPU's 1.1e-5, 3.5e-5, 1.0e-6). A mu-law integer may differ by one
# level only where the exact (mulaw(x) + 1) / 2 * Q lies within Q * 2^-21
# of an integer (8 float32 ulps at the top of the range: the card's log1pf
# and division round otherwise)
PREP_ABOVE_FLOOR_DB = 20
PREP_MEL_ABOVE_FLOOR_ATOL = 5e-5
PREP_MEL_NEAR_FLOOR_ATOL = 2e-4
PREP_MEL_LIN_REL = 1e-5
MULAW_BOUNDARY_REL = 2.0**-21
UNITS_BATCH = 64  # 84-frame windows a call of extract_units
# mel inversion card vs CPU: spectral convergence ||STFT(y)| - S| / |S| of
# Griffin-Lim (60 iterations from the same injected phases) and LWS (100)
# within 1e-3 absolute (a 1e-6 relative change of the mel moved it by at
# most 1.7e-6 on the CPU), on utterances of some 3 s
INV_UTTERANCES = 2
INV_SECONDS = 3.0
INV_GL_ITERS = 60
INV_LWS_ITERS = 100
INV_SC_ATOL = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(torch, fn, iters: int) -> tuple[float, float]:
    """(device ms per call, host enqueue us per call). The stream first
    sleeps for longer than the host takes to enqueue all `iters` calls, so
    the events time the kernels back to back, not the host's launches."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fn()
    host_s = (time.perf_counter() - t0) / 5
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3e9 * (2 * iters * host_s + 1e-3)))  # > 2x the enqueue at <= 3 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, 1e6 * host_s


def vq_bound_ms(n: int, k: int, d: int) -> tuple[float, str]:
    """Least time for (N, D) x (K, D) -> (N,) int32: inputs read once, the
    output written once, and the 2*N*K*D f32 FMA operations."""
    bytes_ms = 1e3 * 4 * (n * d + k * d + n) / PEAK_HBM_BYTES
    ops_ms = 1e3 * 2 * n * k * d / PEAK_F32_FLOPS
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def vq_tensor_core_bound_ms(n: int, k: int, d: int) -> float:
    """The same products as three TF32 products each (3xTF32) at the dense
    TF32 tensor-core rate, the kernel's own route to f32 accuracy."""
    return 1e3 * 3 * 2 * n * k * d / PEAK_TF32_FLOPS


def ptxas_lines(build, name: str) -> list[str]:
    """Registers, shared memory and spills of each kernel in one library."""
    return [ln.strip() for ln in build.build_info[name]["log"].splitlines()
            if "Used" in ln or "spill" in ln]


def near_ties(r_cpu, r_card, c_a, c_b):
    """Which rows' two codes are a near-tie, float64 (N, D) each: the card
    picked c_a for its vector r_card, the CPU c_b for r_cpu. The codes'
    squared distances from r_cpu may differ by what moving the vector to
    r_card changes between them (at most 2 |r_card - r_cpu| |c_a - c_b|)
    plus NEAR_TIE_REL of the scale the float32 scores |c|^2 - 2 r.c round
    at, |r|^2 + max |c|^2: sums in another order may pick either. The one
    near-tie rule of every code comparison."""
    return tie_excess(r_cpu, r_card, c_a, c_b)[0] <= NEAR_TIE_REL


def tie_excess(r_cpu, r_card, c_a, c_b):
    """(|d_a - d_b| - moved) over the score scale |r|^2 + max |c|^2, and
    the same over min(d_a, d_b); see ``near_ties``."""
    d_a, d_b = ((r_cpu - c_a) ** 2).sum(1), ((r_cpu - c_b) ** 2).sum(1)
    moved = 2 * (r_card - r_cpu).norm(dim=1) * (c_a - c_b).norm(dim=1)
    excess = (d_a - d_b).abs() - moved
    scale = (r_cpu**2).sum(1) + (c_a**2).sum(1).maximum((c_b**2).sum(1))
    return excess / scale, excess / d_a.minimum(d_b)


def compare_vq(torch, vq_kernel, x, cb, timed: bool = True) -> dict:
    """Kernel vs plain version on the same inputs; mismatches must be
    near-ties (``near_ties`` with the same vector on both sides). A second
    call must return the same indices bit for bit."""
    n, d = x.shape
    k = cb.shape[0]
    before = vq_kernel.launch_count()
    got = vq_kernel.nearest_codebook_indices(x, cb).long()
    again = vq_kernel.nearest_codebook_indices(x, cb).long()
    want = vq_kernel.nearest_codebook_indices_plain(x, cb).long()
    torch.cuda.synchronize()
    plan = vq_kernel.launch_plan(x, cb)
    row = {"phase": "kernel", "name": "vq_nearest", "n": n, "k": k, "d": d, **plan,
           "sms": torch.cuda.get_device_properties(x.device).multi_processor_count,
           "run_to_run_identical": bool(torch.equal(got, again))}
    rows = torch.nonzero(got != want).flatten()
    near, err = 0, 0.0
    if rows.numel():
        x64, c_got, c_want = x[rows].double(), cb[got[rows]].double(), cb[want[rows]].double()
        near = int(near_ties(x64, x64, c_got, c_want).sum())
        err = float((((x64 - c_got) ** 2).sum(1) - ((x64 - c_want) ** 2).sum(1)).abs().max())
    row.update(mismatches=int(rows.numel()), near_ties=near, max_abs_err=err)
    if timed:
        iters = 10 if k * n > 1e8 else 50
        bound_ms, bound_by = vq_bound_ms(n, k, d)
        row.update(
            kernel_ms=time_ms(torch, lambda: vq_kernel.nearest_codebook_indices(x, cb), iters),
            plain_ms=time_ms(torch, lambda: vq_kernel.nearest_codebook_indices_plain(x, cb),
                             iters),
            library_ms=time_ms(torch, lambda: torch.cdist(x, cb).argmin(dim=1), iters),
            bound_ms=bound_ms, bound_by=bound_by,
            tensor_core_bound_ms=vq_tensor_core_bound_ms(n, k, d))
        kernel_dev, kernel_host = device_time_ms(
            torch, lambda: vq_kernel.nearest_codebook_indices(x, cb), iters)
        library_dev, library_host = device_time_ms(
            torch, lambda: torch.cdist(x, cb).argmin(dim=1), iters)
        row.update(kernel_device_ms=kernel_dev, kernel_host_us=kernel_host,
                   library_device_ms=library_dev, library_host_us=library_host)
    row["launches"] = vq_kernel.launch_count() - before
    return row


def vq_tie_case(torch, vq_kernel, gen) -> dict:
    """Duplicated codes at 7, 23 (the same thread as 7, another column
    group of its tile), 71 and 400 (other CTAs of the cluster: at N = 300
    the codebook is split 16 ways): the earliest index, 7, must win every
    row."""
    cb = torch.randn(512, VQ_D, generator=gen, device="cuda")
    for j in (23, 71, 400):
        cb[j] = cb[7]
    x = cb[7][None].repeat(300, 1) + 1e-3 * torch.randn(
        300, VQ_D, generator=gen, device="cuda"
    )
    got = vq_kernel.nearest_codebook_indices(x, cb)
    winners = sorted(set(got.tolist()))
    check(winners == [7], f"tie case: kernel picked {winners}, expected [7]")
    return {"phase": "kernel_tie", "name": "vq_nearest", "winners": winners}


def adam_bound_ms(n: int, bf16: bool, has_ema: bool) -> float:
    """Least time for one fused update of n parameters: read g, p, m, v
    (and ema), write p, m, v (and ema) once each, over the HBM rate. The
    ~11 float32 operations per element are far below the f32 peak."""
    per_element = 4 + 2 * (4 + (2 if bf16 else 4) * 2 + (4 if has_ema else 0))
    return 1e3 * n * per_element / PEAK_HBM_BYTES


def compare_fused_adam(torch, fused_adam, n: int, config, gen) -> dict:
    """Kernel vs plain version over ADAM_STEPS chained steps from the same
    inputs (a new gradient and the count's bias corrections each step),
    then the times of one update."""
    name, bf16, clip, wd, has_ema = config
    mdt = torch.bfloat16 if bf16 else torch.float32
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, clip=clip, wd=wd)
    grads = [torch.randn(n, generator=gen, device="cuda") for _ in range(ADAM_STEPS)]
    p = torch.randn(n, generator=gen, device="cuda")
    start = [p, torch.zeros(n, device="cuda", dtype=mdt), torch.zeros(n, device="cuda", dtype=mdt),
             p.clone() if has_ema else None]
    ker = [None if t is None else t.clone() for t in start]
    ref = [None if t is None else t.clone() for t in start]
    for step, g in enumerate(grads):
        gscale = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        count = step + 1
        scalars = torch.stack([
            gscale, torch.full((), 1e-3, device="cuda"),
            torch.full((), 1.0 - 0.9**count, device="cuda"),
            torch.full((), 1.0 - 0.999**count, device="cuda"),
            torch.full((), 0.99, device="cuda"),
        ])
        fused_adam.fused_adam_update(g, *ker, scalars, **kw)
        fused_adam.fused_adam_plain(g, *ref, scalars, **kw)
    torch.cuda.synchronize()
    errs, mism = {}, {}
    for label, a, b in zip(("p", "m", "v", "ema"), ker, ref):
        if a is None:
            continue
        diff = (a.float() - b.float()).abs()
        errs[label] = float(diff.max())
        mism[label] = int((a != b).sum())
        if label in ("m", "v") and bf16:
            ulps = (a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max()
            check(int(ulps) <= ADAM_BF16_ULPS,
                  f"fused_adam {name}: {label} {int(ulps)} bf16 ulps from the plain version")
        else:
            rel = float((diff / b.float().abs().clamp(min=1e-30)).max())
            check(rel <= ADAM_P_RTOL or float(diff.max()) == 0.0,
                  f"fused_adam {name}: {label} differs by {rel:.3g} relative")
    # views one element off 16-byte alignment take the kernel's scalar path
    off_ker = [None if t is None else t[1:] for t in ker]
    off_ref = [None if t is None else t[1:] for t in ref]
    fused_adam.fused_adam_update(grads[0][1:], *off_ker, scalars, **kw)
    fused_adam.fused_adam_plain(grads[0][1:], *off_ref, scalars, **kw)
    torch.cuda.synchronize()
    unaligned = sum(int((a != b).sum()) for a, b in zip(ker, ref) if a is not None)
    check(unaligned == 0, f"fused_adam {name}: {unaligned} elements differ on unaligned views")
    g = grads[0]
    kernel_ms = time_ms(torch, lambda: fused_adam.fused_adam_update(g, *ker, scalars, **kw), 50)
    plain_ms = time_ms(torch, lambda: fused_adam.fused_adam_plain(g, *ref, scalars, **kw), 20)
    flat = torch.nn.Parameter(p.clone())
    flat.grad = g.clone()
    opt = torch.optim.Adam([flat], lr=1e-3, fused=True)
    library_ms = time_ms(torch, opt.step, 50)
    return {
        "phase": "kernel", "name": "fused_adam", "config": name, "n": n, "steps": ADAM_STEPS,
        "moments": "bf16" if bf16 else "f32", "clip": clip, "wd": wd, "ema": has_ema,
        "max_abs_err": max(errs.values()), "max_abs_err_by_vector": errs,
        "mismatched_elements": mism, "unaligned_mismatches": unaligned,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "library": "torch.optim.Adam(fused=True) on one flat parameter: no clip, "
                   "weight decay or EMA",
        "bound_ms": adam_bound_ms(n, bf16, has_ema), "bound_by": "bytes",
    }


def conv_bound_ms(b: int, h: int, w: int, c: int) -> tuple[float, str]:
    """Least time for the 3x3 bf16 conv: x and the output (B, H, W, C) and w
    (3, 3, C, C) in bf16 moved once, and 2 * B*H*W * 9C * C operations at
    the dense bf16 tensor-core rate."""
    bytes_ms = 1e3 * 2 * (2 * b * h * w * c + 9 * c * c) / PEAK_HBM_BYTES
    ops_ms = 1e3 * 2 * b * h * w * 9 * c * c / PEAK_BF16_FLOPS
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def compare_conv3x3(torch, conv3x3, ab, shape, gen) -> dict:
    """Both conv kernels against the plain version on the same bf16 inputs
    (the A/B script's ``parity``; cuDNN's difference is reported, not
    held), a second call of each for bit-identical output, each kernel's
    launch plan, then the times of each kernel, the plain version and cuDNN:
    back to back with the host's enqueue, and device-only (``device_time_ms``)."""
    name, (b, h, w, c) = shape
    x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
    wt = (0.02 * torch.randn(3, 3, c, c, generator=gen, device="cuda")).to(torch.bfloat16)
    library = ab.cudnn_conv(torch, wt)
    parity = ab.parity(torch, conv3x3, x, wt, library)
    identical = {}
    for k in conv3x3.KERNELS:
        fn = getattr(conv3x3, k)
        identical[k] = bool(torch.equal(fn(x, wt), fn(x, wt)))
    ms, device_ms, host_us = {}, {}, {}
    for k in conv3x3.KERNELS:
        fn = getattr(conv3x3, k)
        ms[k] = time_ms(torch, lambda fn=fn: fn(x, wt), 50)
        device_ms[k], host_us[k] = device_time_ms(torch, lambda fn=fn: fn(x, wt), 50)
    library_device_ms, _ = device_time_ms(torch, lambda: library(x), 50)
    bound_ms, bound_by = conv_bound_ms(b, h, w, c)
    return {
        "phase": "kernel", "name": "conv3x3", "shape_name": name, "shape": [b, h, w, c],
        "errors": {k: parity[k] for k in conv3x3.KERNELS},
        "run_to_run_identical": identical,
        "plan": {k: conv3x3.launch_plan(k, x, wt) for k in conv3x3.KERNELS},
        "sms": torch.cuda.get_device_properties(x.device).multi_processor_count,
        "cudnn_vs_plain_max_abs_err": parity["cudnn_vs_plain_max_abs_err"],
        "kernel_ms": ms, "kernel_device_ms": device_ms, "kernel_host_us": host_us,
        "plain_ms": time_ms(torch, lambda: conv3x3.conv3x3_plain(x, wt), 10),
        "library_ms": time_ms(torch, lambda: library(x), 50),
        "library_device_ms": library_device_ms,
        "library": "F.conv2d (cuDNN) on channels-last bf16",
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_conv_row(row: dict, ab) -> None:
    for kernel, err in row["errors"].items():
        check(err["max_ulp"] <= ab.ULP_LIMIT and err["bit_equal_frac"] >= ab.BIT_EQUAL_MIN,
              f"{kernel} {row['shape_name']}: {err} against the plain version")
        check(row["run_to_run_identical"][kernel],
              f"{kernel} {row['shape_name']}: two calls differ")
        check(row["plan"][kernel]["spill_bytes"] == 0,
              f"{kernel}: {row['plan'][kernel]['spill_bytes']} bytes spilled per thread")


def attention_bounds(bh: int, t: int, d: int, bf16: bool) -> dict:
    """Least time of each attention kernel: its inputs read once and its
    outputs written once over the HBM rate, against its causal matrix
    products (2 operations per multiply-add over the T(T+1)/2 visible
    pairs) over the peak rate of the input type. The forward does Q K^T
    and P V; the dQ kernel recomputes S, then dP and dQ; the dK/dV kernel
    recomputes S and dP, then dV and dK. For f32 inputs each kernel's
    3xTF32 bound sits beside: three TF32 products per product (the
    kernels' own route to f32 accuracy) at the dense TF32 rate, or the
    bytes if they take longer."""
    es = 2 if bf16 else 4
    n, rows = bh * t * d, bh * t
    mac = bh * t * (t + 1) // 2 * d
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    work = {"flash_fwd": (4 * n * es + 4 * rows, 2 * 2 * mac),
            "flash_bwd_dq": (6 * n * es + 8 * rows, 3 * 2 * mac),
            "flash_bwd_dkdv": (6 * n * es + 8 * rows, 4 * 2 * mac)}
    out = {}
    for name, (nbytes, ops) in work.items():
        bytes_ms, ops_ms = 1e3 * nbytes / PEAK_HBM_BYTES, 1e3 * ops / peak
        out[name] = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
        if not bf16:
            tf32_ms = 1e3 * 3 * ops / PEAK_TF32_FLOPS
            out[name] += ((tf32_ms, "operations") if tf32_ms >= bytes_ms
                          else (bytes_ms, "bytes"))
    return out


def compare_attention(torch, fa, shape, gen) -> dict:
    """The three kernels, each against its plain version on the same inputs
    (the dQ part of the plain backward takes the kernel's O, the dK/dV part
    the kernel's delta), each run twice for determinism; each kernel's
    launch plan; then the times of each kernel and of its plain version, of
    scaled_dot_product_attention's forward, and of the whole backward: both
    kernels, the plain backward and SDPA's backward, which computes dQ, dK
    and dV in one call. Kernels and SDPA are timed back to back (the host's
    enqueue included) and device-only (device_time_ms)."""
    import torch.nn.functional as F

    name, bh, t, d, bf16 = shape
    dtype = torch.bfloat16 if bf16 else torch.float32
    scale = d**-0.5
    q, k, v, do = (torch.randn(bh, t, d, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))

    def kernels():
        o, lse = fa.launch_fwd(q, k, v, scale)
        dq, delta = fa.launch_bwd_dq(q, k, v, o, do, lse, scale)
        dk, dv = fa.launch_bwd_dkdv(q, k, v, do, lse, delta, scale)
        return o, lse, dq, dk, dv, delta

    first, second = kernels(), kernels()
    torch.cuda.synchronize()
    identical = all(torch.equal(a, b) for a, b in zip(first, second))
    o, lse, dq, dk, dv, delta = first
    ro, rlse = fa.flash_attention_fwd_plain(q, k, v, scale)
    rdq, rdelta = fa.flash_attention_bwd_dq_plain(q, k, v, o, do, scale)
    rdk, rdv = fa.flash_attention_bwd_dkdv_plain(q, k, v, do, delta, scale)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max() / max(float(b.float().abs().max()), 1.0))

    errs = {"o": rel(o, ro), "dq": rel(dq, rdq), "dk": rel(dk, rdk), "dv": rel(dv, rdv)}
    plain_max = {name: float(x.float().abs().max())
                 for name, x in (("o", ro), ("dq", rdq), ("dk", rdk), ("dv", rdv))}
    lse_err = float((lse - rlse).abs().max())
    delta_err = float((delta - rdelta).abs().max())
    iters = 10 if t >= 2000 else 30
    ms = {"flash_fwd": time_ms(torch, lambda: fa.launch_fwd(q, k, v, scale), iters),
          "flash_bwd_dq": time_ms(torch, lambda: fa.launch_bwd_dq(q, k, v, o, do, lse, scale),
                                  iters),
          "flash_bwd_dkdv": time_ms(
              torch, lambda: fa.launch_bwd_dkdv(q, k, v, do, lse, delta, scale), iters)}
    plain = {
        "flash_fwd": time_ms(torch, lambda: fa.flash_attention_fwd_plain(q, k, v, scale), iters),
        "flash_bwd_dq": time_ms(
            torch, lambda: fa.flash_attention_bwd_dq_plain(q, k, v, o, do, scale), iters),
        "flash_bwd_dkdv": time_ms(
            torch, lambda: fa.flash_attention_bwd_dkdv_plain(q, k, v, do, delta, scale), iters)}
    backward_ms = time_ms(torch, lambda: fa.launch_bwd(q, k, v, o, do, lse, scale), iters)
    plain_bwd = time_ms(torch, lambda: fa.flash_attention_bwd_plain(q, k, v, o, do, scale),
                        iters)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, is_causal=True, scale=scale)

    def sdpa_fwd_call():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale)

    def sdpa_bwd_call():
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    sdpa_fwd = time_ms(torch, sdpa_fwd_call, iters)
    sdpa_bwd = time_ms(torch, sdpa_bwd_call, iters)
    device = {
        "flash_fwd": device_time_ms(torch, lambda: fa.launch_fwd(q, k, v, scale), iters)[0],
        "flash_bwd_dq": device_time_ms(
            torch, lambda: fa.launch_bwd_dq(q, k, v, o, do, lse, scale), iters)[0],
        "flash_bwd_dkdv": device_time_ms(
            torch, lambda: fa.launch_bwd_dkdv(q, k, v, do, lse, delta, scale), iters)[0]}
    device_bwd = device_time_ms(torch, lambda: fa.launch_bwd(q, k, v, o, do, lse, scale),
                                iters)[0]
    device_sdpa_fwd = device_time_ms(torch, sdpa_fwd_call, iters)[0]
    device_sdpa_bwd = device_time_ms(torch, sdpa_bwd_call, iters)[0]
    bounds = attention_bounds(bh, t, d, bf16)
    plans = {name: fa.launch_plan(name, q) for name in fa.KERNELS}
    return {
        "phase": "kernel", "name": "flash_attention", "shape_name": name, "bh": bh, "t": t,
        "d": d, "dtype": "bf16" if bf16 else "f32", "rel_err": errs, "plain_max": plain_max,
        "lse_max_abs_err": lse_err,
        "delta_max_abs_err": delta_err,
        "max_abs_err": {"flash_fwd": float((o.float() - ro.float()).abs().max()),
                        "flash_bwd_dq": float((dq.float() - rdq.float()).abs().max()),
                        "flash_bwd_dkdv": max(float((a.float() - b.float()).abs().max())
                                              for a, b in ((dk, rdk), (dv, rdv)))},
        "run_to_run_identical": identical, "kernel_ms": ms, "plain_ms": plain,
        "device_ms": device,
        # no library call computes dQ alone or dK/dV alone
        "library_ms": {"flash_fwd": sdpa_fwd, "flash_bwd_dq": None, "flash_bwd_dkdv": None},
        "library_device_ms": {"flash_fwd": device_sdpa_fwd, "flash_bwd_dq": None,
                              "flash_bwd_dkdv": None},
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal=True)",
        "backward": {"ms": backward_ms, "device_ms": device_bwd, "plain_ms": plain_bwd,
                     "library_ms": sdpa_bwd, "library_device_ms": device_sdpa_bwd,
                     "note": "dQ then dK/dV kernels, the plain backward, and SDPA's "
                             "backward (dQ, dK and dV in one call)"},
        "bound_ms": {k: b[0] for k, b in bounds.items()},
        "bound_by": {k: b[1] for k, b in bounds.items()},
        "bound_3xtf32_ms": {k: b[2] if len(b) > 2 else None for k, b in bounds.items()},
        "plan": plans,
    }


# ---------------------------------------------------------------------------
# Phase 4: serving
# ---------------------------------------------------------------------------


def chirp_wav_bytes(seconds: float, sr: int) -> tuple[bytes, int]:
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    f = 110.0 + (2000.0 - 110.0) * t / seconds
    wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr) * 32767).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, sr, wav)
    return buf.getvalue(), len(wav)


def request(url: str, data: bytes | None = None) -> tuple[int, bytes, float]:
    req = urllib.request.Request(url, data=data)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            body, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    return status, body, time.perf_counter() - t0


def read_wav(body: bytes, sr: int) -> np.ndarray:
    from scipy.io import wavfile

    check(body[:4] == b"RIFF" and body[8:12] == b"WAVE", "response is not RIFF/WAVE")
    rate, wav = wavfile.read(io.BytesIO(body))
    check(rate == sr, f"sample rate {rate}, expected {sr}")
    check(wav.dtype == np.int16 and wav.ndim == 1, f"wav {wav.dtype} {wav.shape}")
    # the server peak-normalizes into [-32767, 32767]; a NaN cast to int16
    # lands outside it (finiteness itself is checked on the device output)
    peak = int(np.abs(wav.astype(np.int32)).max())
    check(0 < peak <= 32767, f"waveform peak {peak}")
    return wav


def check_finite_outputs(torch, service, wav_bytes: bytes, codes: np.ndarray) -> None:
    """The float waveforms behind /reconstruct and /decode are finite."""
    with torch.inference_mode():
        padded, _ = service._pad_for_reconstruct(wav_bytes)
        wav = service._reconstruct_wav(torch.from_numpy(padded).cuda()[None])
        idx = torch.from_numpy(codes).cuda()[None]
        dec = service._vocode(service.model.decode(idx)[0, :, :, 0])
        check(bool(torch.isfinite(wav).all()), "non-finite /reconstruct waveform")
        check(bool(torch.isfinite(dec).all()), "non-finite /decode waveform")


def serve_phase(torch, serve, dsp, vq_kernel, VQVAE) -> dict:
    args = serve.parse_args(["--device", "cuda"])
    check((args.dim, args.z_dim, args.frames) == (256, 512, 84),
          "serving defaults are not the flagship width")
    t0 = time.perf_counter()
    service = serve.build_service(args)
    build_s = time.perf_counter() - t0
    cfg = service.cfg.audio
    sr, hop = cfg.sample_rate, cfg.effective_hop_size
    chirps = {seconds: chirp_wav_bytes(seconds, sr) for seconds in CHIRP_SECONDS}
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    lat: dict = {}
    # every count is read over the HTTP requests alone
    vq_kernel.reset_launch_count()
    try:
        status, body, _ = request(base + "/health")
        check(status == 200 and json.loads(body) == {"status": "ok", "backend": "cuda"},
              f"/health: {status} {body[:200]!r}")

        def run_all(record: bool) -> dict:
            outs = {}
            for seconds, (wav_bytes, n) in chirps.items():
                t = dsp.num_stft_frames(n, cfg.fft_size, hop)
                status, body, dt = request(base + "/encode", wav_bytes)
                check(status == 200, f"/encode {seconds}s: {status} {body[:200]!r}")
                enc = json.loads(body)
                codes = np.asarray(enc["codes"])
                want = [cfg.num_mels // 4, -(-t // 4)]
                check(enc["shape"] == want and list(codes.shape) == want,
                      f"/encode {seconds}s shape {enc['shape']}, expected {want}")
                check(codes.min() >= 0 and codes.max() < args.z_dim, "codes out of range")
                if record:
                    lat.setdefault(("/encode", seconds), []).append(dt)
                status, body, dt = request(base + "/reconstruct", wav_bytes)
                check(status == 200, f"/reconstruct {seconds}s: {status} {body[:200]!r}")
                rec = read_wav(body, sr)
                check(len(rec) == n, f"/reconstruct {seconds}s: {len(rec)} samples, expected {n}")
                if record:
                    lat.setdefault(("/reconstruct", seconds), []).append(dt)
                payload = json.dumps({"codes": enc["codes"]}).encode()
                status, body, dt = request(base + "/decode", payload)
                check(status == 200, f"/decode {seconds}s: {status} {body[:200]!r}")
                dec = read_wav(body, sr)
                want_len = hop * (4 * codes.shape[1] - 1)
                check(len(dec) == want_len, f"/decode {seconds}s: {len(dec)} samples, expected {want_len}")
                if record:
                    lat.setdefault(("/decode", seconds), []).append(dt)
                outs[seconds] = (wav_bytes, codes, rec)
            return outs

        # warm-up (cuDNN algorithm choice, FFT plans), then the timed rounds
        run_all(record=False)
        for _ in range(TIMED_REPEATS):
            outs = run_all(record=True)

        # bursts of concurrent /reconstruct requests through the batcher
        sizes: list = []
        run_batch = service.reconstruct_batched
        service.enable_batching(10.0, 8)
        service.batcher._run_batch = lambda reqs: (sizes.append(len(reqs)), run_batch(reqs))[1]
        wav_bytes, _, rec_seq = outs[3.0]
        burst = []
        with concurrent.futures.ThreadPoolExecutor(BURST) as pool:
            for _ in range(BURST_ROUNDS):
                futures = [pool.submit(request, base + "/reconstruct", wav_bytes)
                           for _ in range(BURST)]
                burst += [f.result() for f in futures]
        for status, body, _ in burst:
            check(status == 200, f"batched /reconstruct: {status} {body[:200]!r}")
            check(len(read_wav(body, sr)) == len(rec_seq), "batched length differs")
        burst_diff = max(
            int(np.abs(read_wav(b, sr).astype(np.int32) - rec_seq).max()) for _, b, _ in burst
        )
        burst_ms = [1e3 * dt for _, _, dt in burst]

        status, body, _ = request(base + "/metrics")
        check(status == 200, f"/metrics: {status}")
        metrics = json.loads(body)
        check(all(metrics["endpoints"][p]["errors"] == 0
                  for p in ("/encode", "/reconstruct", "/decode")), "endpoint errors")
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = vq_kernel.launch_count()
    # one launch per /encode and per unbatched /reconstruct (all windows of
    # a request in one call), one per micro-batch of equal-length requests,
    # none for /decode
    want_launches = 2 * len(CHIRP_SECONDS) * (1 + TIMED_REPEATS) + len(sizes)
    check(launches == want_launches,
          f"the HTTP requests launched vq_nearest {launches} times, expected {want_launches}")

    for wav_bytes, codes, _ in outs.values():
        check_finite_outputs(torch, service, wav_bytes, codes)

    # the same model on the CPU (plain nearest-code search) is the reference
    ref_model = VQVAE(1, args.dim, args.z_dim)
    ref_model.load_state_dict({k: v.cpu() for k, v in service.model.state_dict().items()})
    ref_model.eval()
    wav_bytes, codes_gpu, _ = outs[1.0]
    with torch.inference_mode():
        windows, t, n_win = service._wav_to_mel(wav_bytes)
        mel_gpu = service._reconstruct(windows).cpu()
        mel_cpu = ref_model(windows.cpu())[0]
        codes_cpu = service._stitch(ref_model.encode(windows.cpu())[:n_win].numpy(), t, 4)
    code_mismatch = float(np.mean(codes_cpu != codes_gpu))
    mel_err = float((mel_gpu - mel_cpu).abs().max())
    check(code_mismatch <= 0.005, f"card vs CPU codes differ at {code_mismatch:.4%} of positions")
    check(mel_err <= 1e-3, f"card vs CPU reconstructed mel differs by {mel_err}")

    latency = {}
    for (path, seconds), values in sorted(lat.items()):
        ms = 1e3 * np.asarray(values)
        latency[f"{path}@{seconds:g}s"] = {
            "n": len(values), "p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90)),
        }
    return {
        "phase": "serving", "dim": args.dim, "z_dim": args.z_dim, "frames": args.frames,
        "gl_iters": cfg.griffin_lim_iters, "gl_momentum": cfg.griffin_lim_momentum,
        "build_service_s": build_s, "latency_ms": latency,
        "burst": BURST, "burst_rounds": BURST_ROUNDS, "burst_batch_sizes": sizes,
        "burst_ms": {"n": len(burst_ms), "p50": float(np.percentile(burst_ms, 50)),
                     "p90": float(np.percentile(burst_ms, 90))},
        "burst_max_int16_diff_vs_unbatched": burst_diff,
        "cpu_reference": {"code_mismatch_frac": code_mismatch, "mel_max_abs_err": mel_err},
        "vq_launches": launches,
    }


# ---------------------------------------------------------------------------
# Phase 5: training
# ---------------------------------------------------------------------------


def write_corpus(torch, dsp, audio_cfg, root: str) -> None:
    """Chirps of 0.5-0.8 s (43-69 frames, longer than the 28-frame crop)
    with mels from the port's own analysis, in the manifest layout."""
    from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, write_manifest

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(SEED)
    sr = audio_cfg.sample_rate
    entries = []
    for i in range(CORPUS_UTTERANCES):
        t = np.arange(int(sr * rng.uniform(0.5, 0.8))) / sr
        f = rng.uniform(80, 400) + rng.uniform(300, 4000) * t / t[-1]
        wav = (rng.uniform(0.2, 0.7) * np.sin(2 * np.pi * np.cumsum(f) / sr)).astype(np.float32)
        mel = dsp.melspectrogram(torch.from_numpy(wav).to(DEVICE), audio_cfg).T.cpu().numpy()
        np.save(os.path.join(root, f"a{i}.npy"), wav)
        np.save(os.path.join(root, f"m{i}.npy"), mel.astype(np.float32))
        entries.append(ManifestEntry(f"a{i}.npy", f"m{i}.npy", len(wav), "chirp"))
    write_manifest(root, entries)


LOSS_RE = re.compile(r"\sloss=(\S+)")


def run_cli_main(cli_main, kernels, argv) -> dict:
    """One ``cli.main`` run with every launch count set to 0 just before it
    and read just after; its output is kept and its logged losses parsed."""
    for k in kernels:
        k.reset_launch_count()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_main.main(argv)
    seconds = time.perf_counter() - t0
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launch_count() for k in kernels}
    text = out.getvalue()
    losses = [float(v) for v in LOSS_RE.findall(text)]
    return {"seconds": seconds, "launches": launches, "losses": losses,
            "epochs_logged": text.count("====> Epoch"), "evals": text.count("====> Test")}


def train_phase(torch, dsp, cli_main, serve, checkpoint, vq_kernel, fused_adam,
                root: str) -> tuple[dict, str, str]:
    """Returns (the phase's record, the trained checkpoint, the corpus)."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
    from neural_sound_generation_tpu_torch.ops.vq import vq
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    corpus = os.path.join(root, "corpus")
    t0 = time.perf_counter()
    write_corpus(torch, dsp, Config().audio, corpus)
    corpus_s = time.perf_counter() - t0

    def argv(tag, epochs, multi, *extra):
        return ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", corpus,
                "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES),
                "--batch-size", str(TRAIN_BATCH), "--epochs", str(epochs),
                "--multi-steps", str(multi), "--max-batches-per-epoch", str(BATCHES_PER_EPOCH),
                "--log-interval", "1", "--codebook-init", "data", "--device", DEVICE,
                "--ckpt-dir", os.path.join(root, tag, "models"),
                "--sampledir", os.path.join(root, tag, "results"), *extra]

    def ckpt_dir(tag):
        return os.path.join(root, tag, "models", "vqvae",
                            f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")

    kernels = (vq_kernel, fused_adam)
    runs = {}
    for tag, multi in (("multi1", 1), ("multi4", 4)):
        runs[tag] = run_cli_main(cli_main, kernels, argv(tag, 2, multi))
    before_resume = checkpoint.latest_step(ckpt_dir("multi4"))
    runs["resume"] = run_cli_main(cli_main, kernels, argv("multi4", 3, 4, "--resume"))

    # every run: 8 mini-batches per epoch are 8 optimizer steps (two
    # super-batches of 4 under --multi-steps 4); one eval batch per epoch
    # runs the nearest-code search twice (forward and encode)
    for tag, epochs in (("multi1", 2), ("multi4", 2), ("resume", 1)):
        r = runs[tag]
        steps = epochs * BATCHES_PER_EPOCH
        r["optimizer_steps"] = steps
        check(r["epochs_logged"] == epochs and r["evals"] == epochs,
              f"{tag}: {r['epochs_logged']} epochs and {r['evals']} evals, expected {epochs}")
        check(r["launches"]["fused_adam"] == steps,
              f"{tag}: fused_adam launched {r['launches']['fused_adam']} times for {steps} steps")
        want_vq = steps + 2 * epochs
        check(r["launches"]["vq_kernel"] == want_vq,
              f"{tag}: vq_nearest launched {r['launches']['vq_kernel']} times, expected {want_vq}")
        check(len(r["losses"]) >= 1 and all(np.isfinite(r["losses"])), f"{tag}: losses {r['losses']}")
    for tag in ("multi1", "multi4"):
        ls = runs[tag]["losses"]
        check(ls[-1] < ls[0], f"{tag}: the loss did not fall ({ls[0]} -> {ls[-1]})")
    check(before_resume == 2 * BATCHES_PER_EPOCH,
          f"multi4: checkpoint at step {before_resume}, expected {2 * BATCHES_PER_EPOCH}")
    after = checkpoint.latest_step(ckpt_dir("multi4"))
    check(after == before_resume + BATCHES_PER_EPOCH,
          f"--resume: checkpoint at step {after}, expected {before_resume + BATCHES_PER_EPOCH}")
    extra = checkpoint.read_extra(ckpt_dir("multi4"))
    check(extra == {"epoch": 3, "arch": "vqvae", "num_quantizers": 1, "num_downsample": 6},
          f"--resume: checkpoint metadata {extra}")
    check(os.path.exists(os.path.join(ckpt_dir("multi4"), f"step_{after}", "_extra.json")),
          "no _extra.json beside the checkpoint")
    ckpt = ckpt_dir("multi4")

    # one train step on the card against the same step on the CPU: the
    # trained checkpoint (warm moments), one batch of the corpus
    args = cli_main.parse_args(argv("multi4", 3, 1))
    cfg = cli_main.build_config(args)
    train_loader, _ = cli_main.audio_loaders(args, cfg)
    batch = next(iter(train_loader))
    states, metrics, codes = {}, {}, {}
    for device in (DEVICE, "cpu"):
        model = cli_main.make_model(cfg).to(device)
        state = create_train_state(model, cfg.train)
        checkpoint.restore(ckpt, state)
        x = torch.from_numpy(batch["x"]).to(device)
        with torch.no_grad(), batch_stats_discarded(model):
            model.train()
            codes[device] = vq(model._encode_latents(x), model.codebook).cpu()
        _, m = make_train_step(model, cfg)(state, {"x": x})
        states[device], metrics[device] = state, {k: float(v) for k, v in m.items()}
    rel = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
           for k in metrics["cpu"]}
    flips = int((codes[DEVICE] != codes["cpu"]).sum())
    diff = (states[DEVICE].flat.flat.cpu() - states["cpu"].flat.flat).abs()
    by_name = states["cpu"].flat.named(diff)
    cb_rows = int((by_name.pop("codebook") > 1e-5).any(dim=1).sum())
    rest_max = max(float(t.max()) for t in by_name.values())
    far = float((diff > 1e-5).float().mean())
    g_card = states["cpu"].flat.named(states[DEVICE].flat.grad.cpu())
    g_cpu = states["cpu"].flat.named(states["cpu"].flat.grad)
    grad_rel = sorted(
        ((float((g_card[k] - g_cpu[k]).norm()), float(g_cpu[k].norm()), k) for k in g_cpu),
        reverse=True)[:6]
    beyond = {k: int((t > 1e-5).sum()) for k, t in states["cpu"].flat.named(diff).items()
              if int((t > 1e-5).sum())}
    compare = {"metrics_rel_err": rel, "code_flips": flips, "rows": int(codes["cpu"].numel()),
               "params_beyond_1e-5_frac": far, "params_max_abs_err": float(diff.max()),
               "codebook_rows_beyond_1e-5": cb_rows, "other_params_max_abs_err": rest_max,
               "grad_diff_norm_worst": grad_rel, "params_beyond_1e-5": beyond,
               "grad_norm": metrics[DEVICE]["grad_norm"]}
    emit({"phase": "card_vs_cpu_step", **compare})
    # TF32 is off, so only the order of f32 sums differs: codes equal but
    # at near-ties (at most 0.1% of rows); loss terms within 1e-5
    # relative; grad_norm within 1e-5 relative, or 2e-3 when a code
    # flipped (the row's codebook gradient lands on another code); 99.9%
    # of the updated parameters within 1e-5 and all within 1e-2: a conv
    # bias that feeds a train-mode BatchNorm has a true gradient of 0 and a
    # computed one of rounding noise, which Adam turns into steps of up to
    # about lr, as does a flipped code to its codebook rows
    check(flips <= 1e-3 * codes["cpu"].numel(), f"card vs CPU: {flips} codes differ")
    check(max(v for k, v in rel.items() if k != "grad_norm") <= 1e-5,
          f"card vs CPU train step: loss terms differ {rel}")
    check(rel["grad_norm"] <= (2e-3 if flips else 1e-5),
          f"card vs CPU train step: grad_norm differs by {rel['grad_norm']:.3g} ({flips} flips)")
    check(far <= 1e-3 and float(diff.max()) <= 1e-2,
          f"card vs CPU train step: {far:.3%} of parameters beyond 1e-5, max {float(diff.max())}")

    # train steps/s with a device-resident batch
    state, model = states[DEVICE], states[DEVICE].model
    step = make_train_step(model, cfg)
    x = torch.from_numpy(batch["x"]).to(DEVICE)
    for _ in range(5):
        step(state, {"x": x})
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        step(state, {"x": x})
    sync()
    step_s = (time.perf_counter() - t0) / TIMED_STEPS
    del states, state, model
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    served = serve_trained(torch, serve, ckpt)
    return {
        "phase": "training", "dim": TRAIN_DIM, "codes": TRAIN_CODES, "batch": TRAIN_BATCH,
        "crop_frames": int(batch["x"].shape[2]), "corpus_utterances": CORPUS_UTTERANCES,
        "corpus_s": corpus_s,
        "runs": {tag: {k: v for k, v in r.items() if k != "losses"} | {
            "first_loss": r["losses"][0], "last_loss": r["losses"][-1]}
            for tag, r in runs.items()},
        "checkpoint_steps": {"before_resume": before_resume, "after_resume": after},
        "card_vs_cpu_step": compare,
        "train_step_ms": 1e3 * step_s, "train_steps_per_s": 1.0 / step_s,
        "timed_steps": TIMED_STEPS, "served_from_checkpoint": served,
    }, ckpt, corpus


# ---------------------------------------------------------------------------
# Phase 6: residual VQ and --bf16 training
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def cpu_drawn_restarts(torch, trainer, seed: int, draws: list):
    """Dead-code restarts draw their rows from one CPU generator seeded with
    ``seed``, on the card and on the CPU alike (a CUDA generator draws other
    numbers), so a card step and a CPU step restart the same codes from the
    same rows; each stage's drawn rows and restarted codes are appended to
    ``draws``."""
    from neural_sound_generation_tpu_torch.ops.vq import restart_rows

    real = trainer.restart_dead_codes
    gen = torch.Generator().manual_seed(seed)

    def drawn(codebook, usage, batch_flat, generator, threshold=1.0, cluster=None,
              embed_sum=None):
        idx = torch.randint(0, batch_flat.shape[0], (codebook.shape[0],), generator=gen)
        draws.append((idx, (usage < threshold).cpu()))
        return restart_rows(codebook, usage, batch_flat[idx.to(batch_flat.device)], threshold,
                            cluster, embed_sum)

    trainer.restart_dead_codes = drawn
    try:
        yield
    finally:
        trainer.restart_dead_codes = real


def rvq_flip_causes(torch, z_cpu, z_card, codebooks, cpu_codes, card_codes) -> dict:
    """Every card-vs-CPU code flip of a residual-VQ assignment, classified.
    Stage by stage the CPU's residual (its z_e less its codes so far) and
    the card's (its z_e less its codes) are followed in float64, and each
    flip must be a near-tie (``near_ties``) between the two. A flip in a
    row that flipped before (a cascade) is held the same way: its two
    residuals differ by the earlier codes too, and the rule allows for
    exactly that. Rows with the same CPU residual and the same two codes
    are one decision, made once for all of them: ``flipped_vectors``
    counts the decisions, ``largest_flip_group`` the most rows one of them
    flipped. ``codebooks`` (Q, K, D) float64, codes (Q, N)."""
    d = codebooks.shape[-1]
    flipped = card_codes != cpu_codes
    r_cpu, r_card = z_cpu.reshape(-1, d).double(), z_card.reshape(-1, d).double()
    before = torch.zeros_like(flipped[0])
    first, cascaded, not_near, vectors, group = 0, 0, 0, 0, 0
    excess, excess_d_min = [], []
    for q in range(cpu_codes.shape[0]):
        rows = flipped[q]
        first += int((rows & ~before).sum())
        cascaded += int((rows & before).sum())
        if rows.any():
            rc, ra = r_cpu[rows], r_card[rows]
            a, c = card_codes[q][rows], cpu_codes[q][rows]
            ca, cc = codebooks[q][a], codebooks[q][c]
            over_scale, over_d_min = tie_excess(rc, ra, ca, cc)
            not_near += int((over_scale > NEAR_TIE_REL).sum())
            keys = torch.cat([rc, a[:, None].double(), c[:, None].double()], dim=1)
            counts = torch.unique(keys, dim=0, return_counts=True)[1]
            vectors += counts.numel()
            group = max(group, int(counts.max()))
            excess.append(over_scale)
            excess_d_min.append(over_d_min)
        before = before | rows
        r_cpu = r_cpu - codebooks[q][cpu_codes[q]]
        r_card = r_card - codebooks[q][card_codes[q]]
    return {
        "flips_first": first, "flips_cascaded": cascaded, "flips_not_near_ties": not_near,
        "flipped_vectors": vectors, "largest_flip_group": group,
        # the largest tie_excess over flips, over the score scale (at most
        # NEAR_TIE_REL where every flip is a near-tie) and over min(d_a, d_b)
        "flip_tie_excess_max": float(torch.cat(excess).max()) if excess else None,
        "flip_tie_excess_over_d_min_max": (float(torch.cat(excess_d_min).max())
                                           if excess else None),
    }


def identical_rows(torch, z) -> dict:
    """How many distinct rows a (..., D) latent holds, and the most rows
    that share one value bit for bit."""
    counts = torch.unique(z.reshape(-1, z.shape[-1]), dim=0, return_counts=True)[1]
    return {"rows": int(counts.sum()), "distinct": counts.numel(),
            "largest_group": int(counts.max())}


def rvq_card_vs_cpu(torch, cli_main, checkpoint, trainer, cfg, ckpt: str, batch,
                    dtype) -> dict:
    """One residual-VQ train step (EMA codebooks with restarts) on the card
    and on the CPU from the same checkpoint and batch, with the same restart
    draws. The new codebook rows are EMA means of the stages' residuals and
    restarted rows copies of them; with the same assignments a residual
    differs between the devices only as the encoder output does, so a row
    may differ by more than 1e-5 + max |z_e card - z_e CPU| only where an
    assignment flipped on a near-tie: the old and new codes of a flipped
    vector at its stage and at every later stage (whose residual it
    changed), and a code restarted from such a vector's residual.

    A flipped vector also changes loss_vq and the commitment term (and the
    losses that sum them) by what its quantization error under the card's
    codes differs from that under the CPU's. That part is computed from the
    CPU's z_e and pre-step codebooks under both assignment chains, in
    float64, and reported beside the rest of each metric's difference; it
    is zero when no code flipped."""
    from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
    from neural_sound_generation_tpu_torch.ops.vq import residual_vq
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    states, metrics, codes, draws, z_e, codebooks = {}, {}, {}, {}, {}, {}
    for device in (DEVICE, "cpu"):
        model = cli_main.make_model(cfg, dtype=dtype).to(device)
        state = create_train_state(model, cfg.train, ema_codebook=True)
        checkpoint.restore(ckpt, state)
        x = torch.from_numpy(batch["x"]).to(device)
        with torch.no_grad(), batch_stats_discarded(model):
            model.train()
            z = model._encode_latents(x)
            codes[device] = residual_vq(z, model.codebook)[2].cpu()
            z_e[device] = z.cpu()
            codebooks[device] = model.codebook.detach().cpu().double()  # before the step
        draws[device] = []
        with cpu_drawn_restarts(torch, trainer, SEED, draws[device]):
            _, m = trainer.make_train_step(model, cfg)(state, {"x": x})
        states[device], metrics[device] = state, {k: float(v) for k, v in m.items()}
    rel = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
           for k in metrics["cpu"]}
    card_codes, cpu_codes = codes[DEVICE].long(), codes["cpu"].long()
    flipped = card_codes != cpu_codes  # (Q, N)
    upto = torch.cumsum(flipped.int(), dim=0) > 0  # flipped at this stage or before

    # what the flipped vectors alone add to mean((z_q - z_e)^2) under the
    # card's assignment chain rather than the CPU's
    rows = upto[-1]
    cb64 = codebooks["cpu"]
    z64 = z_e["cpu"].reshape(-1, cb64.shape[-1]).double()[rows]

    def quantization_error(chain):
        z_q = sum(cb64[q][chain[q][rows]] for q in range(chain.shape[0]))
        return float(((z_q - z64) ** 2).sum()) / z_e["cpu"].numel()

    vq_part = quantization_error(card_codes) - quantization_error(cpu_codes)

    causes = rvq_flip_causes(torch, z_e["cpu"], z_e[DEVICE], cb64, cpu_codes, card_codes)
    beta = cfg.model.beta
    explained = {"loss_vq": vq_part, "loss_commit": vq_part, "train_loss": vq_part,
                 "loss": (1 + beta) * vq_part}
    rest_rel = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k] - explained.get(k, 0.0))
                / abs(metrics["cpu"][k]) for k in metrics["cpu"]}
    q_stages, k_codes = cpu_codes.shape[0], cfg.model.z_dim
    involved = torch.zeros(q_stages, k_codes, dtype=torch.bool)
    for q in range(q_stages):
        involved[q, cpu_codes[q][upto[q]]] = True
        involved[q, card_codes[q][upto[q]]] = True
        if q > 0:
            idx, restarted = draws["cpu"][q]
            involved[q] |= restarted & upto[q - 1][idx]
    z_err = float((z_e[DEVICE] - z_e["cpu"]).abs().max())
    cb_tol = 1e-5 + z_err
    diff = (states[DEVICE].flat.flat.cpu() - states["cpu"].flat.flat).abs()
    by_name = states["cpu"].flat.named(diff)
    cb_diff = by_name.pop("codebook")
    cb_rows = (cb_diff > cb_tol).any(dim=-1)  # (Q, K)
    rest = torch.cat([t.reshape(-1) for t in by_name.values()])
    return {
        "dtype": str(dtype).replace("torch.", ""), "metrics_rel_err": rel,
        "flipped_rows": int(rows.sum()), **causes,
        "z_e_cpu_rows": identical_rows(torch, z_e["cpu"]),
        "metrics_rel_explained_by_flips": {k: v / abs(metrics["cpu"][k])
                                           for k, v in explained.items()},
        "metrics_rel_err_rest": rest_rel,
        "code_flips_by_stage": flipped.sum(dim=1).tolist(), "rows": int(cpu_codes.shape[1]),
        "z_e_max_abs_err": z_err, "codebook_max_abs_err": float(cb_diff.max()),
        "codebook_rows_beyond_1e-5": int((cb_diff > 1e-5).any(dim=-1).sum()),
        "codebook_rows_beyond_tol": int(cb_rows.sum()),
        "codebook_rows_not_from_a_flip": int((cb_rows & ~involved).sum()),
        "restarted_codes_by_stage": [int(dead.sum()) for _, dead in draws["cpu"]],
        "other_params_beyond_1e-5_frac": float((rest > 1e-5).float().mean()),
        "other_params_max_abs_err": float(rest.max()),
        "grad_norm": metrics[DEVICE]["grad_norm"], "loss": metrics[DEVICE]["loss"],
    }


def rvq_steps_per_s(torch, cli_main, cfg, batch, dtype, num_quantizers: int) -> float:
    """Train steps/s at the training phase's shape with a device-resident
    batch, EMA codebooks with restarts, seeded weights."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_quantizers=num_quantizers))
    model = cli_main.make_model(cfg, generator=torch.Generator().manual_seed(SEED),
                                dtype=dtype).to(DEVICE)
    state = create_train_state(model, cfg.train, ema_codebook=True)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = torch.from_numpy(batch["x"]).to(DEVICE)
    for _ in range(5):
        step(state, {"x": x}, gen)
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(RVQ_TIMED_STEPS):
        step(state, {"x": x}, gen)
    sync(torch)
    return RVQ_TIMED_STEPS / (time.perf_counter() - t0)


def rvq_argv(out: str, corpus: str) -> list:
    """``cli.main``'s arguments for the residual-VQ phase's training, less
    --epochs and --bf16; checkpoints and samples under ``out``."""
    return ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", corpus,
            "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES),
            "--batch-size", str(TRAIN_BATCH), "--max-batches-per-epoch", str(BATCHES_PER_EPOCH),
            "--log-interval", "1", "--codebook-init", "data", "--device", DEVICE,
            "--ckpt-dir", os.path.join(out, "models"), "--sampledir", os.path.join(out, "results"),
            "--num-quantizers", str(RVQ_Q), "--ema-codebook", "--restart-dead-threshold", "1.0"]


def rvq_phase(torch, cli_main, cli_evaluate, checkpoint, vq_kernel, fused_adam, root: str,
              corpus: str) -> dict:
    """``cli.main --num-quantizers 4 --bf16 --ema-codebook
    --restart-dead-threshold 1.0 --codebook-init data`` at the training
    phase's full width for RVQ_EPOCHS epochs, with its launch counts; the
    checkpoint (float32, its metadata); ``cli.evaluate --num-quantizers 4
    --bf16`` on it; one float32 and one bf16 RVQ step card vs CPU; steps/s."""
    from neural_sound_generation_tpu_torch.training import trainer

    tag = "rvq_bf16"
    argv = rvq_argv(os.path.join(root, tag), corpus)
    run = run_cli_main(cli_main, (vq_kernel, fused_adam),
                       argv + ["--epochs", str(RVQ_EPOCHS), "--bf16"])
    steps = RVQ_EPOCHS * BATCHES_PER_EPOCH
    # data init: one search per stage after the first; a step: Q in the
    # forward and Q in the EMA branch; an eval batch: Q in the forward and
    # Q in encode (one eval batch per epoch)
    want_vq = (RVQ_Q - 1) + 2 * RVQ_Q * steps + 2 * RVQ_Q * RVQ_EPOCHS
    check(run["epochs_logged"] == RVQ_EPOCHS and run["evals"] == RVQ_EPOCHS,
          f"{tag}: {run['epochs_logged']} epochs and {run['evals']} evals")
    check(run["launches"]["fused_adam"] == steps,
          f"{tag}: fused_adam launched {run['launches']['fused_adam']} times for {steps} steps")
    check(run["launches"]["vq_kernel"] == want_vq,
          f"{tag}: vq_nearest launched {run['launches']['vq_kernel']} times, expected {want_vq}")
    losses = run["losses"]
    check(len(losses) >= 2 and all(np.isfinite(losses)), f"{tag}: losses {losses}")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall ({losses[0]} -> {losses[-1]})")

    ckpt = os.path.join(root, tag, "models", "vqvae",
                        f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    extra = checkpoint.read_extra(ckpt)
    check(extra == {"epoch": RVQ_EPOCHS, "arch": "vqvae", "num_quantizers": RVQ_Q,
                    "num_downsample": 6}, f"{tag}: checkpoint metadata {extra}")
    saved = torch.load(os.path.join(ckpt, f"step_{steps}", "state.pt"), weights_only=True)
    float_leaves = {k: t.dtype for k, t in saved.items()
                    if k.startswith(("params/", "ema_params/", "batch_stats/", "codebook_ema/"))}
    check(all(dt == torch.float32 for dt in float_leaves.values()),
          f"{tag}: checkpoint leaves not float32: "
          f"{ {k: str(d) for k, d in float_leaves.items() if d != torch.float32} }")
    check(tuple(saved["params/codebook"].shape) == (RVQ_Q, TRAIN_CODES, TRAIN_DIM),
          f"{tag}: codebook {tuple(saved['params/codebook'].shape)}")
    del saved

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        evaluated = cli_evaluate.main([
            "--datadir", corpus, "--ckpt-dir", ckpt, "--dim", str(TRAIN_DIM),
            "--z-dim", str(TRAIN_CODES), "--batch-size", str(TRAIN_BATCH), "--max-batches", "1",
            "--num-quantizers", str(RVQ_Q), "--bf16", "--device", DEVICE])
    check(np.isfinite(evaluated["loss"]) and evaluated["perplexity"] >= 1.0,
          f"cli.evaluate --num-quantizers {RVQ_Q} --bf16: {evaluated}")

    args = cli_main.parse_args(argv + ["--epochs", "1"])
    cfg = cli_main.build_config(args)
    train_loader, _ = cli_main.audio_loaders(args, cfg)
    batch = next(iter(train_loader))
    f32 = rvq_card_vs_cpu(torch, cli_main, checkpoint, trainer, cfg, ckpt, batch, torch.float32)
    emit({"phase": "rvq_card_vs_cpu_step", **f32})
    flips = sum(f32["code_flips_by_stage"])
    rel = f32["metrics_rel_err"]
    # every flip, a row's first and its cascades alike, is a near-tie
    # between the two devices' residuals, and at most 1e-3 of the
    # assignments are flipped decisions. The corpus's mels sit at the floor
    # in most bins, so a batch's z_e repeats rows bit for bit (z_e_cpu_rows)
    # and one near-tie flips every row of such a group: the bound counts
    # decisions, not rows
    check(f32["flips_not_near_ties"] == 0,
          f"RVQ card vs CPU: {f32['flips_not_near_ties']} of {flips} code flips are not "
          f"near-ties")
    check(f32["flipped_vectors"] <= 1e-3 * RVQ_Q * f32["rows"],
          f"RVQ card vs CPU: {f32['flipped_vectors']} distinct vectors flipped "
          f"({flips} codes)")
    # with no flip the rest is the whole difference; with flips, what the
    # flipped vectors' quantization error explains is taken out first
    rest = f32["metrics_rel_err_rest"]
    check(max(v for k, v in rest.items() if k != "grad_norm") <= 1e-5,
          f"RVQ card vs CPU train step: loss terms differ {rel}, "
          f"{rest} beyond what the flips explain")
    check(rel["grad_norm"] <= (2e-3 if flips else 1e-5),
          f"RVQ card vs CPU train step: grad_norm differs by {rel['grad_norm']:.3g}")
    check(f32["other_params_beyond_1e-5_frac"] <= 1e-3 and f32["other_params_max_abs_err"] <= 1e-2,
          f"RVQ card vs CPU train step: parameters differ {f32}")
    check(f32["codebook_rows_not_from_a_flip"] == 0,
          f"RVQ card vs CPU train step: {f32['codebook_rows_not_from_a_flip']} codebook rows "
          f"differ by more than 1e-5 + max |dz_e| without a flipped assignment")
    bf16 = rvq_card_vs_cpu(torch, cli_main, checkpoint, trainer, cfg, ckpt, batch,
                           torch.bfloat16)
    emit({"phase": "rvq_card_vs_cpu_step", **bf16})
    bf16_loss = {k: v for k, v in bf16["metrics_rel_err"].items() if k != "grad_norm"}
    check(max(bf16_loss.values()) <= RVQ_BF16_LOSS_REL,
          f"bf16 RVQ card vs CPU train step: loss terms differ {bf16_loss}")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    steps_per_s = {
        f"{name}_q{q}": rvq_steps_per_s(torch, cli_main, cfg, batch, dtype, q)
        for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32))
        for q in (RVQ_Q, 1)
    }
    return {
        "phase": "rvq_bf16_training", "dim": TRAIN_DIM, "codes": TRAIN_CODES,
        "num_quantizers": RVQ_Q, "batch": TRAIN_BATCH,
        "crop_frames": int(batch["x"].shape[2]),
        "run": {k: v for k, v in run.items() if k != "losses"} | {
            "first_loss": losses[0], "last_loss": losses[-1], "optimizer_steps": steps,
            "vq_launches_expected": want_vq},
        "evaluate": evaluated, "card_vs_cpu_step": {"f32": f32, "bf16": bf16},
        "steps_per_s_ema_restarts": steps_per_s, "timed_steps": RVQ_TIMED_STEPS,
    }


# ---------------------------------------------------------------------------
# Phase 7: the prior
# ---------------------------------------------------------------------------


EPOCH_RE = re.compile(r"^prior epoch (\d+): nll/code (\S+)", re.M)


def read_launches(vq_kernel, fused_adam, fa) -> dict:
    return {"vq_nearest": vq_kernel.launch_count(), "fused_adam": fused_adam.launch_count(),
            **fa.launch_counts()}


def run_cli_prior(cli_prior, counters, argv) -> dict:
    """One ``cli.prior`` run with every launch count set to 0 just before
    it and read just after; its output is kept and its epoch NLLs parsed."""
    for k in counters:
        k.reset_launch_count()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_prior.main(argv)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    return {"seconds": seconds, "launches": read_launches(*counters),
            "epoch_nll": [float(v) for _, v in EPOCH_RE.findall(text)]}


def prior_phase(torch, cli_prior, serve, checkpoint, counters, root: str, vq_ckpt: str,
                corpus: str) -> dict:
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.data.pipeline import get_audio_data_loaders
    from neural_sound_generation_tpu_torch.models.transformer_prior import incremental_logits
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    ckpt = os.path.join(root, "prior", "models")
    widths = ["--arch", "transformer", "--prior-dim", str(PRIOR_DIM),
              "--prior-layers", str(PRIOR_LAYERS), "--dim", str(TRAIN_DIM),
              "--z-dim", str(TRAIN_CODES), "--device", DEVICE]
    train = ["train", "--datadir", corpus, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir", ckpt,
             "--batch-size", str(PRIOR_BATCH),
             "--max-batches-per-epoch", str(PRIOR_BATCHES_PER_EPOCH), *widths]
    runs = {"train": run_cli_prior(cli_prior, counters, train + ["--epochs", str(PRIOR_EPOCHS)])}
    before_resume = checkpoint.latest_step(ckpt)
    runs["resume"] = run_cli_prior(cli_prior, counters,
                                   train + ["--epochs", str(PRIOR_EPOCHS + 1), "--resume"])
    for tag, epochs in (("train", PRIOR_EPOCHS), ("resume", 1)):
        r = runs[tag]
        steps = epochs * PRIOR_BATCHES_PER_EPOCH
        want = {"vq_nearest": steps, "fused_adam": steps,
                **{k: PRIOR_LAYERS * steps for k in ("flash_fwd", "flash_bwd_dq",
                                                     "flash_bwd_dkdv")}}
        r["optimizer_steps"] = steps
        check(r["launches"] == want, f"prior {tag}: launches {r['launches']}, expected {want}")
        check(len(r["epoch_nll"]) == epochs and all(np.isfinite(r["epoch_nll"])),
              f"prior {tag}: epoch NLLs {r['epoch_nll']}")
    nll = runs["train"]["epoch_nll"]
    check(nll[-1] < nll[0], f"prior: the NLL did not fall ({nll})")
    after = checkpoint.latest_step(ckpt)
    want_steps = (PRIOR_EPOCHS * PRIOR_BATCHES_PER_EPOCH, (PRIOR_EPOCHS + 1) * PRIOR_BATCHES_PER_EPOCH)
    check((before_resume, after) == want_steps,
          f"prior checkpoints at steps {(before_resume, after)}, expected {want_steps}")
    spec = cli_prior.PriorSpec("transformer", TRAIN_CODES, PRIOR_DIM, PRIOR_LAYERS, PRIOR_HEADS, 10)
    extra = checkpoint.read_extra(ckpt)
    check(extra == {"epoch": PRIOR_EPOCHS + 1, **spec.metadata()},
          f"prior checkpoint metadata {extra}")

    # one batch of code grids from the trained VQ-VAE (the nearest-code kernel)
    args = cli_prior.parse_args(train + ["--epochs", "1"])
    cfg = Config()
    loader = get_audio_data_loaders(corpus, None, PRIOR_BATCH, cfg, latent_stride=4)["train"]
    vqvae = cli_prior.load_vqvae(args, cfg, DEVICE)
    with torch.no_grad():
        codes = vqvae.encode(torch.from_numpy(next(iter(loader))["x"]).to(DEVICE))
    labels = torch.zeros(codes.shape[0], dtype=torch.int32, device=DEVICE)
    del vqvae

    # one train step on the card against the same step on the CPU, from the
    # resumed run's full state (warm moments) on the same codes
    pcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, initial_learning_rate=3e-4, batch_size=PRIOR_BATCH))
    states, metrics = {}, {}
    for device in (DEVICE, "cpu"):
        model = spec.build().to(device)
        state = create_train_state(model, pcfg.train)
        checkpoint.restore(ckpt + "_train", state)
        _, m = make_train_step(model, pcfg)(
            state, {"codes": codes.to(device), "labels": labels.to(device)})
        states[device], metrics[device] = state, {k: float(v) for k, v in m.items()}
    rel = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
           for k in metrics["cpu"]}
    diff = (states[DEVICE].flat.flat.cpu() - states["cpu"].flat.flat).abs()
    compare = {"metrics_rel_err": rel, "params_max_abs_err": float(diff.max()),
               "params_beyond_1e-6_frac": float((diff > 1e-6).float().mean()),
               "grad_norm": metrics[DEVICE]["grad_norm"]}
    emit({"phase": "prior_card_vs_cpu_step", **compare})
    # TF32 is off: only the order of f32 sums differs (LayerNorm, matrix
    # products, the kernels' online softmax). The NLL within 1e-5 relative,
    # grad_norm within 1e-4; each parameter moves by about lr = 3e-4 per
    # step, so the updated parameters agree to a small part of that
    check(rel["loss"] <= 1e-5, f"prior card vs CPU: NLL differs by {rel['loss']:.3g}")
    check(rel["grad_norm"] <= 1e-4,
          f"prior card vs CPU: grad_norm differs by {rel['grad_norm']:.3g}")
    check(float(diff.max()) <= 1e-4, f"prior card vs CPU: parameters differ by {float(diff.max())}")

    # train steps/s with a device-resident batch
    state = states[DEVICE]
    step = make_train_step(state.model, pcfg)
    batch = {"codes": codes, "labels": labels}
    for _ in range(5):
        step(state, batch)
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(PRIOR_TIMED_STEPS):
        step(state, batch)
    sync()
    step_s = (time.perf_counter() - t0) / PRIOR_TIMED_STEPS
    del states, state, step

    # the KV-cached decode against the kernel's forward, on the trained prior
    prior = cli_prior.load_prior(ckpt, spec, DEVICE)
    with torch.no_grad():
        forward = prior(codes[:4], labels[:4])
    cached = incremental_logits(prior, codes[:4], labels[:4])
    inc_err = float((cached - forward).abs().max())
    check(inc_err <= 1e-4, f"incremental_logits differ from the forward by {inc_err}")

    sampled = sample_cli(cli_prior, vq_ckpt, ckpt, widths, root)
    served = serve_samples(torch, serve, vq_ckpt, ckpt, counters)
    return {
        "phase": "prior", "prior_dim": PRIOR_DIM, "prior_layers": PRIOR_LAYERS,
        "prior_heads": PRIOR_HEADS, "codes": TRAIN_CODES, "batch": PRIOR_BATCH,
        "code_grid": list(codes.shape[1:]),
        "parameters": sum(p.numel() for p in prior.parameters()),
        "runs": runs, "checkpoint_steps": {"before_resume": before_resume, "after_resume": after},
        "card_vs_cpu_step": compare, "train_step_ms": 1e3 * step_s,
        "train_steps_per_s": 1.0 / step_s, "timed_steps": PRIOR_TIMED_STEPS,
        "incremental_vs_forward_max_abs_err": inc_err, "sample_cli": sampled,
        "serve_sample": served,
    }


def sample_cli(cli_prior, vq_ckpt: str, ckpt: str, widths: list, root: str) -> dict:
    """``cli.prior sample`` from the EMA artifact at the default 20 x 28
    grid writes finite WAVs of the decoded length."""
    out = os.path.join(root, "prior", "samples")
    n, (h, w) = 4, (20, 28)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_prior.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpt + "_ema",
                        "--output-dir", out, "--num-samples", str(n), *widths])
    seconds = time.perf_counter() - t0
    names = sorted(os.listdir(out))
    check(names == [f"prior_sample_{i:03d}.wav" for i in range(n)], f"sample wrote {names}")
    sr, hop = 22050, 256
    for name in names:
        with open(os.path.join(out, name), "rb") as f:
            wav = read_wav(f.read(), sr)
        check(len(wav) == hop * (4 * w - 1), f"{name}: {len(wav)} samples")
    return {"num_samples": n, "code_grid": [h, w], "seconds": seconds}


def serve_samples(torch, serve, vq_ckpt: str, ckpt: str, counters) -> dict:
    """``serve --prior-ckpt`` answers /sample at n = 1 and n = 4 with
    finite audio of the decoded length; p50 over SAMPLE_REPEATS requests
    after a warm-up."""
    service = serve.build_service(serve.parse_args([
        "--device", DEVICE, "--ckpt-dir", vq_ckpt, "--dim", str(TRAIN_DIM),
        "--z-dim", str(TRAIN_CODES), "--prior-ckpt", ckpt, "--prior-arch", "transformer",
        "--prior-dim", str(PRIOR_DIM), "--prior-layers", str(PRIOR_LAYERS),
        "--prior-heads", str(PRIOR_HEADS)]))
    sr, hop, frames = service.cfg.audio.sample_rate, service.cfg.audio.effective_hop_size, 84
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
    lat: dict = {}
    for k in counters:
        k.reset_launch_count()
    try:
        for n in (1, 4):
            for i in range(1 + SAMPLE_REPEATS):
                status, body, dt = request(url, json.dumps({"n": n, "label": 1, "seed": i}).encode())
                check(status == 200, f"/sample n={n}: {status} {body[:200]!r}")
                wav = read_wav(body, sr)
                check(len(wav) == n * hop * (frames - 1), f"/sample n={n}: {len(wav)} samples")
                if i:
                    lat.setdefault(n, []).append(1e3 * dt)
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = read_launches(*counters)
    from neural_sound_generation_tpu_torch.ops import dsp

    with torch.inference_mode():
        mels, gen = service._sample_mels({"n": 4, "label": 1, "seed": 0})
        wav = dsp.inv_mel_spectrogram_batch(mels, service.cfg.audio, gen)
    check(bool(torch.isfinite(wav).all()), "non-finite /sample waveform")
    return {"code_grid": [service.cfg.audio.num_mels // 4, frames // 4],
            "launches_over_requests": launches,
            "latency_ms": {f"n={n}": {"n": len(v), "p50": float(np.percentile(v, 50)),
                                      "max": float(max(v))} for n, v in lat.items()}}


def serve_trained(torch, serve, ckpt: str) -> dict:
    """The server with --ckpt-dir <trained checkpoint> --ema answers one
    /reconstruct of 1 s with finite audio of the input's length."""
    service = serve.build_service(serve.parse_args([
        "--device", DEVICE, "--ckpt-dir", ckpt, "--ema",
        "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES)]))
    sr = service.cfg.audio.sample_rate
    wav_bytes, n = chirp_wav_bytes(1.0, sr)
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status, body, dt = request(f"http://127.0.0.1:{httpd.server_address[1]}/reconstruct",
                                   wav_bytes)
    finally:
        httpd.shutdown()
        httpd.server_close()
    check(status == 200, f"/reconstruct from the checkpoint: {status} {body[:200]!r}")
    check(len(read_wav(body, sr)) == n, "/reconstruct from the checkpoint: wrong length")
    with torch.inference_mode():
        padded, _ = service._pad_for_reconstruct(wav_bytes)
        wav = service._reconstruct_wav(torch.from_numpy(padded).to(DEVICE)[None])
    check(bool(torch.isfinite(wav).all()), "non-finite /reconstruct from the checkpoint")
    return {"status": status, "samples": n, "ms": 1e3 * dt}


# ---------------------------------------------------------------------------
# Phase 8: the vocoder
# ---------------------------------------------------------------------------


def seeded_wavenet(torch, wn, cfg: dict, device: str | None = None):
    return wn.WaveNet(**cfg, generator=torch.Generator().manual_seed(SEED)).to(
        device or DEVICE).eval()


def wavenet_bound_ms(packed, t: int, teacher: bool) -> dict:
    """Least time of one call over t steps: the packed weights, the bf16
    conditioning rows and the noise (or the given inputs) read once and the
    samples (or logits) written once over the HBM rate, against the step's
    multiply-adds (2 operations each, bf16 operands) over the bf16 rate.
    Also the time to read the weights once from HBM: what a design that
    streamed them every step would pay per step."""
    d = packed.dims
    L, K, R, G, S, C, out = d["L"], d["K"], d["R"], d["G"], d["S"], d["C"], d["OUT"]
    macs = C * L * G + L * (K * R * G + G // 2 * (S + R)) + S * S + S * out
    per_step_io = 2 * C + (4 + 4 * out if teacher else 4 * (d["n_mix"] + 1) + 4)
    bytes_ms = 1e3 * (packed.nbytes() + t * per_step_io) / PEAK_HBM_BYTES
    ops_ms = 1e3 * 2 * macs * t / PEAK_BF16_FLOPS
    bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return {"bound_ms": bound[0], "bound_by": bound[1], "flop_per_step": 2 * macs,
            "weight_bytes": packed.nbytes(),
            "weights_from_hbm_us": 1e6 * packed.nbytes() / PEAK_HBM_BYTES}


def sample_consistency(torch, wn, plain, gum, unif, samples) -> dict:
    """The plain teacher's logits on the kernel's own trajectory, sampled
    with the kernel's noise, against the kernel's samples: the share of
    steps within WN_SAMPLE_TOL, and the mismatches off a near-tie (a
    Gumbel-max gap under WN_SAMPLE_TOL)."""
    n_mix = gum.shape[-1]
    again = wn.sample_mol(plain, gum, unif)
    top2 = torch.topk(plain[:, :n_mix] + gum, 2).values
    near_tie = (top2[:, 0] - top2[:, 1]) < WN_SAMPLE_TOL
    off = (again - samples).abs() > WN_SAMPLE_TOL
    return {"sample_max_abs_err": float((again - samples).abs().max()),
            "sample_agree_frac": 1.0 - float(off.float().mean()),
            "sample_mismatches": int(off.sum()),
            "sample_mismatches_not_near_tie": int((off & ~near_tie).sum()),
            "samples_clipped_frac": float((samples.abs() >= 1.0).float().mean()),
            "samples_finite": bool(torch.isfinite(samples).all())}


def check_samples(row: dict, what: str) -> None:
    check(row["samples_finite"] and row["sample_agree_frac"] >= WN_AGREE
          and row["sample_mismatches_not_near_tie"] == 0,
          f"{what}: the plain teacher reproduces {row['sample_agree_frac']:.4%} of the "
          f"kernel's samples, {row['sample_mismatches_not_near_tie']} mismatches off a "
          f"near-tie")


def compare_wavenet(torch, wn, wavenet_gen, shape, gen) -> dict:
    """Both variants of kernel 5 at one configuration and length: the
    kernel samples t steps, twice on the same noise (bit-identical); its
    trajectory, shifted, goes through the teacher kernel (twice), the plain
    teacher and the float32 incremental_forward; the plain teacher's
    logits, sampled with the kernel's noise, must give back the kernel's
    samples. Then both variants' launch plans, their times back to back and
    device-only (behind torch.cuda._sleep), the plain teacher's over the
    same steps and the plain sampler's over WN_PLAIN_STEPS steps."""
    import torch.nn.functional as F

    name, cfg, t = shape
    model = seeded_wavenet(torch, wn, cfg)
    hop = int(np.prod(cfg["upsample_scales"]))
    c = torch.randn(1, -(-t // hop), cfg["cin_channels"], generator=gen, device=DEVICE)
    with torch.no_grad():
        c_up = wn._upsample_cond(model, c)[0]
    packed = wavenet_gen.pack_weights(model)
    gum, unif = (a[:, 0] for a in wn.draw_noise(model, gen, t, 1))
    samples = wavenet_gen.wavenet_generate(packed, c_up, gum, unif, t)
    again = wavenet_gen.wavenet_generate(packed, c_up, gum, unif, t)
    x_in = F.pad(samples[:-1], (1, 0))
    logits = wavenet_gen.wavenet_teacher_logits(packed, c_up, x_in)
    logits_again = wavenet_gen.wavenet_teacher_logits(packed, c_up, x_in)
    plain = wavenet_gen.wavenet_teacher_logits_plain(packed, c_up, x_in)
    f32 = wn.incremental_forward(model, x_in[None, :, None], c)[0]
    sync(torch)
    f32_gap = float((logits - f32).abs().max())
    iters = 3 if t > 1000 else 10
    kernel_ms = time_ms(torch, lambda: wavenet_gen.wavenet_generate(packed, c_up, gum, unif, t),
                        iters, warmup=1)
    teacher_ms = time_ms(torch, lambda: wavenet_gen.wavenet_teacher_logits(packed, c_up, x_in),
                         iters, warmup=1)
    device_ms = {
        "wavenet_gen_sample": device_time_ms(
            torch, lambda: wavenet_gen.wavenet_generate(packed, c_up, gum, unif, t), iters)[0],
        "wavenet_gen_teacher": device_time_ms(
            torch, lambda: wavenet_gen.wavenet_teacher_logits(packed, c_up, x_in), iters)[0]}
    plain_teacher_ms = time_ms(
        torch, lambda: wavenet_gen.wavenet_teacher_logits_plain(packed, c_up, x_in), 2, warmup=1)
    n = min(t, WN_PLAIN_STEPS)
    plain_sample_ms = time_ms(
        torch, lambda: wavenet_gen.wavenet_generate_plain(packed, c_up, gum, unif, n), 1,
        warmup=0)
    return {
        "phase": "kernel", "name": "wavenet_gen", "shape_name": name, "t": t,
        "layers": cfg["layers"], "residual": cfg["residual_channels"],
        "gate": cfg["gate_channels"], "skip": cfg["skip_out_channels"],
        "cin": cfg["cin_channels"], "out": cfg["out_channels"],
        "teacher_max_abs_err": float((logits - plain).abs().max()),
        "teacher_mismatched": int((logits != plain).sum()),
        "kernel_vs_f32_incremental_max_abs_err": f32_gap,
        "plain_vs_f32_incremental_max_abs_err": float((plain - f32).abs().max()),
        "f32_control_fails_teacher_limit": f32_gap > WN_TEACHER_TOL,
        **sample_consistency(torch, wn, plain, gum, unif, samples),
        "run_to_run_identical": bool(torch.equal(samples, again))
        and bool(torch.equal(logits, logits_again)),
        "plan": {name: wavenet_gen.launch_plan(packed, name) for name in wavenet_gen.KERNELS},
        "ms": {"wavenet_gen_sample": kernel_ms, "wavenet_gen_teacher": teacher_ms},
        "device_ms": device_ms,
        "us_per_step": {"wavenet_gen_sample": 1e3 * kernel_ms / t,
                        "wavenet_gen_teacher": 1e3 * teacher_ms / t},
        "device_us_per_step": {k: 1e3 * v / t for k, v in device_ms.items()},
        "plain_ms": {"wavenet_gen_sample_per_step": plain_sample_ms / n,
                     "plain_sample_steps_timed": n,
                     "wavenet_gen_teacher": plain_teacher_ms},
        "bound": {"wavenet_gen_sample": wavenet_bound_ms(packed, t, False),
                  "wavenet_gen_teacher": wavenet_bound_ms(packed, t, True)},
    }


def check_plan(plan: dict, what: str) -> None:
    """Kernel 5's launch: no spills, and its cluster can run."""
    check(plan["spill_bytes"] == 0 and plan["max_active_clusters"] >= 1,
          f"{what}: {plan['spill_bytes']} bytes spilled per thread, "
          f"{plan['max_active_clusters']} active clusters of {plan['cluster']} CTAs")


def check_wavenet_row(row: dict) -> None:
    """compare_wavenet's limits: teacher logits within WN_TEACHER_TOL of the
    plain teacher, the samples reproduced, both variants bit-identical run
    to run, their launch plans without spills and with an active cluster."""
    name = row["shape_name"]
    check(row["teacher_max_abs_err"] <= WN_TEACHER_TOL,
          f"wavenet_gen {name}: teacher logits differ by "
          f"{row['teacher_max_abs_err']} from the plain version")
    check_samples(row, f"wavenet_gen {name}")
    check(row["run_to_run_identical"], f"wavenet_gen {name}: two launches differ")
    for kernel, plan in row["plan"].items():
        check_plan(plan, f"{kernel} {name}")


def wavenet_api_path(torch, wn, wavenet_gen, gen) -> dict:
    """The kernel's main path: ``make_generate_fn(model, 22050,
    use_kernel=True)`` at the production configuration generates one
    second, WN_API_CALLS times with noise drawn from seeds 0, 1 and passed
    in, with the launch counts set to 0 just before and read just after.
    Then each call's samples are held against the plain teacher run on
    that trajectory and sampled with the same noise (the check of
    compare_wavenet at the main path's length), and the kernel alone is
    timed over the same length."""
    import torch.nn.functional as F

    model = seeded_wavenet(torch, wn, WN_PROD)
    frames = -(-WN_API_SAMPLES // 256)
    c = torch.randn(1, frames, WN_PROD["cin_channels"], generator=gen, device=DEVICE)
    generate = wn.make_generate_fn(model, WN_API_SAMPLES, use_kernel=True)
    noises = [wn.draw_noise(model, torch.Generator(device=DEVICE).manual_seed(i),
                            WN_API_SAMPLES, 1) for i in range(WN_API_CALLS)]
    wavenet_gen.reset_launch_count()
    seconds, outs = [], []
    for noise in noises:
        sync(torch)
        t0 = time.perf_counter()
        out = generate(c, noise=noise)
        sync(torch)
        seconds.append(time.perf_counter() - t0)
        outs.append(out)
    launches = wavenet_gen.launch_counts()
    check(launches == {"wavenet_gen_sample": WN_API_CALLS, "wavenet_gen_teacher": 0},
          f"make_generate_fn(use_kernel=True): launches {launches}, expected "
          f"{WN_API_CALLS} of the sampling variant")
    for out in outs:
        check(tuple(out.shape) == (1, WN_API_SAMPLES) and bool(torch.isfinite(out).all())
              and float(out.abs().max()) <= 1.0, f"use_kernel samples {tuple(out.shape)}")
    check(not torch.equal(outs[0], outs[1]), "two seeds gave the same samples")
    with torch.no_grad():
        c_up = wn._upsample_cond(model, c)[0]
    packed = wavenet_gen.pack_weights(model)
    consistency = []
    for out, (gum, unif) in zip(outs, noises):
        x_in = F.pad(out[0, :-1], (1, 0))
        plain = wavenet_gen.wavenet_teacher_logits_plain(packed, c_up, x_in)
        row = sample_consistency(torch, wn, plain, gum[:, 0], unif[:, 0], out[0])
        check_samples(row, f"make_generate_fn(use_kernel=True) at T = {WN_API_SAMPLES}")
        consistency.append(row)
        del plain
    gum, unif = (a[:, 0] for a in noises[0])
    again = wavenet_gen.wavenet_generate(packed, c_up, gum, unif, WN_API_SAMPLES)
    check(torch.equal(again, outs[0][0]),
          f"two launches on the same noise differ at T = {WN_API_SAMPLES}")
    kernel_ms = time_ms(torch, lambda: wavenet_gen.wavenet_generate(
        packed, c_up, gum, unif, WN_API_SAMPLES), 1, warmup=0)
    device_ms = device_time_ms(torch, lambda: wavenet_gen.wavenet_generate(
        packed, c_up, gum, unif, WN_API_SAMPLES), 2)[0]
    api_plan = wavenet_gen.launch_plan(packed)
    check_plan(api_plan, f"wavenet_gen_sample at T = {WN_API_SAMPLES}")
    audio_s = WN_API_SAMPLES / 22050
    return {"phase": "vocoder_api_path", "samples": WN_API_SAMPLES, "calls": WN_API_CALLS,
            "launches": launches, "seconds": seconds,
            "realtime_factor": audio_s / seconds[-1],
            "us_per_sample": 1e6 * seconds[-1] / WN_API_SAMPLES,
            "vs_plain_teacher": consistency,
            "sample_max_abs_err": max(r["sample_max_abs_err"] for r in consistency),
            "kernel_ms": kernel_ms, "kernel_us_per_step": 1e3 * kernel_ms / WN_API_SAMPLES,
            "kernel_device_ms": device_ms,
            "kernel_device_us_per_step": 1e3 * device_ms / WN_API_SAMPLES,
            "kernel_realtime_factor": 1e3 * audio_s / device_ms,
            "run_to_run_identical": True,
            "plan": api_plan,
            "bound": wavenet_bound_ms(packed, WN_API_SAMPLES, False)}


def stream_request(url: str, data: bytes) -> tuple[int, bytes, float, float]:
    """POST to a streaming endpoint: (status, body, seconds until the
    response headers, which the server sends with its first piece, seconds
    until the whole body)."""
    import http.client
    import urllib.parse

    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.hostname, parts.port, timeout=600)
    t0 = time.perf_counter()
    try:
        conn.request("POST", parts.path, body=data)
        resp = conn.getresponse()
        ttfb = time.perf_counter() - t0
        body = resp.read()
        return resp.status, body, ttfb, time.perf_counter() - t0
    finally:
        conn.close()


def read_pcm(body: bytes, n: int, what: str) -> np.ndarray:
    """s16le PCM of n samples. The server clips to [-1, 1] and scales by
    32767, so -32768 only comes from a NaN cast: it marks non-finite audio."""
    pcm = np.frombuffer(body, "<i2")
    check(len(pcm) == n, f"{what}: {len(pcm)} samples, expected {n}")
    check(int(pcm.min()) >= -32767 and int(np.abs(pcm.astype(np.int32)).max()) > 0,
          f"{what}: non-finite or silent audio")
    return pcm


def vocoder_fullwidth(torch, serve, cli_vocoder, checkpoint, wavenet_gen, dsp, root: str,
                      vq_ckpt: str, prior_ckpt: str) -> dict:
    """The CLI's default vocoder at full width from a seeded-init artifact:
    ``cli.vocoder synthesize``, then ``cli.serve --vocoder wavenet`` with the
    training phase's VQ-VAE and the prior phase's checkpoint answering
    /reconstruct_stream, /decode and /sample_stream, then with
    --stream-slots 2 two concurrent /reconstruct_stream. The kernel's count
    is read over each: this path runs the scan sampler, as the JAX
    package's does, so it launches the kernel no time."""
    import types

    from neural_sound_generation_tpu_torch.config import Config

    cfg = Config()
    sr, hop = cfg.audio.sample_rate, cfg.audio.effective_hop_size
    model = cli_vocoder.build_model(
        cfg, types.SimpleNamespace(residual_channels=None, layers=None, stacks=None),
        generator=torch.Generator().manual_seed(SEED))
    widths = {"layers": model.layers, "stacks": model.stacks,
              "residual": model.residual_channels, "gate": model.gate_channels,
              "skip": model.skip_out_channels, "cin": model.cin_channels,
              "out": model.out_channels,
              "parameters": sum(p.numel() for p in model.parameters()),
              "kernel_supported": wavenet_gen.generate_supported(model, 1)}
    check(widths["residual"] == 512 and not widths["kernel_supported"],
          f"the CLI's default vocoder: {widths}")
    work = os.path.join(root, "vocoder")
    ckpt = os.path.join(work, "models")
    checkpoint.save_params(ckpt, model, 0, cli_vocoder.condition_meta())
    check(checkpoint.read_extra(ckpt) == {"condition": "mel"}, "vocoder artifact metadata")
    del model

    # cli.vocoder synthesize over the first frames of a chirp's mel
    wav_bytes, n = chirp_wav_bytes(WN_CHIRP_SECONDS[0], sr)
    mel = dsp.melspectrogram(torch.from_numpy(dsp.load_wav_bytes(wav_bytes, sr)), cfg.audio)
    mel_path, out_path = os.path.join(work, "mel.npy"), os.path.join(work, "out.wav")
    np.save(mel_path, mel.T.numpy())
    wavenet_gen.reset_launch_count()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_vocoder.main(["synthesize", "--ckpt-dir", ckpt, "--mel-npy", mel_path, "--output",
                          out_path, "--max-frames", str(WN_SYNTH_FRAMES), "--device", DEVICE])
    synth_s = time.perf_counter() - t0
    with open(out_path, "rb") as f:
        synth_wav = read_wav(f.read(), sr)
    check(len(synth_wav) == WN_SYNTH_FRAMES * hop, f"synthesize: {len(synth_wav)} samples")
    synth = {"frames": WN_SYNTH_FRAMES, "samples": len(synth_wav), "seconds": synth_s,
             "ms_per_sample": 1e3 * synth_s / len(synth_wav),
             "kernel_launches": wavenet_gen.launch_counts()}

    base = ["--device", DEVICE, "--ckpt-dir", vq_ckpt, "--dim", str(TRAIN_DIM), "--z-dim",
            str(TRAIN_CODES), "--frames", str(WN_SERVE_FRAMES), "--vocoder", "wavenet",
            "--vocoder-ckpt", ckpt]
    prior = ["--prior-ckpt", prior_ckpt, "--prior-arch", "transformer", "--prior-dim",
             str(PRIOR_DIM), "--prior-layers", str(PRIOR_LAYERS), "--prior-heads",
             str(PRIOR_HEADS)]
    t_frames = dsp.num_stft_frames(n, cfg.audio.fft_size, hop)

    def serving(argv, run):
        service = serve.build_service(serve.parse_args(argv))
        httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        wavenet_gen.reset_launch_count()
        try:
            out = run(url)
            status, body, _ = request(url + "/metrics")
            check(status == 200, f"/metrics: {status}")
            metrics = json.loads(body)
        finally:
            httpd.shutdown()
            httpd.server_close()
        check(all(e["errors"] == 0 for e in metrics["endpoints"].values()),
              f"endpoint errors: {metrics['endpoints']}")
        out["kernel_launches"] = wavenet_gen.launch_counts()
        out["metrics"] = metrics
        return out

    def solo(url):
        out = {}
        status, body, ttfb, total = stream_request(url + "/reconstruct_stream", wav_bytes)
        check(status == 200, f"/reconstruct_stream: {status} {body[:200]!r}")
        read_pcm(body, t_frames * hop, "/reconstruct_stream")
        out["/reconstruct_stream"] = {"seconds_audio": WN_CHIRP_SECONDS[0],
                                      "samples": t_frames * hop, "ttfb_s": ttfb,
                                      "total_s": total}
        status, body, _ = request(url + "/encode", wav_bytes)
        check(status == 200, f"/encode: {status}")
        codes = json.loads(body)["codes"]
        status, body, dt = request(url + "/decode", json.dumps({"codes": codes}).encode())
        check(status == 200, f"/decode: {status} {body[:200]!r}")
        want = 4 * len(codes[0]) * hop
        check(len(read_wav(body, sr)) == want, f"/decode: expected {want} samples")
        out["/decode"] = {"samples": want, "total_s": dt}
        status, body, ttfb, total = stream_request(
            url + "/sample_stream", json.dumps({"n": 1, "label": 1, "seed": 0}).encode())
        check(status == 200, f"/sample_stream: {status} {body[:200]!r}")
        read_pcm(body, WN_SERVE_FRAMES * hop, "/sample_stream")
        out["/sample_stream"] = {"n": 1, "samples": WN_SERVE_FRAMES * hop, "ttfb_s": ttfb,
                                 "total_s": total}
        return out

    def muxed(url):
        chirps = [chirp_wav_bytes(s, sr) for s in WN_CHIRP_SECONDS]
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futures = [pool.submit(stream_request, url + "/reconstruct_stream", wb)
                       for wb, _ in chirps]
            results = [f.result() for f in futures]
        out = {}
        for (status, body, ttfb, total), (_, n_i), s in zip(results, chirps, WN_CHIRP_SECONDS):
            check(status == 200, f"muxed /reconstruct_stream: {status} {body[:200]!r}")
            want = dsp.num_stft_frames(n_i, cfg.audio.fft_size, hop) * hop
            read_pcm(body, want, f"muxed /reconstruct_stream {s}s")
            out[f"{s:g}s"] = {"samples": want, "ttfb_s": ttfb, "total_s": total}
        return {"/reconstruct_stream x2": out}

    t0 = time.perf_counter()
    served = serving(base + prior, solo)
    muxed_run = serving(base + ["--stream-slots", "2"], muxed)
    mux_block = muxed_run["metrics"].get("stream_mux")
    check(mux_block is not None and mux_block["slots"] == 2 and mux_block["active"] == 0,
          f"/metrics stream_mux: {mux_block}")
    return {"phase": "vocoder_fullwidth", "model": widths, "synthesize": synth,
            "serve": {k: v for k, v in served.items() if k != "metrics"},
            "serve_mux": {k: v for k, v in muxed_run.items() if k != "metrics"},
            "stream_mux_metrics": mux_block, "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 10: corpus preprocessing, units through kernel 1, mel inversion
# ---------------------------------------------------------------------------


def prep_wav(rng, seconds: float, sr: int) -> np.ndarray:
    """A chirp with a little noise between 0.1-0.3 s of near-silence
    (about one int16 step of noise) at each end."""
    n = int(sr * seconds)
    lead, tail = (int(sr * rng.uniform(0.1, 0.3)) for _ in range(2))
    m = n - lead - tail
    t = np.arange(m) / sr
    f = rng.uniform(80, 300) + rng.uniform(300, 3000) * t / t[-1]
    voiced = rng.uniform(0.2, 0.7) * np.sin(2 * np.pi * np.cumsum(f) / sr)
    voiced += 0.01 * rng.standard_normal(m)
    wav = np.concatenate([np.zeros(lead), voiced, np.zeros(tail)])
    wav += 3e-5 * rng.standard_normal(n)
    return np.clip(wav * 32767, -32768, 32767).astype(np.int16)


def write_prep_corpora(root: str) -> tuple[str, str]:
    """(LJSpeech-layout corpus, cmu_arctic-layout corpus) of int16 WAVs."""
    from scipy.io import wavfile

    rng = np.random.default_rng(SEED)
    lj = os.path.join(root, "ljspeech_in")
    os.makedirs(os.path.join(lj, "wavs"))
    lines = []
    for i in range(PREP_UTTERANCES):
        name = f"LJ{i:03d}-0001"
        wavfile.write(os.path.join(lj, "wavs", f"{name}.wav"), 22050,
                      prep_wav(rng, rng.uniform(*PREP_SECONDS), 22050))
        lines.append(f"{name}|Chirp number {i}.|Chirp number {i}.")
    with open(os.path.join(lj, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    cmu = os.path.join(root, "cmu_arctic_in")
    for spk in CMU_SPEAKERS:
        wav_dir = os.path.join(cmu, f"cmu_us_{spk}_arctic", "wav")
        os.makedirs(wav_dir)
        for i in range(CMU_PER_SPEAKER):
            wavfile.write(os.path.join(wav_dir, f"arctic_a{i + 1:04d}.wav"), 16000,
                          prep_wav(rng, rng.uniform(*CMU_SECONDS), 16000))
    return lj, cmu


FRAMES_PER_S_RE = re.compile(r"\((\d+) frames/sec\)")
MEL_FRAMES_RE = re.compile(r", (\d+) mel frames\)")


def run_preprocess(torch, cli_preprocess, engine, argv: list, device: str) -> tuple[dict, list]:
    """One ``cli.preprocess`` run on ``device``; every call of the batch
    transform is timed (CUDA events on the card) and its waveform batch and
    encoded batch kept. Returns (the run's record, the calls)."""
    calls = []
    real = engine._batch_transform

    def timed(wavs, prepped, cfg):
        if device == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            mels, outs = real(wavs, prepped, cfg)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            mels, outs = real(wavs, prepped, cfg)
            ms = 1e3 * (time.perf_counter() - t0)
        calls.append({"shape": list(prepped.shape), "ms": ms, "wavs": wavs.cpu().numpy(),
                      "prepped": prepped.cpu().numpy(), "mels": mels.cpu().numpy(),
                      "outs": outs.cpu().numpy()})
        return mels, outs

    engine._batch_transform = timed
    out = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            entries = cli_preprocess.main(argv + ["--device", device])
        seconds = time.perf_counter() - t0
    finally:
        engine._batch_transform = real
    text = out.getvalue()
    printed = FRAMES_PER_S_RE.search(text)
    check(printed is not None, f"cli.preprocess printed no frames/sec: {text[-300:]!r}")
    frames = int(MEL_FRAMES_RE.search(text).group(1))
    return {
        "device": device, "utterances": len(entries), "mel_frames": frames,
        "seconds": seconds, "frames_per_s": frames / seconds,
        "cli_frames_per_s": int(printed.group(1)),
        "cli_lines": [ln for ln in text.splitlines()
                      if ln.startswith(("Preprocessed ", "Wrote ", "Max/min"))],
        "transform_calls": len(calls),
        "transform_ms_by_bucket": [{"batch": c["shape"][0], "samples": c["shape"][1],
                                    "ms": c["ms"]} for c in calls],
        "transform_ms_total": sum(c["ms"] for c in calls),
    }, calls


def compare_encoded(card_calls: list, cpu_calls: list, q: int | None) -> dict:
    """The device batches' encodings card vs CPU on the same inputs: equal,
    or for mu-law integers one level apart where the exact value before the
    truncation lies within q * MULAW_BOUNDARY_REL of an integer."""
    check(len(card_calls) == len(cpu_calls),
          f"{len(card_calls)} batch transforms on the card, {len(cpu_calls)} on the CPU")
    flips, worst = 0, 0.0
    for a, b in zip(card_calls, cpu_calls):
        check(np.array_equal(a["wavs"], b["wavs"]), "the two runs batched other waveforms")
        differ = a["outs"] != b["outs"]
        if q is None:
            check(not differ.any(), "raw waveforms changed on the way through the card")
            continue
        x = a["wavs"][differ].astype(np.float64)
        exact = (np.sign(x) * np.log1p(q * np.abs(x)) / np.log1p(q) + 1) / 2 * q
        dist = np.abs(exact - np.round(exact))
        steps = np.abs(a["outs"][differ].astype(np.int64) - b["outs"][differ])
        check(bool(np.all(steps == 1)) and bool(np.all(dist <= q * MULAW_BOUNDARY_REL)),
              f"mu-law integers differ away from a truncation boundary: distances "
              f"{sorted(dist.tolist())[-5:]}, steps {sorted(set(steps.tolist()))}")
        flips += int(differ.sum())
        worst = max(worst, float(dist.max(initial=0.0)))
    return {"boundary_flips": flips, "flip_max_boundary_distance": worst,
            "boundary_limit": None if q is None else q * MULAW_BOUNDARY_REL}


def mel_reference(torch, dsp, prepped: np.ndarray, cfg) -> np.ndarray:
    """The batch transform's mels in float64 on the CPU from the same
    prepared block (B, L + extra): the framed STFT under the configuration's
    convention, with its float32 window, the mel product with the float32
    basis, dB and normalization. (B, n_frames, num_mels)."""
    from neural_sound_generation_tpu_torch.ops import lws

    hop = cfg.effective_hop_size
    if cfg.use_lws:
        window = lws._window(cfg.fft_size, hop, 0, "cpu")
    else:
        window = dsp._padded_window(cfg.effective_win_size, cfg.fft_size, "cpu")
    frames = dsp.frame_signal(torch.from_numpy(prepped).double(), cfg.fft_size, hop)
    D = torch.fft.rfft(frames * window.double(), dim=-1)
    M = D.abs() @ dsp._mels(cfg, "cpu")[0].double().T
    S = dsp.amp_to_db(M, cfg.min_level_db) - cfg.ref_level_db
    return (dsp.normalize_spectrogram(S, cfg) if cfg.signal_normalization else S).numpy()


def mel_errors(torch, dsp, mels: np.ndarray, ref: np.ndarray, cfg) -> dict:
    """A device's float32 mels against the float64 reference: the largest
    error in normalized units at bins PREP_ABOVE_FLOOR_DB or more above the
    floor (min_level_db) and at the rest, and in linear magnitude over the
    largest magnitude of the bin's frame, where the dB no longer magnifies
    the FFT's rounding at quiet bins."""
    def level_db(S):
        S = torch.from_numpy(S).double()
        return dsp.denormalize_spectrogram(S, cfg) if cfg.signal_normalization else S

    got, want = level_db(mels), level_db(ref)
    above = want >= cfg.min_level_db + PREP_ABOVE_FLOOR_DB
    err = np.abs(mels.astype(np.float64) - ref)
    lin_got = dsp.db_to_amp(got + cfg.ref_level_db)
    lin_want = dsp.db_to_amp(want + cfg.ref_level_db)
    lin = (lin_got - lin_want).abs() / lin_want.amax(dim=-1, keepdim=True)
    return {"above_floor": float(err[above.numpy()].max(initial=0.0)),
            "near_floor": float(err[~above.numpy()].max(initial=0.0)),
            "linear_over_frame_max": float(lin.max())}


def compare_mels(torch, dsp, card_calls: list, cpu_calls: list, cfg) -> dict:
    """Each batch's mels on the card and on the CPU against the float64
    reference from the same prepared block: above the floor within
    PREP_MEL_ABOVE_FLOOR_ATOL, in linear magnitude within PREP_MEL_LIN_REL
    of the frame's largest, near the floor within PREP_MEL_NEAR_FLOOR_ATOL;
    and card vs CPU."""
    worst = {w: {"above_floor": 0.0, "near_floor": 0.0, "linear_over_frame_max": 0.0}
             for w in ("card", "cpu")}
    card_vs_cpu = 0.0
    for a, b in zip(card_calls, cpu_calls):
        check(np.array_equal(a["prepped"], b["prepped"]),
              "the two runs transformed other prepared blocks")
        ref = mel_reference(torch, dsp, a["prepped"], cfg)
        for where, call in (("card", a), ("cpu", b)):
            for k, v in mel_errors(torch, dsp, call["mels"], ref, cfg).items():
                worst[where][k] = max(worst[where][k], v)
        card_vs_cpu = max(card_vs_cpu, float(np.abs(a["mels"] - b["mels"]).max()))
    for where, e in worst.items():
        check(e["above_floor"] <= PREP_MEL_ABOVE_FLOOR_ATOL
              and e["linear_over_frame_max"] <= PREP_MEL_LIN_REL
              and e["near_floor"] <= PREP_MEL_NEAR_FLOOR_ATOL,
              f"mels on the {where} against float64: {e}")
    return {"mel_err_vs_float64": worst, "mel_card_vs_cpu_batches": card_vs_cpu}


def compare_shards(card_dir: str, cpu_dir: str, flips: int, mel_batch_err: float) -> dict:
    """train.txt identical, float audio shards bit-equal, integer shards
    one level apart at no more samples than their batches flipped, mels
    card vs CPU no further apart than in the batches they came from."""
    with open(os.path.join(card_dir, "train.txt"), encoding="utf-8") as f:
        card_manifest = f.read()
    with open(os.path.join(cpu_dir, "train.txt"), encoding="utf-8") as f:
        cpu_manifest = f.read()
    check(card_manifest == cpu_manifest, "card and CPU train.txt differ")
    mel_err, shard_flips, shards = 0.0, 0, 0
    for line in card_manifest.splitlines():
        audio, mel = line.split("|")[:2]
        a = np.load(os.path.join(card_dir, audio))
        b = np.load(os.path.join(cpu_dir, audio))
        check(a.dtype == b.dtype and a.shape == b.shape, f"{audio}: {a.dtype}{a.shape} "
              f"on the card, {b.dtype}{b.shape} on the CPU")
        if np.issubdtype(a.dtype, np.integer):
            differ = a != b
            check(bool(np.all(np.abs(a[differ].astype(np.int64) - b[differ]) == 1)),
                  f"{audio}: mu-law integers more than one level apart")
            shard_flips += int(differ.sum())
        else:
            check(a.tobytes() == b.tobytes(), f"{audio}: card and CPU shards differ")
        m_card = np.load(os.path.join(card_dir, mel))
        m_cpu = np.load(os.path.join(cpu_dir, mel))
        check(m_card.shape == m_cpu.shape and bool(np.isfinite(m_card).all()),
              f"{mel}: {m_card.shape} vs {m_cpu.shape}")
        mel_err = max(mel_err, float(np.abs(m_card - m_cpu).max()))
        shards += 1
    check(mel_err <= mel_batch_err,
          f"card vs CPU mel shards differ by {mel_err}, their batches by {mel_batch_err}")
    check(shard_flips <= flips, f"{shard_flips} mu-law flips in the shards, {flips} in the batches")
    return {"shards": shards, "manifest_identical": True, "mel_max_abs_err": mel_err,
            "shard_boundary_flips": shard_flips}


def preprocess_both(torch, cli_preprocess, engine, dsp, name: str, in_dir: str, root: str,
                    flags: list, cfg) -> dict:
    """The corpus through ``cli.preprocess`` on the card and on the CPU,
    held against each other and their mels against float64; ``cfg`` the
    audio configuration the CLI runs under."""
    runs, calls = {}, {}
    for where, device in (("on_card", DEVICE), ("on_cpu", "cpu")):
        out_dir = os.path.join(root, f"{name}_{where}")
        runs[where], calls[where] = run_preprocess(
            torch, cli_preprocess, engine, [name, in_dir, out_dir, "--num_workers", "8", *flags],
            device)
    summaries = {w: [ln.split(" in ")[0] for ln in r["cli_lines"]] for w, r in runs.items()}
    check(summaries["on_card"] == summaries["on_cpu"] and len(summaries["on_cpu"]) == 3,
          f"{name}: the CLI's summaries differ {summaries}")
    encoded = compare_encoded(calls["on_card"], calls["on_cpu"],
                              cfg.quantize_channels if cfg.is_mulaw_quantize else None)
    mels = compare_mels(torch, dsp, calls["on_card"], calls["on_cpu"], cfg)
    shards = compare_shards(os.path.join(root, f"{name}_on_card"),
                            os.path.join(root, f"{name}_on_cpu"), encoded["boundary_flips"],
                            mels["mel_card_vs_cpu_batches"])
    return {"corpus": name, **runs, **encoded, **mels, **shards}


def spectral_convergence(torch, dsp, y, mel, cfg) -> float:
    """|| |STFT(y)| - S || / ||S|| on the CPU, S the magnitude that the
    phase reconstruction was given (the pseudo-inverse mel to the power),
    STFT(y) under the configuration's convention after the preemphasis that
    the inversion undid."""
    y, mel = y.cpu(), mel.cpu()
    D = dsp.denormalize_spectrogram(mel, cfg) if cfg.signal_normalization else mel
    _, inv_basis = dsp._mels(cfg, "cpu")
    S = torch.clamp(inv_basis @ dsp.db_to_amp(D + cfg.ref_level_db), min=1e-10) ** cfg.power
    A = torch.abs(dsp._analysis_stft(dsp.preemphasis(y, cfg.preemphasis, cfg.preemphasize),
                                     cfg))[: S.shape[1]]
    check(A.shape == S.T.shape, f"analysis {tuple(A.shape)} vs target {tuple(S.T.shape)}")
    return float(torch.linalg.norm(A - S.T) / torch.linalg.norm(S))


def invert_card_vs_cpu(torch, dsp, mels: list, cfg, what: str) -> dict:
    """Each (num_mels, T) mel inverted on the card and on the CPU (Griffin-Lim
    from the same injected phases, or LWS); spectral convergence of both and
    ms per utterance (the card's timed on a second call)."""
    rows = []
    for mel in mels:
        t = mel.shape[1]
        angles = 2 * np.pi * torch.rand(t, cfg.fft_size // 2 + 1,
                                        generator=torch.Generator().manual_seed(SEED))
        out, ms = {}, {}
        for where, device in (("card", DEVICE), ("cpu", "cpu")):
            m, a = mel.to(device), angles.to(device)
            with torch.inference_mode():
                out[where] = dsp.inv_mel_spectrogram(m, cfg, init_angles=a)
                if device == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    dsp.inv_mel_spectrogram(m, cfg, init_angles=a)
                    end.record()
                    torch.cuda.synchronize()
                    ms[where] = start.elapsed_time(end)
                else:
                    t0 = time.perf_counter()
                    dsp.inv_mel_spectrogram(m, cfg, init_angles=a)
                    ms[where] = 1e3 * (time.perf_counter() - t0)
        check(bool(torch.isfinite(out["card"]).all()), f"{what}: non-finite waveform")
        sc = {w: spectral_convergence(torch, dsp, y, mel, cfg) for w, y in out.items()}
        check(abs(sc["card"] - sc["cpu"]) <= INV_SC_ATOL,
              f"{what}: spectral convergence {sc['card']} on the card, {sc['cpu']} on the CPU")
        rows.append({"frames": t, "samples": int(out["card"].shape[-1]),
                     "spectral_convergence": sc, "ms": ms})
    return {"method": what, "rows": rows,
            "ms_per_utterance": {w: float(np.mean([r["ms"][w] for r in rows]))
                                 for w in ("card", "cpu")},
            "sc_max_abs_diff": max(abs(r["spectral_convergence"]["card"]
                                       - r["spectral_convergence"]["cpu"]) for r in rows)}


def units_phase(torch, serve, cli_invert, vq_kernel, VQVAE, prep_dir: str, root: str) -> dict:
    """extract_units over every 84-frame window of the preprocessed mels
    through the serving phase's seeded full-width VQ-VAE, one
    reconstruct_audio and one codes_to_audio call, with vq_nearest's launch
    count; card vs CPU codes on the first batch; ``cli.invert`` on one mel."""
    from neural_sound_generation_tpu_torch.data.manifest import read_manifest
    from neural_sound_generation_tpu_torch.inference import (
        codes_to_audio, extract_units, reconstruct_audio)

    service = serve.build_service(serve.parse_args(["--device", DEVICE]))
    model, cfg, win = service.model, service.cfg.audio, service.frames
    hop = cfg.effective_hop_size
    entries = read_manifest(prep_dir)
    windows = []
    for e in entries:
        mel = np.load(os.path.join(prep_dir, e.mel_path)).T
        windows += [mel[:, k * win:(k + 1) * win] for k in range(mel.shape[1] // win)]
    windows = np.stack(windows)[..., None]
    batches = [torch.from_numpy(windows[i:i + UNITS_BATCH]).to(DEVICE)
               for i in range(0, len(windows), UNITS_BATCH)]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    sync(torch)
    vq_kernel.reset_launch_count()
    t0 = time.perf_counter()
    codes = [extract_units(model, b) for b in batches]
    sync(torch)
    units_s = time.perf_counter() - t0
    rec_mel, rec_wav = reconstruct_audio(model, batches[0], cfg, gen)
    dec_wav = codes_to_audio(model, codes[0], cfg, gen)
    sync(torch)
    launches = vq_kernel.launch_count()
    want = len(batches) + 1  # every extract_units batch, and reconstruct_audio's
    check(launches == want, f"units: vq_nearest launched {launches} times, expected {want}")
    n0 = batches[0].shape[0]
    check(tuple(codes[0].shape) == (n0, cfg.num_mels // 4, win // 4), f"codes {codes[0].shape}")
    check(tuple(rec_mel.shape) == (n0, cfg.num_mels, win), f"reconstructed mel {rec_mel.shape}")
    for name, w in (("reconstruct_audio", rec_wav), ("codes_to_audio", dec_wav)):
        check(tuple(w.shape) == (n0, hop * (win - 1)), f"{name}: {tuple(w.shape)}")
        check(bool(torch.isfinite(w).all()) and float(w.abs().max()) > 0,
              f"{name}: waveform not finite or silent")

    # card vs CPU on the first batch: a code may differ only at a near-tie
    # (``near_ties``, the card's z_e against the CPU's)
    cpu_model = VQVAE(1, model.dim, model.z_dim)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_model.eval()
    x = batches[0].cpu()
    with torch.inference_mode():
        codes_cpu = extract_units(cpu_model, x).reshape(-1).long()
        z_cpu = cpu_model._encode_latents(x).reshape(-1, model.dim).double()
        z_card = model._encode_latents(batches[0]).reshape(-1, model.dim).double().cpu()
    codes_card = codes[0].cpu().reshape(-1).long()
    cb = cpu_model.codebook.detach().double()
    rows = torch.nonzero(codes_card != codes_cpu).flatten()
    explained = int(near_ties(z_cpu[rows], z_card[rows], cb[codes_card[rows]],
                              cb[codes_cpu[rows]]).sum())
    check(explained == rows.numel(),
          f"units: {rows.numel() - explained} of {rows.numel()} card vs CPU code mismatches "
          f"are not near-ties")

    # cli.invert on the first utterance's mel writes a WAV
    wav_path = os.path.join(root, "invert.wav")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_invert.main([prep_dir, str(cfg.sample_rate), str(cfg.fft_size), str(hop),
                         str(cfg.num_mels), "--mel-file", entries[0].mel_path,
                         "--output", wav_path, "--device", DEVICE])
    with open(wav_path, "rb") as f:
        inverted = read_wav(f.read(), cfg.sample_rate)
    frames0 = np.load(os.path.join(prep_dir, entries[0].mel_path)).shape[0]
    check(len(inverted) == hop * (frames0 - 1),
          f"cli.invert wrote {len(inverted)} samples for {frames0} frames")
    return {"windows": len(windows), "encode_batches": len(batches), "vq_launches": launches,
            "vq_launches_expected": want, "units_s": units_s,
            "units_windows_per_s": len(windows) / units_s,
            "card_vs_cpu_codes": {"compared": int(codes_cpu.numel()),
                                  "mismatches": int(rows.numel()), "near_ties": explained},
            "invert_cli_samples": len(inverted)}


def preprocess_phase(torch, serve, dsp, vq_kernel, VQVAE, root: str, card: str) -> dict:
    """Corpora written, preprocessed on the card and the CPU and held
    against each other; units and audio through kernel 1; mel inversion
    card vs CPU."""
    from neural_sound_generation_tpu_torch.cli import invert as cli_invert
    from neural_sound_generation_tpu_torch.cli import preprocess as cli_preprocess
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.data.corpora import engine
    from neural_sound_generation_tpu_torch.data.corpora.engine import convention
    from neural_sound_generation_tpu_torch.data.manifest import read_manifest

    t0 = time.perf_counter()
    root = os.path.join(root, "preprocess")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    lj_in, cmu_in = write_prep_corpora(root)
    preset = os.path.join(root, "cmu_arctic_8bit.json")
    with open(preset, "w", encoding="utf-8") as f:
        json.dump(CMU_PRESET, f)
    lj_cfg = Config().audio
    cmu_cfg = convention(Config().parse_json(CMU_PRESET).audio)
    lj = preprocess_both(torch, cli_preprocess, engine, dsp, "ljspeech", lj_in, root, [], lj_cfg)
    emit({"phase": "preprocess_ljspeech", **lj, "card": card})
    cmu = preprocess_both(torch, cli_preprocess, engine, dsp, "cmu_arctic", cmu_in, root,
                          ["--preset", preset], cmu_cfg)
    emit({"phase": "preprocess_cmu_arctic", **cmu, "card": card})

    lj_dir = os.path.join(root, "ljspeech_on_card")
    units = units_phase(torch, serve, cli_invert, vq_kernel, VQVAE, lj_dir, root)
    emit({"phase": "units_and_audio", **units, "card": card})

    # inversion: ljspeech mels by Griffin-Lim, cmu_arctic's (the LWS framing)
    # by LWS, on the utterances nearest INV_SECONDS
    def nearest(out_dir: str, sr: int) -> list:
        mels = [np.load(os.path.join(out_dir, e.mel_path)) for e in read_manifest(out_dir)]
        mels.sort(key=lambda m: abs(m.shape[0] - INV_SECONDS * sr / 256))
        return [torch.from_numpy(np.ascontiguousarray(m.T)) for m in mels[:INV_UTTERANCES]]

    gl_cfg = dataclasses.replace(Config().audio, griffin_lim_iters=INV_GL_ITERS)
    lws_cfg = dataclasses.replace(convention(Config().parse_json(CMU_PRESET).audio),
                                  lws_iterations=INV_LWS_ITERS)
    gl = invert_card_vs_cpu(torch, dsp, nearest(lj_dir, 22050), gl_cfg, "griffin_lim")
    lws = invert_card_vs_cpu(torch, dsp, nearest(os.path.join(root, "cmu_arctic_on_card"), 16000),
                             lws_cfg, "lws")
    return {"phase": "preprocess_and_invert", "ljspeech": {
                k: lj[k] for k in ("shards", "mel_max_abs_err", "mel_err_vs_float64",
                                   "boundary_flips")},
            "cmu_arctic": {k: cmu[k] for k in ("shards", "mel_max_abs_err", "mel_err_vs_float64",
                                               "boundary_flips",
                                               "flip_max_boundary_distance",
                                               "shard_boundary_flips")},
            "frames_per_s": {c: {d: r[d]["frames_per_s"] for d in ("on_card", "on_cpu")}
                             for c, r in (("ljspeech", lj), ("cmu_arctic", cmu))},
            "transform_ms_by_bucket_on_card": {
                c: r["on_card"]["transform_ms_by_bucket"]
                for c, r in (("ljspeech", lj), ("cmu_arctic", cmu))},
            "units": units, "inversion": {"griffin_lim": gl, "lws": lws},
            "vq_launches": units["vq_launches"], "seconds": time.perf_counter() - t0,
            "card": card}


ATTN_REPLACES = {
    "flash_fwd": "neural_sound_generation_tpu/ops/pallas/attention.py:165",
    "flash_bwd_dq": "neural_sound_generation_tpu/ops/pallas/attention.py:233",
    "flash_bwd_dkdv": "neural_sound_generation_tpu/ops/pallas/attention.py:233",
}


def attention_summary(rows: dict, name: str, launches: int) -> dict:
    """One attention kernel's entry of the kernels line, at the shape the
    prior's training path gives it (ATTN_MAIN), with its time at every
    shape beside. The backward kernels have no library call of their own;
    their entries carry the whole backward's times under ``backward``."""
    main = rows[ATTN_MAIN]
    entry = {
        "name": name, "route": "cuda",
        "source": "neural_sound_generation_tpu_torch/csrc/flash_attention.cu",
        "replaces": ATTN_REPLACES[name], "status": "ported",
        "shape": {"bh": main["bh"], "t": main["t"], "d": main["d"], "dtype": main["dtype"]},
        "launches": launches, "max_abs_err": main["max_abs_err"][name],
        "ms": main["kernel_ms"][name], "plain_ms": main["plain_ms"][name],
        "bound_ms": main["bound_ms"][name], "bound_by": main["bound_by"][name],
        "library_ms": main["library_ms"][name],
        "device_ms": main["device_ms"][name], "plan": main["plan"][name],
        "by_shape": {shape: {"ms": r["kernel_ms"][name], "device_ms": r["device_ms"][name],
                             "bound_ms": r["bound_ms"][name],
                             "bound_3xtf32_ms": r["bound_3xtf32_ms"][name],
                             "plain_ms": r["plain_ms"][name],
                             "library_ms": r["library_ms"][name]}
                     for shape, r in rows.items()},
    }
    if name != "flash_fwd":
        entry["backward"] = main["backward"]
    return entry


def wavenet_summary(rows: dict, api: dict) -> list[dict]:
    """Kernel 5's two variants in the kernels line, per generated sample
    (one step; a call of t steps takes t times as long): the sampling
    variant at its main path's length (the API path's 22050 steps, launched
    there WN_API_CALLS times), the teacher variant at WN_MAIN. The teacher
    variant is the kernel's check harness: no entry point of the JAX package
    or of the port calls it, so no main path launches it."""
    main = rows[WN_MAIN]
    shape = {k: main[k] for k in ("layers", "residual", "gate", "skip", "cin", "out")}
    common = {"route": "cuda", "source": "neural_sound_generation_tpu_torch/csrc/wavenet_gen.cu",
              "replaces": "neural_sound_generation_tpu/ops/pallas/wavenet_gen.py:155",
              "status": "ported", "library_ms": None,
              "library": "none: no PyTorch call computes a WaveNet step",
              "per": "generated sample (one step)"}
    by_shape = {name: {"t": r["t"], "us_per_step": r["us_per_step"],
                       "device_us_per_step": r["device_us_per_step"],
                       "plain_ms_per_step": r["plain_ms"]["wavenet_gen_sample_per_step"],
                       "teacher_max_abs_err": r["teacher_max_abs_err"],
                       "sample_agree_frac": r["sample_agree_frac"]}
                for name, r in rows.items()}
    t = api["samples"]
    sample = {
        "name": "wavenet_gen_sample", **common, "shape": {**shape, "t": t},
        "launches": api["launches"]["wavenet_gen_sample"],
        "max_abs_err": api["sample_max_abs_err"],
        "ms": api["kernel_ms"] / t,
        "plain_ms": main["plain_ms"]["wavenet_gen_sample_per_step"],
        "bound_ms": api["bound"]["bound_ms"] / t, "bound_by": api["bound"]["bound_by"],
        "device_ms": api["kernel_device_ms"] / t,
        "realtime_factor": api["kernel_realtime_factor"], "plan": api["plan"],
        "call_ms": api["kernel_ms"], "by_shape": by_shape,
    }
    tb = main["bound"]["wavenet_gen_teacher"]
    teacher = {
        "name": "wavenet_gen_teacher", **common, "shape": {**shape, "t": main["t"]},
        "launches": api["launches"]["wavenet_gen_teacher"], "on_main_path": False,
        "max_abs_err": main["teacher_max_abs_err"],
        "ms": main["ms"]["wavenet_gen_teacher"] / main["t"],
        "plain_ms": main["plain_ms"]["wavenet_gen_teacher"] / main["t"],
        "bound_ms": tb["bound_ms"] / main["t"], "bound_by": tb["bound_by"],
        "device_ms": main["device_ms"]["wavenet_gen_teacher"] / main["t"],
        "plan": main["plan"]["wavenet_gen_teacher"],
        "call_ms": main["ms"]["wavenet_gen_teacher"],
    }
    return [sample, teacher]


# ---------------------------------------------------------------------------
# Phase 9: the 3x3 conv's A/B (kernel 6's entry point)
# ---------------------------------------------------------------------------


def load_ab_script():
    """``scripts/torch_ab_conv3x3.py`` as a module (the scripts are not a
    package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_ab_conv3x3.py")
    spec = importlib.util.spec_from_file_location("torch_ab_conv3x3", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def conv_ab_phase(conv3x3, ab) -> dict:
    """The A/B script's ``main()`` (parity, then cuDNN, taps, im2col, cuDNN
    legs of 400 chained convolutions), with each kernel's launch count set to
    0 just before it and read just after."""
    conv3x3.reset_launch_count()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = ab.main([])
    launches = conv3x3.launch_counts()
    for name in conv3x3.KERNELS:
        check(launches[name] > 0, f"the A/B launched {name} no time")
    return {"phase": "conv3x3_ab", **result, "launches": launches,
            "seconds": time.perf_counter() - t0}


CONV_REPLACES = {"conv3x3_taps": "scripts/ab_conv3x3.py:60",
                 "conv3x3_im2col": "scripts/ab_conv3x3.py:95"}


def conv_summary(rows: dict, ab_run: dict) -> list[dict]:
    """Kernel 6's two variants in the kernels line, at the A/B shape
    (CONV_MAIN), with launches from the A/B's run and its legs' times."""
    main = rows[CONV_MAIN]
    legs = ab_run["summary"]
    return [{
        "name": name, "route": "cuda",
        "source": "neural_sound_generation_tpu_torch/csrc/conv3x3.cu",
        "replaces": CONV_REPLACES[name], "status": "ported",
        "shape": {"b": main["shape"][0], "h": main["shape"][1], "w": main["shape"][2],
                  "c": main["shape"][3], "dtype": "bf16"},
        "launches": ab_run["launches"][name], "path": "scripts/torch_ab_conv3x3.py main()",
        "max_abs_err": main["errors"][name]["max_abs_err"],
        "max_ulp": main["errors"][name]["max_ulp"],
        "bit_equal_frac": main["errors"][name]["bit_equal_frac"],
        "ms": main["kernel_ms"][name], "device_ms": main["kernel_device_ms"][name],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"], "library_device_ms": main["library_device_ms"],
        "library": main["library"], "plan": main["plan"][name],
        "ab_us_per_iter": legs[name.split("_", 1)[1] + "_us"],
        "ab_cudnn_us_per_iter": legs["cudnn_us"],
        "by_shape": {shape: {"ms": r["kernel_ms"][name],
                             "device_ms": r["kernel_device_ms"][name],
                             "bound_ms": r["bound_ms"],
                             "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                             "library_device_ms": r["library_device_ms"],
                             "ctas": r["plan"][name]["ctas"],
                             "registers": r["plan"][name]["registers"],
                             "max_ulp": r["errors"][name]["max_ulp"],
                             "bit_equal_frac": r["errors"][name]["bit_equal_frac"]}
                     for shape, r in rows.items()},
    } for name in main["kernel_ms"]]


def build_phase(build, modules) -> list[dict]:
    """Every kernel's library, one nvcc per source, all started together."""
    errors: dict = {}

    def load(mod):
        try:
            mod.load(rebuild=True)
        except (RuntimeError, OSError) as e:  # reported below, the run fails
            errors[mod.__name__] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=load, args=(m,)) for m in modules]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    seconds = time.perf_counter() - t0
    for name, e in errors.items():
        raise SmokeFailure(f"build of {name} failed: {e}")
    rows = []
    for name in ("vq_nearest", "fused_adam", "flash_attention", "wavenet_gen", "conv3x3"):
        info = build.build_info[name]
        check("sm_90a" in info["log"], f"ptxas did not compile {name} for sm_90a")
        rows.append({"phase": "build", "kernel": name, "seconds": seconds,
                     "nvcc_seconds": info["seconds"], "library": info["path"],
                     "ptxas": ptxas_lines(build, name)})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        from neural_sound_generation_tpu_torch.cli import evaluate as cli_evaluate
        from neural_sound_generation_tpu_torch.cli import main as cli_main
        from neural_sound_generation_tpu_torch.cli import prior as cli_prior
        from neural_sound_generation_tpu_torch.cli import serve
        from neural_sound_generation_tpu_torch.cli import vocoder as cli_vocoder
        from neural_sound_generation_tpu_torch.device import set_full_float32
        from neural_sound_generation_tpu_torch.models import VQVAE
        from neural_sound_generation_tpu_torch.models import wavenet as wn
        from neural_sound_generation_tpu_torch.ops import dsp
        from neural_sound_generation_tpu_torch.ops.cuda import (
            build, conv3x3, fused_adam, vq_kernel, wavenet_gen)
        from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
        from neural_sound_generation_tpu_torch.training import checkpoint
        ab = load_ab_script()
    except (ImportError, OSError) as e:
        print(f"FAIL: the port is not beside this script: {e}", file=sys.stderr)
        return 1
    set_full_float32()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke")
    try:
        # phase 1: device and card
        card = card_line()
        print(card, flush=True)
        emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "card": card})

        # phase 2: build
        for row in build_phase(build, (vq_kernel, fused_adam, fa, wavenet_gen, conv3x3)):
            emit(row)

        # phase 3: kernels against their plain versions
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        rows = {}
        vq_ptxas = ptxas_lines(build, "vq_nearest")
        for n, k, d in [(n, k, VQ_D) for n, k in VQ_SHAPES] + VQ_EDGE_SHAPES:
            x = torch.randn(n, d, generator=gen, device="cuda")
            cb = torch.randn(k, d, generator=gen, device="cuda")
            timed = (n, k) in VQ_SHAPES and d == VQ_D
            row = compare_vq(torch, vq_kernel, x, cb, timed=timed)
            row["ptxas"] = vq_ptxas
            emit(row)
            check(row["mismatches"] == row["near_ties"],
                  f"vq_nearest N={n} K={k} D={d}: {row['mismatches'] - row['near_ties']} "
                  f"mismatches that are not near-ties")
            check(row["run_to_run_identical"],
                  f"vq_nearest N={n} K={k} D={d}: two calls differ")
            if timed:
                check(row["ctas"] >= row["sms"],
                      f"vq_nearest N={n} K={k}: {row['ctas']} CTAs on {row['sms']} SMs")
                rows[(n, k)] = row
            del x, cb
        emit(vq_tie_case(torch, vq_kernel, gen))
        n_params = sum(p.numel() for p in VQVAE(1, TRAIN_DIM, TRAIN_CODES).parameters())
        adam_rows = {}
        for config in ADAM_CONFIGS:
            row = compare_fused_adam(torch, fused_adam, n_params, config, gen)
            emit(row)
            adam_rows[config[0]] = row
        attn_rows = {}
        for shape in ATTN_SHAPES:
            row = compare_attention(torch, fa, shape, gen)
            emit(row)
            limit = ATTN_BF16_REL if shape[4] else ATTN_F32_REL
            check(max(row["rel_err"].values()) <= limit,
                  f"flash attention {shape[0]}: errors {row['rel_err']} above {limit}")
            check(row["run_to_run_identical"],
                  f"flash attention {shape[0]}: two runs differ")
            for kernel, plan in row["plan"].items():
                check(plan["spill_bytes"] == 0,
                      f"{kernel} {shape[0]}: {plan['spill_bytes']} bytes spilled per thread")
            attn_rows[shape[0]] = row
        conv_rows = {}
        for shape in CONV_SHAPES:
            row = compare_conv3x3(torch, conv3x3, ab, shape, gen)
            emit(row)
            check_conv_row(row, ab)
            conv_rows[shape[0]] = row
        torch.cuda.empty_cache()

        # phase 4: the serving path, with launch counts from its HTTP requests
        serving = serve_phase(torch, serve, dsp, vq_kernel, VQVAE)
        emit(serving)

        # phase 5: the training path, with launch counts from each run
        training, vq_ckpt, corpus = train_phase(torch, dsp, cli_main, serve, checkpoint,
                                                vq_kernel, fused_adam, root)
        training["card"] = card
        emit(training)
        torch.cuda.empty_cache()

        # phase 6: residual VQ and --bf16 training, with launch counts
        rvq = rvq_phase(torch, cli_main, cli_evaluate, checkpoint, vq_kernel, fused_adam,
                        root, corpus)
        rvq["card"] = card
        rvq["f32_single_codebook_train_steps_per_s"] = training["train_steps_per_s"]
        emit(rvq)
        torch.cuda.empty_cache()

        # phase 7: the prior, with launch counts from each cli.prior run
        prior = prior_phase(torch, cli_prior, serve, checkpoint, (vq_kernel, fused_adam, fa),
                            root, vq_ckpt, corpus)
        prior["card"] = card
        emit(prior)
        torch.cuda.empty_cache()

        # phase 8: the vocoder. Kernel 5 against its plain versions, its
        # main path (make_generate_fn(use_kernel=True)) with launch counts,
        # then the CLI's full-width vocoder through cli.vocoder and cli.serve
        wn_rows = {}
        for shape in WN_SHAPES:
            row = compare_wavenet(torch, wn, wavenet_gen, shape, gen)
            emit(row)
            check_wavenet_row(row)
            wn_rows[shape[0]] = row
        residency = {name: r["plan"]["wavenet_gen_sample"]["resident_whole"]
                     for name, r in wn_rows.items()}
        check(residency[WN_MAIN] and not residency["streamed_T64"],
              f"wavenet_gen: chain weights resident whole by shape {residency}, expected "
              f"whole at {WN_MAIN} and partly streamed at streamed_T64")
        torch.cuda.empty_cache()
        wn_api = wavenet_api_path(torch, wn, wavenet_gen, gen)
        wn_api["card"] = card
        emit(wn_api)
        vocoder = vocoder_fullwidth(torch, serve, cli_vocoder, checkpoint, wavenet_gen, dsp,
                                    root, vq_ckpt, os.path.join(root, "prior", "models"))
        vocoder["card"] = card
        emit(vocoder)

        # phase 9: kernel 6's entry point, the A/B script, with launch counts
        conv_ab = conv_ab_phase(conv3x3, ab)
        conv_ab["card"] = card
        emit(conv_ab)

        # phase 10: corpus preprocessing on the card and the CPU, units
        # through kernel 1 with its launch count, mel inversion
        prep = preprocess_phase(torch, serve, dsp, vq_kernel, VQVAE, root, card)
        emit(prep)
    except (SmokeFailure, RuntimeError, ValueError, OSError, KeyError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # phase 11: summary and result
    train_runs = [*training["runs"].values(), rvq["run"]]
    train_vq = sum(r["launches"]["vq_kernel"] for r in train_runs)
    train_adam = sum(r["launches"]["fused_adam"] for r in train_runs)
    prior_runs = prior["runs"].values()
    prior_launches = {k: sum(r["launches"][k] for r in prior_runs)
                      for k in ("vq_nearest", "fused_adam", *fa.KERNELS)}
    main_row, train_row = rows[VQ_MAIN_SHAPE], rows[VQ_TRAIN_SHAPE]
    adam_row = adam_rows[ADAM_CONFIGS[0][0]]
    emit({"kernels": [{
        "name": "vq_nearest", "route": "cuda",
        "source": "neural_sound_generation_tpu_torch/csrc/vq_nearest.cu",
        "replaces": "neural_sound_generation_tpu/ops/pallas/vq_kernel.py:49",
        "status": "ported", "shape": {"n": VQ_MAIN_SHAPE[0], "k": VQ_MAIN_SHAPE[1], "d": VQ_D},
        "launches": (serving["vq_launches"] + train_vq + prior_launches["vq_nearest"]
                     + prep["vq_launches"]),
        "launches_by_path": {"serving": serving["vq_launches"], "training": train_vq,
                             "prior": prior_launches["vq_nearest"],
                             "preprocess_units": prep["vq_launches"]},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "training_shape": {"n": VQ_TRAIN_SHAPE[0], "ms": train_row["kernel_ms"],
                           "plain_ms": train_row["plain_ms"], "bound_ms": train_row["bound_ms"],
                           "library_ms": train_row["library_ms"]},
    }, {
        "name": "fused_adam", "route": "cuda",
        "source": "neural_sound_generation_tpu_torch/csrc/fused_adam.cu",
        "replaces": "neural_sound_generation_tpu/ops/pallas/fused_adam.py:49",
        "status": "ported", "shape": {"n": n_params, "config": adam_row["config"]},
        "launches": train_adam + prior_launches["fused_adam"],
        "launches_by_path": {"training": train_adam, "prior": prior_launches["fused_adam"]},
        "max_abs_err": adam_row["max_abs_err"],
        "ms": adam_row["kernel_ms"], "plain_ms": adam_row["plain_ms"],
        "bound_ms": adam_row["bound_ms"], "bound_by": adam_row["bound_by"],
        "library_ms": adam_row["library_ms"],
    }] + [attention_summary(attn_rows, name, prior_launches[name]) for name in fa.KERNELS]
      + wavenet_summary(wn_rows, wn_api) + conv_summary(conv_rows, conv_ab)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

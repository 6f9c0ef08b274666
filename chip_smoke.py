#!/usr/bin/env python3
"""Drives the PyTorch port's serving, training (single-codebook float32 and
residual-VQ bf16), prior, vocoder, 3x3-convolution A/B, corpus
preprocessing, mel-inversion, other-autoencoder (HierVQVAE, WaveVQVAE,
VAE), PixelCNN-prior, hierarchical-chain, vocoder-training, routed
(switch-MoE) prior, bf16 prior, motion, data-parallel, tensor-parallel
(the flat VQ-VAE, the transformer prior, the other autoencoders, the
vocoder and the PixelCNN), pipeline-parallel (the transformer prior and
the vocoder) and sequence-parallel (the halo convolution) paths and the
utilities on one CUDA card and checks them.

Run from the root of the repository: ``python3 chip_smoke.py``. Phases:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles every CUDA kernel of the port from ``csrc/``, one
   ``nvcc`` per source, and the native libraries of the motion path and
   the data loader with ``g++`` into ``build/native/``, all started
   together;
3. kernels: holds each kernel against its plain PyTorch version at the
   shapes the serving path and the flagship training step give it, and
   times kernel, plain version, one PyTorch library call and the card's
   bound: the nearest-code search at serving and training shapes (each
   row also with its cluster size and CTA count, which must cover the
   SMs, its registers and spills, device-only times and a second call
   that must return the same indices bit for bit; four edge shapes held
   untimed, and a tie case), the
   fused Adam update at the flagship's parameter count in three
   configurations over three chained steps (and at the default PixelCNN's
   and the routed prior's counts in the first; each row also device-only),
   and the causal-attention
   forward, dQ and dK/dV kernels at the prior's grids (T = 140 and 560 in
   f32 and bf16, 2240, a ragged T = 37, D = 128, and the contract's ends T = 1
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
   launch, and that every run's loaders took the native C++ loader
   (``data.native_loader``, said on a line of its own) and one epoch of
   its batches is bit-equal to the Python collate's; checks the loss is
   finite and falls, the checkpoint and its metadata, one train step on
   the card against the same step on the CPU (without a code flip
   grad_norm within FLAT_NO_FLIP_GRAD_REL), times train steps/s (a few
   steps under ``utils.StepTimer`` and ``utils.trace_context``, whose
   trace directory must fill), and serves /reconstruct from the trained
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
   default vocoder at full width (R = G = 512, S = 256; its depth cut to 8
   layers in 2 stacks) from a seeded-init artifact: ``cli.vocoder synthesize``, and ``cli.serve
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
11. other autoencoders, at the training phase's width (dim 256, 512 codes,
    batch 64), each run's launch counts checked against what it must
    launch and its loss finite and falling: ``cli.main --model hiervqvae
    --codebook-init data`` on phase 5's corpus (80 x 24 crops), its
    checkpoint's metadata, ``cli.evaluate``, one f32 step card vs CPU
    (every top flip, and every bottom flip no top flip explains, a
    near-tie; without a flip grad_norm within max(1e-5, HIER_SPREAD_C s),
    s the CPU's own change of it at one thread), and ``cli.serve --model
    hiervqvae`` (80-frame windows)
    answering /encode, /decode and /reconstruct of 1 s and 8 s chirps with
    aligned grids, finite audio and card-vs-CPU codes equal but at
    near-ties and their cascades; ``cli.main --model wavevqvae`` raw with
    EMA codebooks, restarts and data init (7168-sample crops), one raw
    step card vs CPU under the RVQ step's rules (without a flip grad_norm
    within WAVE_NO_FLIP_GRAD_REL), then mulaw-quantize with 2
    residual stages from a preset the script writes on a mu-law copy of
    the corpus; ``cli.main --model vae`` on an idx-format MNIST of stroke
    images and one epoch of a CIFAR-10 pickle batch; steps/s of each; then
    the nearest-code kernel against its plain version at the new shapes
    (1920, 7680 and 7168 rows of the trained models' z_e against 512
    codes of 256), timed device-only beside cdist+argmin;
12. priors: the GatedPixelCNN at the CLI's defaults (dim 64, 15 layers, a
    512-wide head over 512 codes) through ``cli.prior train`` on phase 5's
    VQ-VAE and corpus (batch 32 of 20 x 7 grids, three epochs, then
    --resume), each run's launch counts (nearest-code: encoded batches,
    fused Adam: steps, attention: none), the NLL falling, one step card vs
    CPU, steps/s, the row-cached logits against the forward and the fast
    sampler against the naive one on the same noise, the sampler's
    launches per code, ``cli.prior sample`` and /sample at n = 1 and 4
    from ``serve --prior-ckpt``; then the hierarchical chain on phase 11's
    HierVQVAE: ``cli.prior train --hier`` for the transformer top prior
    (phase 7's width, 10 x 3 grids) and the PixelCNN bottom prior (20 x 6
    grids conditioned on 256-channel maps), their launch counts (2
    nearest-code searches per encoded batch; attention layers x steps for
    the top), the distinct top and bottom codes the priors trained on, one
    bottom step card vs CPU, one step of a spatially conditioned
    transformer bottom card vs CPU, steps/s, ``cli.prior sample --hier``
    and ``serve --model hiervqvae`` /sample at n = 1 and 4 (10 x 10 top, 20 x
    20 bottom); then one train step of each family timed at the 40 x 56
    bottom grid;
13. vocoder training: ``cli.vocoder train`` at the CLI's default width (24
    layers, R = G = 512, S = 256; batch 2 of 7168-sample crops, 8 batches
    an epoch): the mel chain (MoL) on phase 5's corpus for two epochs, then
    --resume for a third and --resume --multi-steps 4 for a fourth; --bf16
    for two; mulaw-quantize with speakers (gin_channels 16) on phase 10's
    cmu_arctic corpus under a cmu_arctic_8bit preset the script writes;
    --condition units on phase 11's raw WaveVQVAE (dim 256, 512 codes,
    downsample 6). Each run's launch counts (fused Adam: steps;
    nearest-code: one a step in the units chain, 0 otherwise), its loss
    finite and falling, its checkpoints and their metadata; one f32 and one
    bf16 step card vs CPU on 2048-sample crops (f32: loss 1e-5, grad_norm
    1e-4, parameters as phase 5; bf16: loss 2e-2); the units card vs CPU
    (flips only at near-ties); steps/s over 20 device-resident steps in f32
    and bf16; ``cli.vocoder synthesize`` from the mel artifact and with
    --condition units --wav-in from the units artifact; the fused Adam
    kernel at 24,886,366 parameters (EMA) and 25,337,152 (no EMA);
14. the routed transformer prior: phase 7's prior with its MLPs switch-routed
    over 4 experts (the JAX package's MoE configuration, capacity factor
    1.25; 2,525,328 parameters): ``cli.prior train --moe-experts 4`` for
    two epochs, then --resume --multi-steps 4 for a third, each run's
    launch counts (attention kernels layers x steps, fused Adam steps,
    nearest-code encoded batches), the NLL falling and each epoch's
    load-balance mean finite, the checkpoint's n_experts; one step card vs
    CPU from the resumed state with its routing decisions compared (a flip
    only at a near-tie, top-2 probabilities within 1e-5, or in a flip's
    causal cascade; phase 7's limits when none flipped) and the share of
    tokens each layer dropped; the KV-cached routed decode against the
    forward within 1e-4 at capacity factors 1.25 and 0.5 (every layer
    dropping tokens at 0.5); steps/s; ``cli.prior sample --moe-experts 4``
    and /sample at n = 1 and 4 from ``serve --prior-moe-experts 4``;
15. the priors in bf16: ``cli.prior train --bf16`` for the dense and the
    routed transformer (phases 7 and 14's widths) and the PixelCNN (phase
    12's) for two epochs, then --resume for a third, each run's launch
    counts (nearest-code: encoded batches, fused Adam: steps, attention
    layers x steps for the transformers, every one of them on bf16 inputs),
    the NLL falling, the checkpoint's metadata (the dtype is not in it);
    one bf16 step card vs CPU from the first epoch's state (loss terms
    within 2e-2; routing flips only at near-ties or in their cascades); the
    KV-cached and row-cached bf16 logits against the bf16 forward within
    2e-2 of the largest logit; steps/s in bf16 and float32 from the same
    state; the sampler's kernels a code; ``cli.prior sample --bf16`` from
    each checkpoint and from phase 7's float32 one; ``sample --hier
    --bf16`` from phase 12's checkpoints; ``chunked_causal_attention`` at
    BH 16 x T 2240 x D 64 in f32 and bf16, forward and gradients, against
    the plain pair, the stock path against it, and the peak memory and ms
    of a forward and backward of the chunked path, the kernels and the
    stock path;
16. motion: the native runtime (18 features, the synthetic hand at seed 123
    against ``tests/golden/motion_golden.npz`` and the C++ joint-angle
    extraction against numpy, each within 1e-12); ``cli.motion capture`` of
    600 frames, ``analyze``, ``watch`` and ``watch --gestures`` (all four
    gesture types); phase 5's full-width VQ-VAE (dim 256, 512 codes)
    restored through ``generate``'s rule (only ``feature_proj`` filled) into
    a model with 3 feature inputs, ``MotionDrivenGenerator.run_stream`` over
    the whole capture in 16-frame windows and ``frames_to_mel`` of all 600
    frames at once on the card (nearest-code launches: one a window, one for
    the batch) and on the CPU: code flips only at near-ties, one decision a
    window or frame, mels within 1e-3 where the codes agree; ms a window
    (p50, p90, device-only) beside the window's 16 frames of motion and its
    audio; kernel 1 against its plain version at those shapes (80 and
    48,000 rows of 256 against 512 codes); ``cli.motion generate`` on the
    card from the checkpoint over every window and at the CLI's defaults;
17. data parallel: the training CLIs under ``torchrun``, once on one rank
    (no process group: the one-rank program) and once on two ranks that
    share this card over gloo (``chip_smoke.py --dp-rank spec.json`` is one
    rank): the flagship through ``cli.main`` at phase 5's width for
    two epochs (phase 5's first run), then one --resume step on two ranks;
    ``cli.evaluate --mesh-data`` on the one-rank checkpoint; one RVQ/bf16
    step with phase 6's flags; the routed prior (phase 14's widths) and the
    mulaw-quantize vocoder (phase 13's preset and width) for DP_JOB_STEPS
    steps. Each rank's launch counts (kernel 1 at 8,960 / W rows a search,
    kernel 3 once a step, kernel 4 per layer), the first steps two ranks
    against one (the loss within 1e-5, the all-reduced flat gradient
    within 1e-4 of the norm or 2e-3 with a code flip, every flip a
    near-tie, the parameters after Adam's first step as phase 5 holds the
    card against the CPU; the RVQ step's EMA statistics and restarts equal
    but for what its code flips move), the loss falling, the ranks'
    states bit-equal, the evaluation's metrics and gathered
    reconstruction, the all-reduce time of the flagship's gradient at
    W = 1 (NCCL, a group of one) and W = 2 (gloo), and steps/s at both;
18. tensor parallel: the nearest-code kernel at the flagship step's search
    over 2 and 4 codebook shards, whose merged (score, index) pairs must
    equal one whole-codebook launch bit for bit (scores within the
    kernel header's bound of float64); then ``cli.main --model vqvae
    --mesh-model 2`` under ``torchrun`` (``chip_smoke.py --tp-rank
    spec.json`` is one rank) at W 2 (data 1 x model 2) and W 4 (2 x 2),
    the ranks sharing this card over gloo, with phase 17's flagship flags,
    against phase 17's W 1 run; at W 2 also a --resume step from phase
    17's W 1 checkpoint, ``cli.evaluate --mesh-model 2`` on it and one
    RVQ/bf16 step. Each rank's launches (kernel 1 once a search at K 256,
    kernel 3 once a step at the rank's n), the first step against W 1 (as
    phase 17), the loss falling, the data groups' states and the model
    groups' replicated leaves bit-equal, the evaluation's metrics; ms a
    step of the first step's collectives replayed, steps/s, the bytes of
    a rank's parameters, moments and EMA, kernel 3 at the rank's n;
19. tensor-parallel prior: ``cli.prior train --arch transformer
    --mesh-model 2`` under ``torchrun`` at W 2 (data 1 x model 2) and W 4
    (2 x 2), the ranks sharing this card over gloo, each job against a W 1
    launch of the same flags at phase 7's widths: the dense prior, the
    routed prior (4 experts), at W 2 one --bf16 step and one --resume step
    from W 1's checkpoint. Each rank's launches (kernel 4 three a layer a
    step, every one at the rank's BH; kernel 3 once a step at the rank's
    n; kernel 1 once an encoded batch), the first step against W 1 (loss,
    gathered gradient, routing flips), the loss falling, the groups
    bit-equal; ``cli.prior sample`` from the M 2 checkpoint on this
    process; kernel 4 at a rank's BH 32 x 140 x 64 in f32 and bf16 and
    kernel 3 at the dense and routed ranks' n against their plain
    versions; steps/s, collectives and bytes a rank as phase 18;
20. tensor-parallel autoencoders: ``cli.main --mesh-model 2`` under
    ``torchrun`` for the HierVQVAE, the raw WaveVQVAE (EMA codebook,
    restarts, data init), the mulaw-quantize WaveVQVAE with 2 residual
    stages and the VAE (MNIST) at phase 11's full widths, P20_STEPS steps
    and an eval batch each, at W 1 and W 2 (data 1 x model 2), and the
    raw wave model at W 4 (2 x 2), the ranks sharing this card over gloo;
    at W 2 ``cli.evaluate --mesh-model 2`` and a --resume step from W 1's
    hier and wave checkpoints. Each rank's launches (W 1's counts; every
    search after the data init at the rank's rows and K 256; kernel 3
    once a step at the rank's n), the first step against W 1 (loss,
    gathered gradient within phase 17's limits or, where above them, twice
    the gap of W 1's own first step recomputed on the CPU, each search's
    code flips, each a near-tie unless an earlier search of the step
    flipped), the groups bit-equal, a rank's
    flat buffer at the table's share of W 1's (the VAE's whole), the
    evaluation's metrics; kernel 1 at the hier top, hier bottom and wave
    shard shapes and kernel 3 at each family's rank n against their plain
    versions; the raw wave step's collectives replayed and steps/s;
21. tensor-parallel gated families: ``cli.vocoder train --mesh-model 2``
    at phase 13's default vocoder (mel MoL, batch 2 of 7168-sample crops)
    and ``cli.prior train --mesh-model 2`` at the CLI's default PixelCNN
    on phase 5's VQ-VAE (batch 32 of 20 x 7 grids) under ``torchrun`` at W
    1, W 2 (data 1 x model 2) and W 4 (2 x 2), the ranks sharing this card
    over gloo, P21_VOCODER_STEPS and P21_PIXELCNN_STEPS steps; at W 1 and W
    2 also one --bf16 step of each, mulaw-quantize with speakers on a
    mu-law copy of phase 5's corpus, --condition units on phase 11's
    WaveVQVAE and the spatially conditioned bottom prior on phase 11's
    HierVQVAE; at W 2 a --resume step of each family from W 1's
    checkpoint. Each rank's launches (W 1's counts: kernel 3 once a step
    at the rank's n, kernel 1 once an encoded batch on the rank's rows),
    the first step against W 1 (the loss, 2e-2 in bf16; the gathered
    gradient as phase 20), the groups bit-equal, a rank's flat buffer at
    the table's share; ``synthesize`` and ``cli.prior sample`` from the M
    2 checkpoints on this process; kernel 1 at the ranks' encode shapes
    and kernel 3 at the vocoder's and the PixelCNN's rank n against their
    plain versions; the vocoder step's collectives replayed and steps/s;
22. pipeline parallelism: ``cli.prior train --arch transformer
    --mesh-pipe`` at phase 19's widths and ``cli.vocoder train
    --mesh-pipe`` at phase 21's under ``torchrun``, the ranks sharing this
    card over gloo: at W 2 (pipe 2, 2 microbatches) the dense, routed,
    bf16 and hier-bottom priors and the mel MoL, bf16, mulaw-quantize
    (speakers) and units vocoders; at W 4 the dense prior on (data 2 x
    pipe 2) and at pipe 4 with 4 microbatches, a pipe-4 --resume from the
    pipe-2 ``_pp_train`` sibling and the vocoder at pipe 4 on batch 4.
    Each job against the W 1 run of its flags (phases 19 and 21's; the
    hier-bottom transformer and the batch-4 vocoder run here): the first
    loss (2e-2 in bf16), the gradient norm and the gathered gradient
    (phase 17's limits, the vocoder's as phase 21), the parameters after
    the first step within 2 lr; each rank's launches (kernel 4 a stage's
    layers x microbatches x steps for each kernel at the microbatch's BH,
    kernel 3 once a step, kernel 1 once an encoded batch), its state
    bit-equal across its stage's ranks and its rest across its pipe group,
    its flat buffer its stage's parameters; the hand-offs' seconds and
    bytes; ``cli.prior sample`` and ``synthesize`` from the pipe-2
    artifacts on this process; kernel 4 at BH 16 and 32, kernel 3 at a
    stage's n and kernel 1 at a rank's rows against their plain versions;
23. sequence parallelism and utilities: ``parallel.sequence.halo_conv1d``
    at full width on the ranks of phase 21's W 2 and W 4 launches (each
    rank builds its shard of one seeded (2, 131072, C) input; only halos
    cross the group): the default vocoder's widest dilated layer (512 ->
    512, K 3, dilation 32, causal) and the WaveVQVAE's "same" 256 -> 256 K
    3 convolution, each rank's output within SEQ_OUT_REL of the largest
    magnitude of a one-rank cuDNN ``conv1d`` of the whole array, its input
    gradient and the kernel's gradient summed over the ranks within
    SEQ_GRAD_REL; ``sharded_conv1d`` end to end at T 16384; the halo bytes
    and the exchange's host ms a call. In this process:
    ``utils.SpectrogramParser`` on the card against the CPU,
    ``utils.project_codebook_2d`` on phase 5's trained codebook, whether
    matplotlib is installed, and ``utils.visualize_embedding`` where it is;
24. summary: one JSON line per kernel, then the result line.

Phases 18 to 23 share one ``torchrun`` launch a world (a launch's rank
start-up costs some 20 s of the command's 1,200): the one-rank jobs of
phases 19 and 20 run first, in this process; phase 21's launches carry
the two- and four-rank jobs of phases 18, 19, 20, 22 and 23; then the
checks of 18, 19, 20, 22 and 23 run in that order.

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
# grid (in bf16 too, the --bf16 prior's step), 560 the flagship 20 x 28
# grid (cli.prior sample's default), 2240 the hierarchical bottom grid;
# then the ends of the kernels' contract: one row (T = 1), and bf16 rows of
# 40 bytes (D = 20), which TMA cannot stage
ATTN_SHAPES = [("train_T140", 64, 140, 64, False), ("train_T140_bf16", 64, 140, 64, True),
               ("flagship_T560", 64, 560, 64, False),
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

# the other autoencoders: the training phase's width (dim 256, 512 codes,
# batch 64, BATCHES_PER_EPOCH batches an epoch), cut in depth only. The
# hierarchy's crops are 80 x 24 (static_crop_frames(8000, 256, 8)), so the
# kernel sees 1920 top and 7680 bottom rows; the wave model's are 7168
# samples (28 frames of 256), 7168 units of 2**6 samples at batch 64
OTHER_EPOCHS = 2
OTHER_TIMED_STEPS = 20
HIER_SERVE_REPEATS = 10  # timed requests per endpoint and length
HIER_CHIRP_SECONDS = (1.0, 8.0)
WAVE_DOWNSAMPLE = 6
VAE_Z = 128
MNIST_IMAGES = (1024, 128)  # (train, test): 16 batches of 64 an epoch, cut to 8
CIFAR_IMAGES = (512, 128)
OTHER_VQ_SHAPES = {"hier_top": (1920, 512, 256), "hier_bottom": (7680, 512, 256),
                   "wave_units": (7168, 512, 256)}  # (N, K, D)

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
# the CLI's default vocoder (R = G = 512, S = 256) is served with a
# 16-frame window: /sample_stream's 20 x 4 code grid then decodes to 16 mel
# frames, one 4096-sample chunk, as the 0.1 s chirp of /reconstruct_stream
# and its /decode are; the scan sampler is launch-bound on the card, so one
# chunk per request keeps the phase short
WN_SERVE_FRAMES = 16
WN_CHIRP_SECONDS = (0.1, 0.15)
# ... at its full width but a third of its depth (8 layers in 2 stacks of
# dilations 1-8): a request's time follows the layers the scan sampler steps
# through, and the 24-layer vocoder's requests took the phase to 70-75 s
WN_SERVE_LAYERS, WN_SERVE_STACKS = 8, 2
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


ADAM_ROW_KEYS = ("n", "max_abs_err", "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms",
                 "library_ms", "library_device_ms")


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

    def kernel():
        fused_adam.fused_adam_update(g, *ker, scalars, **kw)

    kernel_ms = time_ms(torch, kernel, 50)
    kernel_device_ms, _ = device_time_ms(torch, kernel, 50)
    plain_ms = time_ms(torch, lambda: fused_adam.fused_adam_plain(g, *ref, scalars, **kw), 20)
    flat = torch.nn.Parameter(p.clone())
    flat.grad = g.clone()
    opt = torch.optim.Adam([flat], lr=1e-3, fused=True)
    library_ms = time_ms(torch, opt.step, 50)
    library_device_ms, _ = device_time_ms(torch, opt.step, 50)
    return {
        "phase": "kernel", "name": "fused_adam", "config": name, "n": n, "steps": ADAM_STEPS,
        "moments": "bf16" if bf16 else "f32", "clip": clip, "wd": wd, "ema": has_ema,
        "max_abs_err": max(errs.values()), "max_abs_err_by_vector": errs,
        "mismatched_elements": mism, "unaligned_mismatches": unaligned,
        "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_device_ms": library_device_ms,
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


# the no-flip grad_norm limits (relative, card vs CPU) of phase 5's flat
# VQ-VAE step and phase 11's raw WaveVQVAE step: float32 order-of-sums
# noise that BatchNorm's backward carries upstream to the first
# convolution. scripts/torch_train_grad_probe.py --limits read on an H100
# a largest no-flip gap of 3.35e-5 over 34 states without a flip (flat,
# seeds 1-40, each trained as phase 5 trains the state it checks; the
# smoke itself has read 3.87e-5 there) and 1.92e-5 over 28 (wave raw,
# seeds 1-46): each limit is 2.6 (flat, against 3.87e-5) and 5.2 times
# the largest, and a twentieth of the 2e-3 flip limit. The CPU's
# one-thread spread does not predict the gap (gap / spread up to 130 flat
# and 264 wave), so the limits are constants, not HIER_SPREAD_C's rule
# (PERF.md, PR 25)
FLAT_NO_FLIP_GRAD_REL = 1e-4
WAVE_NO_FLIP_GRAD_REL = 1e-4
FLIP_GRAD_REL = 2e-3


def flat_card_vs_cpu(torch, cli_main, checkpoint, cfg, ckpt: str, batch) -> tuple[dict, object]:
    """One f32 train step of the flat VQ-VAE on the card and on the CPU from
    the same checkpoint and batch. Returns (the record, the card's state
    after the step)."""
    from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
    from neural_sound_generation_tpu_torch.ops.vq import vq
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

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
    return {"metrics_rel_err": rel, "code_flips": flips, "rows": int(codes["cpu"].numel()),
            "params_beyond_1e-5_frac": far, "params_max_abs_err": float(diff.max()),
            "codebook_rows_beyond_1e-5": cb_rows, "other_params_max_abs_err": rest_max,
            "grad_diff_norm_worst": grad_rel, "params_beyond_1e-5": beyond,
            "grad_norm": metrics[DEVICE]["grad_norm"]}, states[DEVICE]


def check_flat_step(compare: dict) -> None:
    """The limits of phase 5's card-vs-CPU step (``flat_card_vs_cpu``'s
    record)."""
    # TF32 is off, so only the order of f32 sums differs: codes equal but
    # at near-ties (at most 0.1% of rows); loss terms within 1e-5
    # relative; grad_norm within FLAT_NO_FLIP_GRAD_REL relative, or 2e-3
    # when a code flipped (the row's codebook gradient lands on another
    # code); 99.9% of the updated parameters within 1e-5 and all within
    # 1e-2: a conv bias that feeds a train-mode BatchNorm has a true
    # gradient of 0 and a computed one of rounding noise, which Adam turns
    # into steps of up to about lr, as does a flipped code to its codebook
    # rows
    flips, rel = compare["code_flips"], compare["metrics_rel_err"]
    far, worst = compare["params_beyond_1e-5_frac"], compare["params_max_abs_err"]
    check(flips <= 1e-3 * compare["rows"], f"card vs CPU: {flips} codes differ")
    check(max(v for k, v in rel.items() if k != "grad_norm") <= 1e-5,
          f"card vs CPU train step: loss terms differ {rel}")
    limit = FLIP_GRAD_REL if flips else FLAT_NO_FLIP_GRAD_REL
    check(rel["grad_norm"] <= limit,
          f"card vs CPU train step: grad_norm differs by {rel['grad_norm']:.3g} ({flips} flips, "
          f"limit {limit:.3g})")
    check(far <= 1e-3 and worst <= 1e-2,
          f"card vs CPU train step: {far:.3%} of parameters beyond 1e-5, max {worst}")


@contextlib.contextmanager
def recorded_loaders():
    """Every ``MelFrameLoader`` made in the body, listed."""
    from neural_sound_generation_tpu_torch.data import pipeline

    made = []
    saved = pipeline.MelFrameLoader

    class Recorded(saved):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    pipeline.MelFrameLoader = Recorded
    try:
        yield made
    finally:
        pipeline.MelFrameLoader = saved


def native_epoch_check(loader) -> dict:
    """One epoch of ``loader``'s corpus and order through the native path
    and through the Python collate: bit-equal, dtypes included."""
    from neural_sound_generation_tpu_torch.data import pipeline

    def twin(use_native):
        return pipeline.MelFrameLoader(
            loader.dataset, loader.cfg, loader.batch_size, loader.num_hosts, loader.host_id,
            loader.num_workers, loader.seed, loader.shuffle, loader.batch_mode,
            loader.drop_last, loader.latent_stride, use_native=use_native)

    t0 = time.perf_counter()
    native, python = list(twin(True)), list(twin(False))
    seconds = time.perf_counter() - t0
    check(len(native) == len(python) > 0, f"native epoch: {len(native)} batches, python "
          f"{len(python)}")
    for n, (a, b) in enumerate(zip(native, python)):
        check(a.keys() == b.keys(), f"native batch {n}: keys {sorted(a)} vs {sorted(b)}")
        for k in a:
            same = (a[k] is None and b[k] is None) or (
                a[k] is not None and b[k] is not None and a[k].dtype == b[k].dtype
                and np.array_equal(a[k], b[k]))
            check(same, f"native batch {n}: {k} differs from the Python collate's")
    return {"batches": len(native), "bit_equal": True, "seconds": seconds}


def phase5_argv(root: str, corpus: str, tag: str, epochs: int, multi: int, *extra) -> list:
    """Phase 5's ``cli.main`` arguments for the run ``tag`` under ``root``."""
    return ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", corpus,
            "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES),
            "--batch-size", str(TRAIN_BATCH), "--epochs", str(epochs),
            "--multi-steps", str(multi), "--max-batches-per-epoch", str(BATCHES_PER_EPOCH),
            "--log-interval", "1", "--codebook-init", "data", "--device", DEVICE,
            "--ckpt-dir", os.path.join(root, tag, "models"),
            "--sampledir", os.path.join(root, tag, "results"), *extra]


def phase5_ckpt(root: str, tag: str) -> str:
    """The checkpoint directory of phase 5's run ``tag`` under ``root``."""
    return os.path.join(root, tag, "models", "vqvae",
                        f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")


def train_phase(torch, dsp, cli_main, serve, checkpoint, vq_kernel, fused_adam,
                root: str) -> tuple[dict, str, str]:
    """Returns (the phase's record, the trained checkpoint, the corpus)."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.data import native_loader
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step
    from neural_sound_generation_tpu_torch.utils import StepTimer, trace_context

    corpus = os.path.join(root, "corpus")
    t0 = time.perf_counter()
    write_corpus(torch, dsp, Config().audio, corpus)
    corpus_s = time.perf_counter() - t0

    def argv(tag, epochs, multi, *extra):
        return phase5_argv(root, corpus, tag, epochs, multi, *extra)

    def ckpt_dir(tag):
        return phase5_ckpt(root, tag)

    kernels = (vq_kernel, fused_adam)
    runs = {}
    with recorded_loaders() as loaders:
        for tag, multi in (("multi1", 1), ("multi4", 4)):
            runs[tag] = run_cli_main(cli_main, kernels, argv(tag, 2, multi))
        before_resume = checkpoint.latest_step(ckpt_dir("multi4"))
        runs["resume"] = run_cli_main(cli_main, kernels, argv("multi4", 3, 4, "--resume"))
    # every loader of the three runs took the native path and mapped its corpus
    native = sum(1 for ld in loaders if ld.use_native and ld.native is not None)
    emit({"phase": "native_loader", "loaders": len(loaders), "native": native,
          "library": native_loader.library_path().name})
    check(len(loaders) == 6 and native == len(loaders),
          f"cli.main's loaders: {native} of {len(loaders)} native, expected 6 of 6")

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
    t_added = time.perf_counter()
    epoch = native_epoch_check(train_loader)
    added_s = time.perf_counter() - t_added
    compare, state = flat_card_vs_cpu(torch, cli_main, checkpoint, cfg, ckpt, batch)
    emit({"phase": "card_vs_cpu_step", **compare})
    check_flat_step(compare)

    # train steps/s with a device-resident batch
    model = state.model
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
    # a few more under the utilities' timer and trace
    t_added = time.perf_counter()
    trace_dir = os.path.join(root, "trace")
    timer = StepTimer()
    with trace_context(trace_dir, "phase5_train_step"):
        for _ in range(TRACED_STEPS):
            with timer.step():
                step(state, {"x": x})
                sync()
    trace_files = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
    traced = {"summary": timer.summary(), "trace_files": len(trace_files),
              "trace_bytes": sum(os.path.getsize(os.path.join(trace_dir, f))
                                 for f in trace_files)}
    check(traced["trace_bytes"] > 0 and traced["summary"].get("steps") == TRACED_STEPS - 1,
          f"trace_context and StepTimer over {TRACED_STEPS} steps: {traced}")
    added_s += time.perf_counter() - t_added
    del state, model
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
        "native_loaders": native, "native_epoch": epoch, "traced_steps": traced,
        "added_s": added_s,
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
                    dtype, encode=None) -> dict:
    """One residual-VQ train step (EMA codebooks with restarts) on the card
    and on the CPU from the same checkpoint and batch, with the same restart
    draws. A single (K, D) codebook is held as one stage; ``encode(model,
    x)`` gives the encoder's output (the flat model's ``_encode_latents`` by
    default). The new codebook rows are EMA means of the stages' residuals and
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
        stages = model.codebook if model.codebook.ndim == 3 else model.codebook[None]
        with torch.no_grad(), batch_stats_discarded(model):
            model.train()
            z = encode(model, x) if encode else model._encode_latents(x)
            codes[device] = residual_vq(z, stages)[2].cpu()
            z_e[device] = z.cpu()
            codebooks[device] = stages.detach().cpu().double()  # before the step
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
    cb_diff = by_name.pop("codebook").reshape(q_stages, k_codes, -1)
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


def check_ema_step(f32: dict, what: str, no_flip_grad_rel: float = 1e-5) -> None:
    """The limits of an f32 EMA-codebook step card vs CPU
    (``rvq_card_vs_cpu``'s record); ``no_flip_grad_rel``: the grad_norm
    limit when no code flipped."""
    flips = sum(f32["code_flips_by_stage"])
    rel = f32["metrics_rel_err"]
    # every flip, a row's first and its cascades alike, is a near-tie
    # between the two devices' residuals, and at most 1e-3 of the
    # assignments are flipped decisions. The corpus's mels sit at the floor
    # in most bins, so a batch's z_e repeats rows bit for bit (z_e_cpu_rows)
    # and one near-tie flips every row of such a group: the bound counts
    # decisions, not rows
    check(f32["flips_not_near_ties"] == 0,
          f"{what} card vs CPU: {f32['flips_not_near_ties']} of {flips} code flips are not "
          f"near-ties")
    stages = len(f32["code_flips_by_stage"])
    check(f32["flipped_vectors"] <= 1e-3 * stages * f32["rows"],
          f"{what} card vs CPU: {f32['flipped_vectors']} distinct vectors flipped "
          f"({flips} codes)")
    # with no flip the rest is the whole difference; with flips, what the
    # flipped vectors' quantization error explains is taken out first
    rest = f32["metrics_rel_err_rest"]
    check(max(v for k, v in rest.items() if k != "grad_norm") <= 1e-5,
          f"{what} card vs CPU train step: loss terms differ {rel}, "
          f"{rest} beyond what the flips explain")
    limit = FLIP_GRAD_REL if flips else no_flip_grad_rel
    check(rel["grad_norm"] <= limit,
          f"{what} card vs CPU train step: grad_norm differs by {rel['grad_norm']:.3g} "
          f"(limit {limit:.3g})")
    check(f32["other_params_beyond_1e-5_frac"] <= 1e-3 and f32["other_params_max_abs_err"] <= 1e-2,
          f"{what} card vs CPU train step: parameters differ {f32}")
    check(f32["codebook_rows_not_from_a_flip"] == 0,
          f"{what} card vs CPU train step: {f32['codebook_rows_not_from_a_flip']} codebook rows "
          f"differ by more than 1e-5 + max |dz_e| without a flipped assignment")


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
    check_ema_step(f32, "RVQ")
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
LOAD_BALANCE_RE = re.compile(r"^prior epoch \d+: .* load_balance (\S+)$", re.M)


def read_launches(vq_kernel, fused_adam, fa) -> dict:
    return {"vq_nearest": vq_kernel.launch_count(), "fused_adam": fused_adam.launch_count(),
            **fa.launch_counts()}


def run_cli_prior(cli_prior, counters, argv) -> dict:
    """One ``cli.prior`` run with every launch count set to 0 just before
    it and read just after; its output is kept and its epoch NLLs (and a
    routed prior's load-balance means) parsed."""
    for k in counters:
        k.reset_launch_count()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_prior.main(argv)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    return {"seconds": seconds, "launches": read_launches(*counters),
            "epoch_nll": [float(v) for _, v in EPOCH_RE.findall(text)],
            "epoch_load_balance": [float(v) for v in LOAD_BALANCE_RE.findall(text)]}


def prior_phase(torch, cli_prior, serve, checkpoint, counters, root: str, vq_ckpt: str,
                corpus: str) -> dict:
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.data.pipeline import get_audio_data_loaders
    from neural_sound_generation_tpu_torch.models.transformer_prior import incremental_logits

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
    pcfg = prior_cfg(cfg)
    batch = {"codes": codes, "labels": labels}
    compare, state = prior_step_card_vs_cpu(torch, checkpoint, spec, ckpt + "_train", pcfg,
                                            batch, "prior")
    step_s = prior_step_seconds(torch, state, pcfg, batch, PRIOR_TIMED_STEPS)
    del state

    # the KV-cached decode against the kernel's forward, on the trained prior
    prior = cli_prior.load_prior(ckpt, spec, DEVICE)
    with torch.no_grad():
        forward = prior(codes[:4], labels[:4])
    cached = incremental_logits(prior, codes[:4], labels[:4])
    inc_err = float((cached - forward).abs().max())
    check(inc_err <= 1e-4, f"incremental_logits differ from the forward by {inc_err}")

    sampled = run_sample_cli(cli_prior, ["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt",
                                         ckpt + "_ema", *widths],
                             os.path.join(root, "prior", "samples"), "prior_sample", 4 * 28)
    served = serve_sample_requests(torch, serve, [
        "--device", DEVICE, "--ckpt-dir", vq_ckpt, "--dim", str(TRAIN_DIM),
        "--z-dim", str(TRAIN_CODES), "--prior-ckpt", ckpt, "--prior-arch", "transformer",
        "--prior-dim", str(PRIOR_DIM), "--prior-layers", str(PRIOR_LAYERS),
        "--prior-heads", str(PRIOR_HEADS)], counters, SAMPLE_REPEATS)
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


def prior_cfg(cfg):
    """The prior runs' train config: the CLI's lr and batch."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, initial_learning_rate=3e-4, batch_size=PRIOR_BATCH))


def prior_step_card_vs_cpu(torch, checkpoint, spec, train_dir: str, pcfg, batch: dict,
                           what: str, step: int | None = None,
                           bf16: bool = False) -> tuple[dict, object]:
    """One prior train step on the card and the same step on the CPU from
    the full state in ``train_dir`` (warm moments; its ``step``, else the
    latest) on the same ``batch``, in float32 or, with ``bf16``, in bf16;
    emits and checks the comparison, returns it and the card's state.

    TF32 is off: only the order of f32 sums differs (LayerNorm, matrix
    products, convolutions, the kernels' online softmax). The NLL within
    1e-5 relative, grad_norm within 1e-4; each parameter moves by about
    lr = 3e-4 per step, so the updated parameters agree to a small part of
    that (1e-4). A routed prior's routing decisions are compared too
    (``routing_flips``): every flip must be a near-tie or the cascade of
    one, and the limits above hold when none flipped (a flipped token runs
    another expert). In bf16 the routing rule holds with near-ties on the
    bf16 scale (BF16_ROUTE_GAP), and the loss terms agree within
    BF16_LOSS_REL (bf16 roundings of sums in another order)."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    states, metrics, routes = {}, {}, {}
    for device in (DEVICE, "cpu"):
        model = spec.build(dtype=torch.bfloat16 if bf16 else torch.float32).to(device)
        state = create_train_state(model, pcfg.train)
        checkpoint.restore(train_dir, state, step)
        with record_routing(torch, model) as routes[device]:
            _, m = make_train_step(model, pcfg)(state,
                                                {k: v.to(device) for k, v in batch.items()})
        states[device], metrics[device] = state, {k: float(v) for k, v in m.items()}
    rel = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
           for k in metrics["cpu"]}
    diff = (states[DEVICE].flat.flat.cpu() - states["cpu"].flat.flat).abs()
    compare = {"metrics_rel_err": rel, "params_max_abs_err": float(diff.max()),
               "params_beyond_1e-6_frac": float((diff > 1e-6).float().mean()),
               "grad_norm": metrics[DEVICE]["grad_norm"], "nll": metrics[DEVICE]["loss"],
               "from_step": checkpoint.latest_step(train_dir) if step is None else step,
               "dtype": "bf16" if bf16 else "f32"}
    if routes["cpu"]:
        compare["routing"] = routing_flips(torch, routes[DEVICE], routes["cpu"],
                                           BF16_ROUTE_GAP if bf16 else MOE_TIE_GAP)
    emit({"phase": f"{what}_card_vs_cpu_step", **compare})
    if routes["cpu"]:
        r = compare["routing"]
        check(r["flips"] == r["near_ties"] + r["cascade"],
              f"{what} card vs CPU: {r['flips'] - r['near_ties'] - r['cascade']} routing "
              f"flips that are neither near-ties nor cascades of one ({r})")
        if r["flips"]:
            return compare, states[DEVICE]
    if bf16:
        for k, v in rel.items():
            check(k == "grad_norm" or v <= BF16_LOSS_REL,
                  f"{what} bf16 card vs CPU: {k} differs by {v:.3g}")
        return compare, states[DEVICE]
    check(rel["loss"] <= 1e-5, f"{what} card vs CPU: NLL differs by {rel['loss']:.3g}")
    check(rel["grad_norm"] <= 1e-4,
          f"{what} card vs CPU: grad_norm differs by {rel['grad_norm']:.3g}")
    check(float(diff.max()) <= 1e-4,
          f"{what} card vs CPU: parameters differ by {float(diff.max())}")
    return compare, states[DEVICE]


def prior_step_seconds(torch, state, pcfg, batch: dict, steps: int) -> float:
    """Seconds per train step with a device-resident batch, after 5 warm-up
    steps; the state's model trains on."""
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    step = make_train_step(state.model, pcfg)
    for _ in range(5):
        step(state, batch)
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(steps):
        step(state, batch)
    sync(torch)
    return (time.perf_counter() - t0) / steps


def run_sample_cli(cli_prior, argv: list, out: str, stem: str, frames: int, n: int = 4) -> dict:
    """``cli.prior sample`` (``argv`` plus the output directory and n)
    writes n finite WAVs of the decoded length (``frames`` mel frames, one
    hop fewer samples); the CLI's default --code-shape is 20 x 28."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_prior.main(argv + ["--output-dir", out, "--num-samples", str(n)])
    seconds = time.perf_counter() - t0
    names = sorted(os.listdir(out))
    check(names == [f"{stem}_{i:03d}.wav" for i in range(n)], f"sample wrote {names}")
    sr, hop = 22050, 256
    for name in names:
        with open(os.path.join(out, name), "rb") as f:
            wav = read_wav(f.read(), sr)
        check(len(wav) == hop * (frames - 1), f"{name}: {len(wav)} samples")
    return {"num_samples": n, "mel_frames": frames, "seconds": seconds}


def serve_sample_requests(torch, serve, argv: list, counters, repeats: int) -> dict:
    """The server of ``argv`` answers /sample at n = 1 and n = 4 with
    finite audio of the decoded length; p50 over ``repeats`` requests after
    a warm-up, launch counts over the requests."""
    service = serve.build_service(serve.parse_args(argv))
    sr, hop = service.cfg.audio.sample_rate, service.cfg.audio.effective_hop_size
    frames = service.frames
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
    lat: dict = {}
    for k in counters:
        k.reset_launch_count()
    try:
        for n in (1, 4):
            for i in range(1 + repeats):
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
    stride = 2 * service.STRIDE if service.hier else service.STRIDE
    return {"code_grid": [service.cfg.audio.num_mels // stride, frames // stride],
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
    """The CLI's default vocoder at full width (WN_SERVE_LAYERS deep) from
    a seeded-init artifact:
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
    depth = ["--layers", str(WN_SERVE_LAYERS), "--stacks", str(WN_SERVE_STACKS)]
    model = cli_vocoder.build_model(
        cfg, types.SimpleNamespace(residual_channels=None, layers=WN_SERVE_LAYERS,
                                   stacks=WN_SERVE_STACKS),
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
    checkpoint.save_params(ckpt, model, 0, cli_vocoder._condition_meta(types.SimpleNamespace()))
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
                          out_path, "--max-frames", str(WN_SYNTH_FRAMES), "--device", DEVICE,
                          *depth])
    synth_s = time.perf_counter() - t0
    with open(out_path, "rb") as f:
        synth_wav = read_wav(f.read(), sr)
    check(len(synth_wav) == WN_SYNTH_FRAMES * hop, f"synthesize: {len(synth_wav)} samples")
    synth = {"frames": WN_SYNTH_FRAMES, "samples": len(synth_wav), "seconds": synth_s,
             "ms_per_sample": 1e3 * synth_s / len(synth_wav),
             "kernel_launches": wavenet_gen.launch_counts()}

    base = ["--device", DEVICE, "--ckpt-dir", vq_ckpt, "--dim", str(TRAIN_DIM), "--z-dim",
            str(TRAIN_CODES), "--frames", str(WN_SERVE_FRAMES), "--vocoder", "wavenet",
            "--vocoder-ckpt", ckpt, "--vocoder-layers", str(WN_SERVE_LAYERS),
            "--vocoder-stacks", str(WN_SERVE_STACKS)]
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


# ---------------------------------------------------------------------------
# Phase 11: the other autoencoders (HierVQVAE, WaveVQVAE, VAE)
# ---------------------------------------------------------------------------


def other_argv(model: str, out: str, datadir: str, dataset: str = "ljspeech",
               z_dim: int | None = None) -> list:
    """``cli.main``'s arguments at the training phase's full width (dim 256,
    512 codes unless ``z_dim``, batch 64, BATCHES_PER_EPOCH batches an
    epoch), less --epochs; the checkpoints and samples under ``out``."""
    return ["--model", model, "--dataset", dataset, "--datadir", datadir,
            "--dim", str(TRAIN_DIM), "--z-dim", str(z_dim or TRAIN_CODES),
            "--batch-size", str(TRAIN_BATCH),
            "--max-batches-per-epoch", str(BATCHES_PER_EPOCH), "--log-interval", "1",
            "--device", DEVICE, "--ckpt-dir", os.path.join(out, "models"),
            "--sampledir", os.path.join(out, "results")]


def check_run(run: dict, tag: str, epochs: int, want_vq: int) -> int:
    """A ``run_cli_main`` record: its epochs and evals, fused_adam once per
    optimizer step, vq_nearest ``want_vq`` times, the loss finite and
    falling. Returns the optimizer steps."""
    steps = epochs * BATCHES_PER_EPOCH
    check(run["epochs_logged"] == epochs and run["evals"] == epochs,
          f"{tag}: {run['epochs_logged']} epochs and {run['evals']} evals, expected {epochs}")
    check(run["launches"]["fused_adam"] == steps,
          f"{tag}: fused_adam launched {run['launches']['fused_adam']} times for {steps} steps")
    check(run["launches"]["vq_kernel"] == want_vq,
          f"{tag}: vq_nearest launched {run['launches']['vq_kernel']} times, expected {want_vq}")
    losses = run["losses"]
    check(len(losses) == steps and all(np.isfinite(losses)), f"{tag}: losses {losses}")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall ({losses[0]} -> {losses[-1]})")
    run.update(optimizer_steps=steps, vq_launches_expected=want_vq, first_loss=losses[0],
               last_loss=losses[-1], steps_per_s_cli=steps / run["seconds"])
    return steps


def run_record(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "losses"}


def timed_steps_per_s(torch, model, cfg, batch, ema_codebook: bool = False) -> float:
    """Train steps/s of a seeded model with a device-resident batch (the
    step's generator draws the VAE's noise and the dead-code restarts)."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    state = create_train_state(model, cfg.train, ema_codebook=ema_codebook)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    on_device = {k: torch.from_numpy(np.asarray(v)).to(DEVICE) for k, v in batch.items()
                 if v is not None}
    for _ in range(3):
        step(state, on_device, gen)
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(OTHER_TIMED_STEPS):
        step(state, on_device, gen)
    sync(torch)
    return OTHER_TIMED_STEPS / (time.perf_counter() - t0)


def level_flips(torch, z_cpu, z_card, codebook, cpu_codes, card_codes, cascade=None) -> dict:
    """The card-vs-CPU code flips of one VQ level (``rvq_flip_causes`` on a
    single stage): z (..., D), codes of z's leading shape, ``codebook`` (K,
    D). Rows marked in ``cascade`` (a flattened bool mask) follow an earlier
    flip and are counted apart, not held to the near-tie rule."""
    d = codebook.shape[-1]
    cpu_c, card_c = cpu_codes.reshape(1, -1).long(), card_codes.reshape(1, -1).long()
    flips = int((cpu_c != card_c).sum())
    cascaded = 0
    if cascade is not None:
        cascaded = int((cascade & (cpu_c[0] != card_c[0])).sum())
        card_c = torch.where(cascade[None], cpu_c, card_c)
    causes = rvq_flip_causes(torch, z_cpu.reshape(-1, d), z_card.reshape(-1, d),
                             codebook[None].double(), cpu_c, card_c)
    return {"flips": flips, "cascaded": cascaded, "rows": int(cpu_c.shape[1]), **causes}


def bottom_cascade(torch, top_flipped, radius: int | None):
    """Bottom-grid rows that a top flip reaches: with ``radius`` the bottom
    positions within ``radius`` top positions of a flip in the same window
    (eval mode: the decoded top's 3x3 ResBlock and 4x4 transpose conv reach
    two top positions); with None every row of the batch once any top code
    flipped (train mode: the flip moves the batch's BatchNorm statistics)."""
    b, h, w = top_flipped.shape
    if radius is None:
        return torch.full((b * 2 * h * 2 * w,), bool(top_flipped.any()), dtype=torch.bool)
    near = torch.nn.functional.max_pool2d(top_flipped.float()[:, None], 2 * radius + 1,
                                          stride=1, padding=radius)[:, 0] > 0
    return near.repeat_interleave(2, 1).repeat_interleave(2, 2).reshape(-1)


def quantization_error_part(torch, z, codebook, cpu_codes, card_codes, rows) -> float:
    """What the flipped ``rows`` change in mean((z_q - z_e)^2) under the
    card's codes rather than the CPU's: float64, from the CPU's z_e and the
    pre-step codebook."""
    d = codebook.shape[-1]
    z64 = z.reshape(-1, d).double()[rows]
    cb = codebook.double()

    def err(codes):
        return float(((cb[codes.reshape(-1).long()[rows]] - z64) ** 2).sum())

    return (err(card_codes) - err(cpu_codes)) / z.numel()


# the no-flip grad_norm limit of the hier card-vs-CPU step follows the
# state's own conditioning: max(1e-5, HIER_SPREAD_C * s), s the relative
# change of the CPU's grad_norm when the same step runs on
# HIER_SPREAD_THREADS threads (another order of every float32 sum). C is
# 2.6 times the largest card-gap / s ratio that
# scripts/torch_hier_grad_probe.py --rule read on an H100 over seeds 1-28
# (7.6, seed 6, among the 19 states without a flip; PERF.md has the seeds)
HIER_SPREAD_THREADS = 1
HIER_SPREAD_C = 20.0


def cpu_step_grad_norm(torch, cli_main, checkpoint, cfg, ckpt: str, batch, threads: int) -> float:
    """The grad_norm of one f32 train step on the CPU at ``threads``
    threads from a checkpoint and batch."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        model = cli_main.make_model(cfg)
        state = create_train_state(model, cfg.train)
        checkpoint.restore(ckpt, state)
        _, m = make_train_step(model, cfg)(state, {"x": torch.from_numpy(batch["x"])})
        return float(m["grad_norm"])
    finally:
        torch.set_num_threads(saved)


def hier_card_vs_cpu(torch, cli_main, checkpoint, cfg, ckpt: str, batch) -> tuple[dict, dict]:
    """One f32 HierVQVAE train step on the card and on the CPU from the same
    checkpoint and batch (gradient codebooks). Each level's codes (train
    mode, statistics discarded) are compared as the RVQ step's are: every
    top flip and every bottom flip that no top flip explains is a near-tie
    between the devices' z_e. A top flip moves the batch's decoded top, so
    in train mode every bottom flip of that step counts as its cascade, and
    only the top's loss terms are then held; without one the loss terms are
    held to 1e-5 once the bottom flips' quantization error is taken out.
    Returns (the record, the card's z_e and codebooks of both levels)."""
    from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    states, metrics, levels, books = {}, {}, {}, {}
    for device in (DEVICE, "cpu"):
        model = cli_main.make_model(cfg).to(device)
        state = create_train_state(model, cfg.train)
        checkpoint.restore(ckpt, state)
        x = torch.from_numpy(batch["x"]).to(device)
        with torch.no_grad(), batch_stats_discarded(model):
            model.train()
            top, bottom = model.levels(x)
            levels[device] = (top[1], top[3], bottom[1], bottom[3])
        books[device] = (model.codebook_top.detach().clone(),
                         model.codebook_bottom.detach().clone())  # before the step
        _, m = make_train_step(model, cfg)(state, {"x": x})
        states[device], metrics[device] = state, {k: float(v) for k, v in m.items()}
    card_levels = levels[DEVICE]
    zt, it, zb, ib = (t.cpu() for t in levels["cpu"])
    zt_a, it_a, zb_a, ib_a = (t.cpu() for t in card_levels)
    cb_t, cb_b = (b.cpu() for b in books["cpu"])
    top_flipped = it != it_a
    top = level_flips(torch, zt, zt_a, cb_t, it, it_a)
    cascade = bottom_cascade(torch, top_flipped, None)
    bot = level_flips(torch, zb, zb_a, cb_b, ib, ib_a, cascade)
    beta = cfg.model.beta
    part_t = quantization_error_part(torch, zt, cb_t, it, it_a, top_flipped.reshape(-1))
    part_b = quantization_error_part(torch, zb, cb_b, ib, ib_a,
                                     (ib != ib_a).reshape(-1) & ~cascade)
    explained = {"loss_vq_top": part_t, "loss_commit_top": part_t,
                 "loss_vq_bottom": part_b, "loss_commit_bottom": part_b,
                 "loss_vq": part_t + part_b, "loss_commit": part_t + part_b,
                 "train_loss": part_t + part_b, "loss": (1 + beta) * (part_t + part_b)}
    cpu_m, card_m = metrics["cpu"], metrics[DEVICE]
    rel = {k: abs(card_m[k] - cpu_m[k]) / abs(cpu_m[k]) for k in cpu_m}
    rest = {k: abs(card_m[k] - cpu_m[k] - explained.get(k, 0.0)) / abs(cpu_m[k]) for k in cpu_m}
    diff = (states[DEVICE].flat.flat.cpu() - states["cpu"].flat.flat).abs()
    record = {"metrics_rel_err": rel, "metrics_rel_err_rest": rest, "top": top, "bottom": bot,
              "params_beyond_1e-5_frac": float((diff > 1e-5).float().mean()),
              "params_max_abs_err": float(diff.max()),
              "z_e_top_max_abs_err": float((zt_a - zt).abs().max()),
              "z_e_bottom_max_abs_err": float((zb_a - zb).abs().max()),
              "z_e_bottom_cpu_rows": identical_rows(torch, zb),
              "grad_norm": card_m["grad_norm"], "loss": card_m["loss"]}
    for name, level in (("top", top), ("bottom", bot)):
        check(level["flips_not_near_ties"] == 0,
              f"hier card vs CPU: {level['flips_not_near_ties']} {name} flips are not near-ties")
        check(level["flipped_vectors"] <= 1e-3 * level["rows"],
              f"hier card vs CPU: {level['flipped_vectors']} {name} vectors flipped")
    held = ("loss_vq_top", "loss_commit_top") if top["flips"] else tuple(
        k for k in cpu_m if k != "grad_norm")
    check(max(rest[k] for k in held) <= 1e-5,
          f"hier card vs CPU train step: loss terms differ {rel}, {rest} beyond the flips")
    if not top["flips"]:
        flips = bot["flips"]
        limit = 2e-3 if flips else 1e-5
        if not flips and rel["grad_norm"] > limit:
            # beyond the floor: the limit follows this state's order spread
            spread = abs(cpu_step_grad_norm(torch, cli_main, checkpoint, cfg, ckpt, batch,
                                            HIER_SPREAD_THREADS)
                         - cpu_m["grad_norm"]) / cpu_m["grad_norm"]
            limit = max(limit, HIER_SPREAD_C * spread)
            record["grad_norm_spread"] = spread
        record["grad_norm_limit"] = limit
        check(rel["grad_norm"] <= limit,
              f"hier card vs CPU train step: grad_norm differs by {rel['grad_norm']:.3g} "
              f"(limit {limit:.3g})")
        check(record["params_beyond_1e-5_frac"] <= 1e-3 and float(diff.max()) <= 1e-2,
              f"hier card vs CPU train step: parameters differ {record}")
    z = {"hier_top": (card_levels[0], books[DEVICE][0]),
         "hier_bottom": (card_levels[2], books[DEVICE][1])}
    return record, z


def hier_serve(torch, serve, vq_kernel, ckpt: str) -> dict:
    """``cli.serve --model hiervqvae`` from the checkpoint (its 80-frame
    default): /encode, /decode and /reconstruct of 1 s and 8 s chirps
    answer 200 with finite audio of the right length and both grids
    aligned; vq_nearest's launches over the requests alone (two per /encode
    and per /reconstruct: the top and the bottom search); the card's codes
    against the same model on the CPU on the same windows (mismatches only
    at near-ties, or at bottom positions within reach of a flipped top
    code); p50 over HIER_SERVE_REPEATS requests after a warm-up."""
    from neural_sound_generation_tpu_torch.models import HierVQVAE

    args = serve.parse_args(["--device", DEVICE, "--model", "hiervqvae", "--ckpt-dir", ckpt,
                             "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES)])
    check(args.frames == 80, f"serve --model hiervqvae: --frames defaults to {args.frames}")
    service = serve.build_service(args)
    cfg = service.cfg.audio
    sr, hop = cfg.sample_rate, cfg.effective_hop_size
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    lat: dict = {}
    outs = {}
    vq_kernel.reset_launch_count()
    try:
        for rep in range(1 + HIER_SERVE_REPEATS):
            for seconds in HIER_CHIRP_SECONDS:
                wav_bytes, n = chirp_wav_bytes(seconds, sr)
                t = service._wav_to_mel(wav_bytes)[1]
                status, body, dt_enc = request(base + "/encode", wav_bytes)
                check(status == 200, f"hier /encode {seconds}s: {status} {body[:200]!r}")
                enc = json.loads(body)
                top, bottom = np.asarray(enc["codes_top"]), np.asarray(enc["codes_bottom"])
                want_top = [cfg.num_mels // 8, -(-t // 8)]
                check(enc["shape_top"] == want_top == list(top.shape)
                      and enc["shape_bottom"] == [cfg.num_mels // 4, 2 * want_top[1]]
                      == list(bottom.shape),
                      f"hier /encode {seconds}s: grids {enc['shape_top']} {enc['shape_bottom']}")
                status, body, dt_dec = request(base + "/decode", json.dumps(
                    {"codes_top": enc["codes_top"], "codes_bottom": enc["codes_bottom"]}).encode())
                check(status == 200, f"hier /decode {seconds}s: {status} {body[:200]!r}")
                dec = read_wav(body, sr)
                want_len = hop * (8 * top.shape[1] - 1)
                check(len(dec) == want_len,
                      f"hier /decode {seconds}s: {len(dec)} samples, expected {want_len}")
                status, body, dt_rec = request(base + "/reconstruct", wav_bytes)
                check(status == 200, f"hier /reconstruct {seconds}s: {status} {body[:200]!r}")
                check(len(read_wav(body, sr)) == n, f"hier /reconstruct {seconds}s: length")
                if rep:
                    for path, dt in (("/encode", dt_enc), ("/decode", dt_dec),
                                     ("/reconstruct", dt_rec)):
                        lat.setdefault(f"{path}@{seconds:g}s", []).append(1e3 * dt)
                outs[seconds] = (wav_bytes, enc, t)
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = vq_kernel.launch_count()
    want = 2 * 2 * len(HIER_CHIRP_SECONDS) * (1 + HIER_SERVE_REPEATS)
    check(launches == want, f"hier serving launched vq_nearest {launches} times, expected {want}")

    ref = HierVQVAE(1, args.dim, args.z_dim)
    ref.load_state_dict({k: v.cpu() for k, v in service.model.state_dict().items()})
    ref.eval()
    compare = {}
    with torch.inference_mode():
        for seconds, (wav_bytes, enc, _) in outs.items():
            padded, _ = service._pad_for_reconstruct(wav_bytes)
            wav = service._reconstruct_wav(torch.from_numpy(padded).to(DEVICE)[None])
            top = torch.from_numpy(np.asarray(enc["codes_top"])).to(DEVICE)[None]
            bottom = torch.from_numpy(np.asarray(enc["codes_bottom"])).to(DEVICE)[None]
            dec = service._vocode(service.model.decode(top, bottom)[0, :, :, 0])
            check(bool(torch.isfinite(wav).all()) and bool(torch.isfinite(dec).all()),
                  f"hier {seconds}s: non-finite /reconstruct or /decode waveform")
            windows, t, n_win = service._wav_to_mel(wav_bytes)
            card_t, card_b = service.model.levels(windows)
            cpu_t, cpu_b = ref.levels(windows.cpu())
            stitched = service._stitch(card_t[3][:n_win].cpu().numpy(), t, 8)
            check(np.array_equal(stitched, np.asarray(enc["codes_top"])),
                  f"hier /encode {seconds}s: codes differ from the service's own windows")
            top_flipped = cpu_t[3] != card_t[3].cpu()
            cb_t = ref.codebook_top.detach()
            cb_b = ref.codebook_bottom.detach()
            lt = level_flips(torch, cpu_t[1], card_t[1].cpu(), cb_t, cpu_t[3], card_t[3].cpu())
            lb = level_flips(torch, cpu_b[1], card_b[1].cpu(), cb_b, cpu_b[3], card_b[3].cpu(),
                             bottom_cascade(torch, top_flipped, 2))
            for name, level in (("top", lt), ("bottom", lb)):
                check(level["flips_not_near_ties"] == 0,
                      f"hier serving {seconds}s: {level['flips_not_near_ties']} {name} code "
                      f"flips card vs CPU are not near-ties")
            compare[f"{seconds:g}s"] = {"top": lt, "bottom": lb}
    return {"frames": args.frames, "vq_launches": launches, "vq_launches_expected": want,
            "latency_ms": {k: {"n": len(v), "p50": float(np.percentile(v, 50))}
                           for k, v in sorted(lat.items())},
            "card_vs_cpu_codes": compare}


def hier_part(torch, cli_main, cli_evaluate, serve, checkpoint, vq_kernel, fused_adam,
              root: str, corpus: str) -> tuple[dict, dict]:
    """``cli.main --model hiervqvae --codebook-init data`` at full width,
    ``cli.evaluate`` and ``cli.serve`` on its checkpoint, one step card vs
    CPU, steps/s."""
    t0 = time.perf_counter()
    out = os.path.join(root, "hier")
    argv = other_argv("hiervqvae", out, corpus) + ["--codebook-init", "data"]
    run = run_cli_main(cli_main, (vq_kernel, fused_adam),
                       argv + ["--epochs", str(OTHER_EPOCHS)])
    # the data init's two train-mode passes each search the top and the
    # bottom grid (4); a step searches both in its forward (2); an eval
    # batch in the forward and in encode (4), one eval batch an epoch
    steps = OTHER_EPOCHS * BATCHES_PER_EPOCH
    check_run(run, "hiervqvae", OTHER_EPOCHS, 4 + 2 * steps + 4 * OTHER_EPOCHS)
    ckpt = os.path.join(out, "models", "hiervqvae",
                        f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    extra = checkpoint.read_extra(ckpt)
    check(extra == {"epoch": OTHER_EPOCHS, "arch": "hiervqvae", "num_quantizers": 1,
                    "num_downsample": 6}, f"hiervqvae: checkpoint metadata {extra}")
    with contextlib.redirect_stdout(io.StringIO()):
        evaluated = cli_evaluate.main([
            "--model", "hiervqvae", "--datadir", corpus, "--ckpt-dir", ckpt,
            "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES),
            "--batch-size", str(TRAIN_BATCH), "--max-batches", "1", "--device", DEVICE])
    check(np.isfinite(evaluated["loss"]) and evaluated["perplexity_top"] >= 1.0
          and evaluated["perplexity"] >= 1.0, f"cli.evaluate --model hiervqvae: {evaluated}")
    args = cli_main.parse_args(argv + ["--epochs", "1"])
    cfg = cli_main.build_config(args)
    batch = next(iter(cli_main.audio_loaders(args, cfg)[0]))
    crop = tuple(batch["x"].shape)
    check(crop == (TRAIN_BATCH, 80, 24, 1), f"hiervqvae: batches of {crop}, expected 80 x 24")
    step, z = hier_card_vs_cpu(torch, cli_main, checkpoint, cfg, ckpt, batch)
    emit({"phase": "hier_card_vs_cpu_step", **step})
    served = hier_serve(torch, serve, vq_kernel, ckpt)
    steps_per_s = timed_steps_per_s(
        torch, cli_main.make_model(cfg, generator=torch.Generator().manual_seed(SEED)).to(DEVICE),
        cfg, {"x": batch["x"]})
    return {"phase": "other_autoencoders_hiervqvae", "dim": TRAIN_DIM, "codes": TRAIN_CODES,
            "batch": TRAIN_BATCH, "crop": list(crop[1:3]), "run": run_record(run),
            "evaluate": evaluated, "card_vs_cpu_step": step, "served": served,
            "train_steps_per_s": steps_per_s, "timed_steps": OTHER_TIMED_STEPS,
            "seconds": time.perf_counter() - t0}, z


def mulaw_corpus(torch, dsp, corpus: str, out: str, channels: int) -> str:
    """The chirp corpus with its audio as mu-law integers (``channels``
    levels, as preprocessing writes a mulaw-quantize corpus); mels as they
    were."""
    from neural_sound_generation_tpu_torch.data.manifest import read_manifest, write_manifest

    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    entries = read_manifest(corpus)
    for e in entries:
        wav = torch.from_numpy(np.load(os.path.join(corpus, e.audio_path)))
        np.save(os.path.join(out, e.audio_path),
                dsp.mulaw_quantize(wav, channels).numpy().astype(np.int16))
        shutil.copy(os.path.join(corpus, e.mel_path), os.path.join(out, e.mel_path))
    write_manifest(out, entries)
    return out


def wave_part(torch, cli_main, dsp, checkpoint, vq_kernel, fused_adam, root: str,
              corpus: str) -> tuple[dict, dict]:
    """``cli.main --model wavevqvae`` at full width: raw input with EMA
    codebooks, restarts and data init for OTHER_EPOCHS, then mulaw-quantize
    (256 levels, from a preset) with 2 residual stages for one epoch; one
    raw step card vs CPU; steps/s."""
    from neural_sound_generation_tpu_torch.training import trainer

    t0 = time.perf_counter()
    out = os.path.join(root, "wave")
    argv = other_argv("wavevqvae", out, corpus) + [
        "--num-downsample", str(WAVE_DOWNSAMPLE), "--ema-codebook",
        "--restart-dead-threshold", "1.0", "--codebook-init", "data"]
    run = run_cli_main(cli_main, (vq_kernel, fused_adam),
                       argv + ["--epochs", str(OTHER_EPOCHS)])
    # data init seeds one codebook without a search; a step searches in its
    # forward and in the EMA branch (2); an eval batch in the forward and in
    # encode (2)
    steps = OTHER_EPOCHS * BATCHES_PER_EPOCH
    check_run(run, "wavevqvae raw", OTHER_EPOCHS, 2 * steps + 2 * OTHER_EPOCHS)
    ckpt = os.path.join(out, "models", "wavevqvae",
                        f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    extra = checkpoint.read_extra(ckpt)
    check(extra == {"epoch": OTHER_EPOCHS, "arch": "wavevqvae", "num_quantizers": 1,
                    "num_downsample": WAVE_DOWNSAMPLE}, f"wavevqvae raw: checkpoint {extra}")
    args = cli_main.parse_args(argv + ["--epochs", "1"])
    cfg = cli_main.build_config(args)
    batch = next(iter(cli_main.audio_loaders(args, cfg)[0]))
    crop = tuple(batch["x"].shape)
    check(crop == (TRAIN_BATCH, 7168, 1), f"wavevqvae: batches of {crop}, expected 7168 samples")
    step = rvq_card_vs_cpu(torch, cli_main, checkpoint, trainer, cfg, ckpt, batch, torch.float32,
                           encode=lambda m, x: m.encode_latents(x))
    emit({"phase": "wave_card_vs_cpu_step", **step})
    check_ema_step(step, "wavevqvae raw", WAVE_NO_FLIP_GRAD_REL)
    from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded

    model = cli_main.make_model(cfg).to(DEVICE)
    checkpoint.restore_params(ckpt, model)
    model.train()  # the z_e training quantizes
    with torch.no_grad(), batch_stats_discarded(model):
        z = {"wave_units": (model.encode_latents(torch.from_numpy(batch["x"]).to(DEVICE)),
                            model.codebook.detach())}
    steps_per_s = timed_steps_per_s(
        torch, cli_main.make_model(cfg, generator=torch.Generator().manual_seed(SEED)).to(DEVICE),
        cfg, {"x": batch["x"]}, ema_codebook=True)

    mu_corpus = mulaw_corpus(torch, dsp, corpus, os.path.join(root, "corpus_mulaw"), 256)
    preset = os.path.join(root, "mulaw_quantize.json")
    with open(preset, "w", encoding="utf-8") as f:
        json.dump({"input_type": "mulaw-quantize", "quantize_channels": 256}, f)
    mu_out = os.path.join(root, "wave_mulaw")
    mu_run = run_cli_main(cli_main, (vq_kernel, fused_adam), other_argv(
        "wavevqvae", mu_out, mu_corpus) + [
        "--preset", preset, "--num-quantizers", "2", "--num-downsample", str(WAVE_DOWNSAMPLE),
        "--codebook-init", "data", "--epochs", "1"])
    # data init: one search to seed the second stage from the first's
    # residual; a step: one search a stage (2); an eval batch: 2 + 2
    check_run(mu_run, "wavevqvae mulaw-quantize RVQ", 1, 1 + 2 * BATCHES_PER_EPOCH + 4)
    mu_ckpt = os.path.join(mu_out, "models", "wavevqvae",
                           f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    extra = checkpoint.read_extra(mu_ckpt)
    check(extra == {"epoch": 1, "arch": "wavevqvae", "num_quantizers": 2,
                    "num_downsample": WAVE_DOWNSAMPLE}, f"wavevqvae mulaw: checkpoint {extra}")
    saved = torch.load(os.path.join(mu_ckpt, f"step_{BATCHES_PER_EPOCH}", "state.pt"),
                       weights_only=True)
    shapes = {k: tuple(saved[f"params/{k}"].shape) for k in ("codebook", "decoder.out.weight")}
    check(shapes == {"codebook": (2, TRAIN_CODES, TRAIN_DIM),
                     "decoder.out.weight": (TRAIN_DIM, 256, 4)},
          f"wavevqvae mulaw: checkpoint shapes {shapes}")
    del saved
    return {"phase": "other_autoencoders_wavevqvae", "dim": TRAIN_DIM, "codes": TRAIN_CODES,
            "batch": TRAIN_BATCH, "crop_samples": crop[1], "num_downsample": WAVE_DOWNSAMPLE,
            "raw": run_record(run), "mulaw_quantize_rvq2": run_record(mu_run),
            "card_vs_cpu_step": step, "train_steps_per_s_raw_ema": steps_per_s,
            "timed_steps": OTHER_TIMED_STEPS, "seconds": time.perf_counter() - t0}, z


def stroke_images(rng, n: int, size: int) -> np.ndarray:
    """(n, size, size) uint8 images of 2-4 random straight strokes, 2-3
    pixels wide: structure for a VAE to learn."""
    imgs = np.zeros((n, size, size), np.float32)
    yy, xx = np.mgrid[:size, :size]
    for img in imgs:
        for _ in range(rng.integers(2, 5)):
            (y0, x0), (y1, x1) = rng.uniform(3, size - 3, (2, 2))
            t = np.clip(((yy - y0) * (y1 - y0) + (xx - x0) * (x1 - x0))
                        / max((y1 - y0) ** 2 + (x1 - x0) ** 2, 1e-6), 0, 1)
            dist = np.hypot(yy - y0 - t * (y1 - y0), xx - x0 - t * (x1 - x0))
            img[dist <= rng.uniform(1.0, 1.5)] = 1.0
    return (255 * imgs).astype(np.uint8)


def write_mnist(root: str) -> str:
    """MNIST in the idx format (train-* and t10k-*), stroke images."""
    os.makedirs(root)
    rng = np.random.default_rng(SEED)
    for prefix, n in (("train", MNIST_IMAGES[0]), ("t10k", MNIST_IMAGES[1])):
        imgs = stroke_images(rng, n, 28)
        with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write(np.array([2051, n, 28, 28], ">u4").tobytes() + imgs.tobytes())
        with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
            f.write(np.array([2049, n], ">u4").tobytes()
                    + rng.integers(0, 10, n).astype(np.uint8).tobytes())
    return root


def write_cifar(root: str) -> str:
    """CIFAR-10 as its pickle batches (data_batch_1, test_batch), stroke
    images in three tinted channels."""
    import pickle

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.default_rng(SEED + 1)
    for name, n in (("data_batch_1", CIFAR_IMAGES[0]), ("test_batch", CIFAR_IMAGES[1])):
        strokes = stroke_images(rng, n, 32).astype(np.float32)
        tint = rng.uniform(0.3, 1.0, (n, 3, 1, 1))
        data = (strokes[:, None] * tint).astype(np.uint8).reshape(n, 3072)
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": data, b"labels": rng.integers(0, 10, n).tolist()}, f)
    return root


def vae_part(torch, cli_main, checkpoint, vq_kernel, fused_adam, root: str) -> dict:
    """``cli.main --model vae`` at dim 256, 128 latents: OTHER_EPOCHS on an
    idx-format MNIST of stroke images, one epoch on a CIFAR-10 pickle batch
    (3 channels); fused_adam once a step, no nearest-code search; steps/s."""
    t0 = time.perf_counter()
    runs, ckpts = {}, {}
    for dataset, epochs, write in (("MNIST", OTHER_EPOCHS, write_mnist),
                                   ("CIFAR10", 1, write_cifar)):
        datadir = write(os.path.join(root, dataset.lower()))
        out = os.path.join(root, f"vae_{dataset.lower()}")
        argv = other_argv("vae", out, datadir, dataset, VAE_Z)
        run = run_cli_main(cli_main, (vq_kernel, fused_adam), argv + ["--epochs", str(epochs)])
        check_run(run, f"vae {dataset}", epochs, 0)
        ckpts[dataset] = os.path.join(out, "models", "vae",
                                      f"checkpoint_{dataset}_{TRAIN_DIM}_{VAE_Z}")
        extra = checkpoint.read_extra(ckpts[dataset])
        check(extra is not None and extra["arch"] == "vae" and extra["epoch"] == epochs,
              f"vae {dataset}: checkpoint metadata {extra}")
        runs[dataset] = run_record(run)
    saved = torch.load(os.path.join(ckpts["CIFAR10"], f"step_{BATCHES_PER_EPOCH}", "state.pt"),
                       weights_only=True)
    conv0 = tuple(saved["params/Conv_0.weight"].shape)
    check(conv0 == (TRAIN_DIM, 3, 4, 4), f"vae CIFAR10: Conv_0 {conv0}, expected 3 channels")
    del saved
    args = cli_main.parse_args(other_argv("vae", root, os.path.join(root, "mnist"), "MNIST",
                                          VAE_Z) + ["--epochs", "1"])
    cfg = cli_main.build_config(args)
    batch = next(cli_main.image_loaders(args)[0](1))
    steps_per_s = timed_steps_per_s(
        torch, cli_main.make_model(cfg, generator=torch.Generator().manual_seed(SEED)).to(DEVICE),
        cfg, {"x": batch["x"]})
    return {"phase": "other_autoencoders_vae", "dim": TRAIN_DIM, "z_dim": VAE_Z,
            "batch": TRAIN_BATCH, "images": {"MNIST": MNIST_IMAGES, "CIFAR10": CIFAR_IMAGES},
            "runs": runs, "train_steps_per_s_mnist": steps_per_s,
            "timed_steps": OTHER_TIMED_STEPS, "seconds": time.perf_counter() - t0}


def vq_other_shapes(torch, vq_kernel, sources: dict) -> dict:
    """vq_nearest against its plain version at the shapes the new paths
    give it, on z_e of the trained models (``compare_vq``: mismatches only
    at near-ties, bit-identical over two calls, CTAs covering the SMs,
    device-only times beside cdist+argmin's)."""
    rows = {}
    for name, (z, codebook) in sources.items():
        x = z.reshape(-1, z.shape[-1]).contiguous()
        cb = codebook.contiguous()
        want = OTHER_VQ_SHAPES[name]
        check(tuple(x.shape) + (cb.shape[0],) == (want[0], want[2], want[1]),
              f"vq_nearest {name}: ({tuple(x.shape)}, {tuple(cb.shape)}), expected {want}")
        row = compare_vq(torch, vq_kernel, x, cb)
        row["shape_of"] = name
        emit(row)
        check(row["mismatches"] == row["near_ties"],
              f"vq_nearest {name}: {row['mismatches'] - row['near_ties']} mismatches that are "
              f"not near-ties")
        check(row["run_to_run_identical"], f"vq_nearest {name}: two calls differ")
        check(row["ctas"] >= row["sms"], f"vq_nearest {name}: {row['ctas']} CTAs")
        rows[name] = row
    return rows


def other_autoencoders_phase(torch, cli_main, cli_evaluate, serve, checkpoint, dsp, vq_kernel,
                             fused_adam, root: str, corpus: str, card: str) -> dict:
    """Phase 11: the HierVQVAE, WaveVQVAE and VAE paths at full width, then
    the nearest-code kernel at their shapes. One record line a part."""
    t0 = time.perf_counter()
    hier, hier_z = hier_part(torch, cli_main, cli_evaluate, serve, checkpoint, vq_kernel,
                             fused_adam, root, corpus)
    hier["card"] = card
    emit(hier)
    wave, wave_z = wave_part(torch, cli_main, dsp, checkpoint, vq_kernel, fused_adam, root,
                             corpus)
    wave["card"] = card
    emit(wave)
    vae = vae_part(torch, cli_main, checkpoint, vq_kernel, fused_adam, root)
    vae["card"] = card
    emit(vae)
    t_kernel = time.perf_counter()
    rows = vq_other_shapes(torch, vq_kernel, {**hier_z, **wave_z})
    kernel = {"phase": "other_autoencoders_vq_shapes", "card": card,
              "seconds": time.perf_counter() - t_kernel,
              "rows": {name: {k: r[k] for k in ("n", "k", "d", "kernel_device_ms", "kernel_ms",
                                                "plain_ms", "bound_ms", "bound_by",
                                                "library_ms", "library_device_ms",
                                                "mismatches", "near_ties", "split", "ctas")}
                       for name, r in rows.items()}}
    emit(kernel)
    runs = [hier["run"], wave["raw"], wave["mulaw_quantize_rvq2"], *vae["runs"].values()]
    return {"phase": "other_autoencoders", "card": card, "seconds": time.perf_counter() - t0,
            "parts_seconds": {"hiervqvae": hier["seconds"], "wavevqvae": wave["seconds"],
                              "vae": vae["seconds"], "vq_shapes": kernel["seconds"]},
            "vq_launches": (sum(r["launches"]["vq_kernel"] for r in runs)
                            + hier["served"]["vq_launches"]),
            "adam_launches": sum(r["launches"]["fused_adam"] for r in runs),
            "vq_rows": rows}


# ---------------------------------------------------------------------------
# Phase 12: the priors, the PixelCNN and the hierarchical chain
# ---------------------------------------------------------------------------

# the PixelCNN at the CLI's defaults (--prior-dim 64 --prior-layers 15, a
# 512-wide head over 512 codes); the hierarchy's top prior at phase 7's
# transformer width. Both cut in depth (steps, timed requests) only
PIXELCNN_DIM, PIXELCNN_LAYERS = 64, 15
HIER_PRIOR_EPOCHS = 2
PRIORS_TIMED_STEPS = 20
PRIORS_SAMPLE_REPEATS = 3  # timed /sample requests per n (the sampler is launch-bound)
NAIVE_CHECK = (2, 20, 7)  # batch and grid of the fast-vs-naive sampler check
SAMPLER_TIE_GAP = 1e-5
LAUNCH_COUNT_GRID = (2, 21)  # rows x columns the launches per code are counted over
# the hierarchy's bottom grid at the JAX CLI's default --code-shape 20 28
# (long_t_warning's case): one train step of each family timed there
LONG_GRID, LONG_GRID_BATCH, LONG_GRID_STEPS = (40, 56), 32, 10


def zero_launches(counters) -> dict:
    return dict.fromkeys(read_launches(*counters), 0)


def check_prior_run(run: dict, what: str, epochs: int, want: dict) -> None:
    check(run["launches"] == want, f"{what}: launches {run['launches']}, expected {want}")
    check(len(run["epoch_nll"]) == epochs and all(np.isfinite(run["epoch_nll"])),
          f"{what}: epoch NLLs {run['epoch_nll']}")


def pixelcnn_sampler_checks(torch, prior, codes, labels) -> dict:
    """On the card: the row-cached logits against the parallel forward
    (1e-4), and the fast sampler against the naive one on the same noise:
    equal codes, except where the naive draw's Gumbel-max gap is below
    SAMPLER_TIE_GAP (its first difference in a sample; later pixels are
    conditioned on it)."""
    from neural_sound_generation_tpu_torch.models import pixelcnn
    from neural_sound_generation_tpu_torch.models.transformer_prior import gumbel_noise

    with torch.no_grad():
        forward = prior(codes[:4], labels[:4])
    inc = pixelcnn.incremental_logits(prior, codes[:4], labels[:4])
    inc_err = float((inc - forward).abs().max())
    check(inc_err <= 1e-4, f"pixelcnn incremental_logits differ from the forward by {inc_err}")
    b, h, w = NAIVE_CHECK
    noise = gumbel_noise((h * w, b, prior.input_dim),
                         torch.Generator(device=DEVICE).manual_seed(SEED), DEVICE)
    lab = labels[:b]
    t0 = time.perf_counter()
    fast = pixelcnn.fast_generate(prior, lab, shape=(h, w), batch_size=b, gumbel=noise)
    sync(torch)
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    naive = pixelcnn.generate(prior, lab, shape=(h, w), batch_size=b, gumbel=noise)
    sync(torch)
    naive_s = time.perf_counter() - t0
    with torch.no_grad():
        naive_logits = prior(naive, lab)
    gaps = []
    for bi in range(b):
        diff = (fast[bi] != naive[bi]).nonzero()
        if len(diff):
            i, j = (int(v) for v in diff[0])
            top2 = torch.topk(naive_logits[bi, i, j] + noise[i * w + j, bi], 2).values
            gaps.append(float(top2[0] - top2[1]))
            check(gaps[-1] < SAMPLER_TIE_GAP,
                  f"fast vs naive sampler: sample {bi} differs at ({i}, {j}) with gap {gaps[-1]}")
    return {"incremental_vs_forward_max_abs_err": inc_err, "naive_check": list(NAIVE_CHECK),
            "fast_vs_naive_codes_equal": bool(torch.equal(fast, naive)),
            "fast_vs_naive_gaps": gaps, "fast_s": fast_s, "naive_s": naive_s,
            "launches_per_code": sampler_launches(torch, prior, lab[:1])}


def sampler_launches(torch, prior, labels) -> dict:
    """What one sampler call (either family's, ``prior_generate``) over
    LAUNCH_COUNT_GRID launches per grid position: the ATen operators
    dispatched (a dispatch mode counts them; each launches at most one
    kernel) and the CUDA kernels the profiler records (None where it
    records none)."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from neural_sound_generation_tpu_torch.inference import prior_generate

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    h, w = LAUNCH_COUNT_GRID
    run = lambda: prior_generate(prior, labels, torch.Generator(device=DEVICE),  # noqa: E731
                                 shape=(h, w), batch_size=1)
    run()
    with Count():
        run()
    kernels = None
    try:
        if DEVICE == "cuda":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                sync(torch)
            n = sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
            kernels = n / (h * w) if n else None
    except (RuntimeError, AssertionError) as e:  # a record, not a check: it stays None
        print(f"profiler: {e}", file=sys.stderr)
    return {"grid": [h, w], "aten_ops_per_code": Count.n / (h * w),
            "cuda_kernels_per_code": kernels}


def encode_batch(torch, cli_prior, args, corpus: str, stride: int):
    """The CLI's encoder over one training batch: (codes, cond or None,
    the model, the loader)."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.data.pipeline import get_audio_data_loaders

    cfg = Config()
    loader = get_audio_data_loaders(corpus, None, PRIOR_BATCH, cfg, latent_stride=stride)["train"]
    model = cli_prior.load_vqvae(args, cfg, DEVICE)
    encode = cli_prior.make_encoder(args, model)
    codes, cond = encode(torch.from_numpy(next(iter(loader))["x"]).to(DEVICE))
    return codes, cond, model, loader


def pixelcnn_part(torch, cli_prior, serve, checkpoint, counters, root: str, vq_ckpt: str,
                  corpus: str) -> dict:
    """The flat PixelCNN at the CLI's defaults on phase 5's VQ-VAE and
    corpus: ``cli.prior train`` for PRIOR_EPOCHS epochs and once more with
    --resume, one step card vs CPU, steps/s, the sampler on the card,
    ``cli.prior sample`` and ``serve --prior-ckpt`` /sample."""
    from neural_sound_generation_tpu_torch.config import Config

    t0 = time.perf_counter()
    ckpt = os.path.join(root, "pixelcnn", "models")
    widths = ["--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES), "--device", DEVICE]
    train = ["train", "--datadir", corpus, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir", ckpt,
             "--batch-size", str(PRIOR_BATCH),
             "--max-batches-per-epoch", str(PRIOR_BATCHES_PER_EPOCH), *widths]
    runs = {"train": run_cli_prior(cli_prior, counters, train + ["--epochs", str(PRIOR_EPOCHS)])}
    runs["resume"] = run_cli_prior(cli_prior, counters,
                                   train + ["--epochs", str(PRIOR_EPOCHS + 1), "--resume"])
    for tag, epochs in (("train", PRIOR_EPOCHS), ("resume", 1)):
        steps = epochs * PRIOR_BATCHES_PER_EPOCH
        runs[tag]["optimizer_steps"] = steps
        # one nearest-code search per encoded batch, one update per step
        check_prior_run(runs[tag], f"pixelcnn {tag}", epochs,
                        {**zero_launches(counters), "vq_nearest": steps, "fused_adam": steps})
    nll = runs["train"]["epoch_nll"]
    check(nll[-1] < nll[0], f"pixelcnn: the NLL did not fall ({nll})")
    spec = cli_prior.PriorSpec.create("pixelcnn", TRAIN_CODES, PIXELCNN_DIM, PIXELCNN_LAYERS,
                                      None, 10)
    extra = checkpoint.read_extra(ckpt)
    check(extra == {"epoch": PRIOR_EPOCHS + 1, **spec.metadata()},
          f"pixelcnn checkpoint metadata {extra}")

    args = cli_prior.parse_args(train + ["--epochs", "1"])
    codes, _, vqvae, _ = encode_batch(torch, cli_prior, args, corpus, 4)
    del vqvae
    labels = torch.zeros(codes.shape[0], dtype=torch.int32, device=DEVICE)
    pcfg = prior_cfg(Config())
    batch = {"codes": codes, "labels": labels}
    # from the first epoch's state: the resumed run's prior predicts these
    # regular chirp codes almost surely (an NLL of some 4e-6 nats on an
    # H100), where a relative NLL says nothing about the arithmetic
    compare, state = prior_step_card_vs_cpu(torch, checkpoint, spec, ckpt + "_train", pcfg,
                                            batch, "pixelcnn", PRIOR_BATCHES_PER_EPOCH)
    step_s = prior_step_seconds(torch, state, pcfg, batch, PRIORS_TIMED_STEPS)
    del state
    prior = cli_prior.load_prior(ckpt, spec, DEVICE)
    sampler = pixelcnn_sampler_checks(torch, prior, codes, labels)
    emit({"phase": "pixelcnn_sampler", **sampler})
    sampled = run_sample_cli(cli_prior, ["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt",
                                         ckpt + "_ema", *widths],
                             os.path.join(root, "pixelcnn", "samples"), "prior_sample", 4 * 28)
    served = serve_sample_requests(torch, serve, [
        "--device", DEVICE, "--ckpt-dir", vq_ckpt, "--dim", str(TRAIN_DIM),
        "--z-dim", str(TRAIN_CODES), "--prior-ckpt", ckpt], counters, PRIORS_SAMPLE_REPEATS)
    check(served["launches_over_requests"] == zero_launches(counters),
          f"pixelcnn /sample launched {served['launches_over_requests']}")
    return {"phase": "priors_pixelcnn", "prior_dim": PIXELCNN_DIM,
            "prior_layers": PIXELCNN_LAYERS, "codes": TRAIN_CODES, "batch": PRIOR_BATCH,
            "code_grid": list(codes.shape[1:]),
            "parameters": sum(p.numel() for p in prior.parameters()), "runs": runs,
            "card_vs_cpu_step": compare, "train_step_ms": 1e3 * step_s,
            "train_steps_per_s": 1.0 / step_s, "timed_steps": PRIORS_TIMED_STEPS,
            "sampler": sampler, "sample_cli": sampled, "serve_sample": served,
            "seconds": time.perf_counter() - t0}


def warm_state_dir(torch, checkpoint, spec, pcfg, batch: dict, out: str) -> str:
    """A full train state of ``spec``'s model after 3 steps on the card on
    ``batch`` (warm moments), saved under ``out``."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    state = create_train_state(spec.build().to(DEVICE), pcfg.train)
    step = make_train_step(state.model, pcfg)
    for _ in range(3):
        step(state, batch)
    checkpoint.save(out, state, int(state.step), spec.metadata())
    return out


def hier_chain_part(torch, cli_prior, serve, checkpoint, counters, root: str,
                    corpus: str) -> dict:
    """The hierarchical chain on phase 11's HierVQVAE checkpoint: the
    transformer top prior and the PixelCNN bottom prior through ``cli.prior
    train --hier``, one bottom step card vs CPU, one step of a spatially
    conditioned transformer bottom card vs CPU (built here: ``cond_proj``
    beside kernel 4), steps/s, ``cli.prior sample --hier`` and ``serve
    --model hiervqvae`` /sample."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.inference import sample_hier_mels
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    t0 = time.perf_counter()
    vq = os.path.join(root, "hier", "models", "hiervqvae",
                      f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    check(os.path.isdir(vq), f"no HierVQVAE checkpoint at {vq}")
    out = os.path.join(root, "hier_prior")
    top_ckpt, bottom_ckpt = os.path.join(out, "top"), os.path.join(out, "bottom")
    common = ["--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES), "--device", DEVICE]
    top_w = ["--arch", "transformer", "--prior-dim", str(PRIOR_DIM),
             "--prior-layers", str(PRIOR_LAYERS)]
    base = ["train", "--datadir", corpus, "--vqvae-ckpt", vq, "--hier",
            "--batch-size", str(PRIOR_BATCH), "--max-batches-per-epoch",
            str(PRIOR_BATCHES_PER_EPOCH), "--epochs", str(HIER_PRIOR_EPOCHS), *common]
    runs = {
        "top": run_cli_prior(cli_prior, counters, base + [
            "--hier-level", "top", "--ckpt-dir", top_ckpt, *top_w]),
        "bottom": run_cli_prior(cli_prior, counters, base + [
            "--hier-level", "bottom", "--ckpt-dir", bottom_ckpt, "--arch", "pixelcnn"]),
    }
    steps = HIER_PRIOR_EPOCHS * PRIOR_BATCHES_PER_EPOCH
    # each encoded batch searches both levels (2); one update per step; the
    # top transformer's attention kernels once per layer and step
    base_want = {**zero_launches(counters), "vq_nearest": 2 * steps, "fused_adam": steps}
    check_prior_run(runs["top"], "hier top prior", HIER_PRIOR_EPOCHS, {
        **base_want, **{k: PRIOR_LAYERS * steps for k in ("flash_fwd", "flash_bwd_dq",
                                                          "flash_bwd_dkdv")}})
    check_prior_run(runs["bottom"], "hier bottom prior", HIER_PRIOR_EPOCHS, base_want)
    for r in runs.values():
        r["optimizer_steps"] = steps

    # the codes the two priors trained on: one epoch's grids of each level
    args = cli_prior.parse_args(base + ["--hier-level", "bottom"])
    idx_b, cond, hier, loader = encode_batch(torch, cli_prior, args, corpus, 8)
    loader.set_epoch(0)
    top_codes, bottom_codes = set(), set()
    with torch.no_grad():
        for i, b in enumerate(loader):
            if i >= PRIOR_BATCHES_PER_EPOCH:
                break
            t, bt = hier.encode(torch.from_numpy(b["x"]).to(DEVICE))
            top_codes.update(t.unique().tolist())
            bottom_codes.update(bt.unique().tolist())
    distinct = {"top": len(top_codes), "bottom": len(bottom_codes)}
    emit({"phase": "hier_encoded_codes", "distinct_codes": distinct,
          "batches": PRIOR_BATCHES_PER_EPOCH})

    labels = torch.zeros(idx_b.shape[0], dtype=torch.int32, device=DEVICE)
    pcfg = prior_cfg(Config())
    bottom_spec = cli_prior.PriorSpec.create("pixelcnn", TRAIN_CODES, PIXELCNN_DIM,
                                             PIXELCNN_LAYERS, None, 10, cond_dim=TRAIN_DIM)
    top_spec = cli_prior.PriorSpec.create("transformer", TRAIN_CODES, PRIOR_DIM, PRIOR_LAYERS,
                                          None, 10)
    check(checkpoint.read_extra(bottom_ckpt) == {"epoch": HIER_PRIOR_EPOCHS,
                                                 **bottom_spec.metadata()},
          f"hier bottom metadata {checkpoint.read_extra(bottom_ckpt)}")
    bottom_batch = {"codes": idx_b, "labels": labels, "cond": cond}
    compare_b, state = prior_step_card_vs_cpu(torch, checkpoint, bottom_spec,
                                              bottom_ckpt + "_train", pcfg, bottom_batch,
                                              "hier_bottom_pixelcnn", PRIOR_BATCHES_PER_EPOCH)
    bottom_s = prior_step_seconds(torch, state, pcfg, bottom_batch, PRIORS_TIMED_STEPS)
    del state
    with torch.no_grad():
        top_grid, _ = hier.encode(torch.from_numpy(next(iter(loader))["x"]).to(DEVICE))
    state = create_train_state(top_spec.build().to(DEVICE), pcfg.train)
    checkpoint.restore(top_ckpt + "_train", state)
    top_s = prior_step_seconds(torch, state, pcfg, {"codes": top_grid, "labels": labels},
                               PRIORS_TIMED_STEPS)
    del state
    # a spatially conditioned transformer bottom: cond_proj with kernel 4
    tb_spec = cli_prior.PriorSpec.create("transformer", TRAIN_CODES, PRIOR_DIM, PRIOR_LAYERS,
                                         None, 10, cond_dim=TRAIN_DIM)
    warm = warm_state_dir(torch, checkpoint, tb_spec, pcfg, bottom_batch,
                          os.path.join(out, "transformer_bottom"))
    compare_tb, state = prior_step_card_vs_cpu(torch, checkpoint, tb_spec, warm, pcfg,
                                               bottom_batch, "hier_bottom_transformer")
    del state

    sampled = run_sample_cli(cli_prior, [
        "sample", "--hier", "--vqvae-ckpt", vq, "--prior-ckpt", top_ckpt + "_ema",
        "--bottom-ckpt", bottom_ckpt + "_ema", *top_w, "--bottom-arch", "pixelcnn",
        "--bottom-dim", str(PIXELCNN_DIM), "--bottom-layers", str(PIXELCNN_LAYERS),
        "--code-shape", "10", "10", *common], os.path.join(out, "samples"), "hier_sample", 80)
    argv = ["--device", DEVICE, "--model", "hiervqvae", "--ckpt-dir", vq, "--dim",
            str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES), "--prior-ckpt", top_ckpt,
            "--prior-arch", "transformer", "--prior-dim", str(PRIOR_DIM), "--prior-layers",
            str(PRIOR_LAYERS), "--prior-heads", str(PRIOR_HEADS), "--bottom-ckpt", bottom_ckpt,
            "--bottom-prior-arch", "pixelcnn", "--bottom-prior-dim", str(PIXELCNN_DIM),
            "--bottom-prior-layers", str(PIXELCNN_LAYERS)]
    served = serve_sample_requests(torch, serve, argv, counters, PRIORS_SAMPLE_REPEATS)
    check(served["launches_over_requests"] == zero_launches(counters),
          f"hier /sample launched {served['launches_over_requests']}")
    top, bottom = serve.load_serving_priors(serve.parse_args(argv), DEVICE)
    n = 4
    idx_t, idx_b, mels = sample_hier_mels(
        hier, top, bottom, torch.full((n,), 1, dtype=torch.int32, device=DEVICE), (10, 10),
        torch.Generator(device=DEVICE).manual_seed(SEED))
    check(tuple(idx_t.shape) == (n, 10, 10) and tuple(idx_b.shape) == (n, 20, 20)
          and tuple(mels.shape) == (n, 80, 80) and bool(torch.isfinite(mels).all()),
          f"hier chain: grids {tuple(idx_t.shape)}, {tuple(idx_b.shape)}, mels "
          f"{tuple(mels.shape)}")
    return {"phase": "priors_hier_chain", "top": {"arch": "transformer", "prior_dim": PRIOR_DIM,
                                                  "prior_layers": PRIOR_LAYERS,
                                                  "code_grid": list(idx_t.shape[1:])},
            "bottom": {"arch": "pixelcnn", "prior_dim": PIXELCNN_DIM,
                       "prior_layers": PIXELCNN_LAYERS, "code_grid": list(idx_b.shape[1:]),
                       "cond_channels": TRAIN_DIM},
            "train_grids": {"top": [int(v) for v in top_grid.shape[1:]],
                            "bottom": [int(v) for v in bottom_batch["codes"].shape[1:]]},
            "batch": PRIOR_BATCH, "runs": runs, "distinct_encoded_codes": distinct,
            "card_vs_cpu_step": {"bottom_pixelcnn": compare_b,
                                 "bottom_transformer": compare_tb},
            "train_steps_per_s": {"top_transformer": 1.0 / top_s,
                                  "bottom_pixelcnn": 1.0 / bottom_s},
            "timed_steps": PRIORS_TIMED_STEPS, "sample_cli": sampled, "serve_sample": served,
            "seconds": time.perf_counter() - t0}


def long_grid_steps(torch, cli_prior) -> dict:
    """One train step of each family, spatially conditioned, at the
    hierarchy's long bottom grid (LONG_GRID, T = 2240), batch
    LONG_GRID_BATCH, random codes and conditioning: ms per step after 3
    warm-up steps, and the transformer's time over the PixelCNN's."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    h, w = LONG_GRID
    batch = {"codes": torch.randint(0, TRAIN_CODES, (LONG_GRID_BATCH, h, w), generator=gen,
                                    device=DEVICE, dtype=torch.int32),
             "labels": torch.zeros(LONG_GRID_BATCH, dtype=torch.int32, device=DEVICE),
             "cond": torch.randn(LONG_GRID_BATCH, h, w, TRAIN_DIM, generator=gen,
                                 device=DEVICE)}
    pcfg = prior_cfg(Config())
    ms = {}
    for arch, dim, layers in (("pixelcnn", PIXELCNN_DIM, PIXELCNN_LAYERS),
                              ("transformer", PRIOR_DIM, PRIOR_LAYERS)):
        spec = cli_prior.PriorSpec.create(arch, TRAIN_CODES, dim, layers, None, 10,
                                          cond_dim=TRAIN_DIM)
        state = create_train_state(spec.build().to(DEVICE), pcfg.train)
        ms[arch] = 1e3 * prior_step_seconds(torch, state, pcfg, batch, LONG_GRID_STEPS)
        del state
    return {"grid": [h, w], "t": h * w, "batch": LONG_GRID_BATCH, "step_ms": ms,
            "transformer_over_pixelcnn": ms["transformer"] / ms["pixelcnn"]}


def priors_phase(torch, cli_prior, serve, checkpoint, counters, root: str, vq_ckpt: str,
                 corpus: str, card: str) -> dict:
    """Phase 12: the flat PixelCNN, the hierarchical chain and the long-grid
    step times. One record line a part."""
    t0 = time.perf_counter()
    flat = pixelcnn_part(torch, cli_prior, serve, checkpoint, counters, root, vq_ckpt, corpus)
    flat["card"] = card
    emit(flat)
    torch.cuda.empty_cache()
    chain = hier_chain_part(torch, cli_prior, serve, checkpoint, counters, root, corpus)
    chain["card"] = card
    emit(chain)
    torch.cuda.empty_cache()
    long_grid = long_grid_steps(torch, cli_prior)
    emit({"phase": "priors_long_grid", "card": card, **long_grid})
    torch.cuda.empty_cache()
    runs = [*flat["runs"].values(), *chain["runs"].values()]
    return {"phase": "priors", "card": card, "seconds": time.perf_counter() - t0,
            "parts_seconds": {"pixelcnn": flat["seconds"], "hier_chain": chain["seconds"]},
            "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
            "pixelcnn_parameters": flat["parameters"],
            "train_steps_per_s": {"pixelcnn": flat["train_steps_per_s"],
                                  **{f"hier_{k}": v
                                     for k, v in chain["train_steps_per_s"].items()}},
            "sample_p50_ms": {"pixelcnn": {n: v["p50"] for n, v in
                                           flat["serve_sample"]["latency_ms"].items()},
                              "hier_chain": {n: v["p50"] for n, v in
                                             chain["serve_sample"]["latency_ms"].items()}},
            "launches_per_code": flat["sampler"]["launches_per_code"],
            "distinct_encoded_codes": chain["distinct_encoded_codes"],
            "long_grid": long_grid}


# ---------------------------------------------------------------------------
# Phase 13: vocoder training
# ---------------------------------------------------------------------------

# the CLI's default vocoder (24 layers, 4 stacks, R = G = 512, S = 256, cin
# 80, a 10-mixture MoL head; 256 classes under mulaw-quantize; cin 256 and
# an upsampler by 64 under --condition units) at the presets' batch 2 of
# 7168-sample crops (max_time_steps 8000 after the loader's 28-frame crop),
# BATCHES_PER_EPOCH batches an epoch; its parameter counts (EMA on for the
# mel chain, off under the cmu_arctic_8bit settings)
VT_BATCH = 2
VT_PARAMS = {"mel_mol": 24_886_366, "mulaw_quantize": 25_337_152, "units": 28_417_566}
VT_ADAM = [("mel_mol", ("f32_ema", False, False, 0.0, True)),
           ("mulaw_quantize", ("f32_plain", False, False, 0.0, False))]
VT_SPEAKER_GIN = 16
# every run's learning rate, from a preset the phase writes. At the CLI's
# default (1e-3, constant: the JAX CLI builds its state without the
# presets' schedule) the full-width MoL loss on a fixed batch wanders over
# the first 32 steps (11.83 -> 11.39 at step 16 in one run, 11.91 in
# another: cuDNN's weight gradients are not deterministic, and steps spike
# to 14.4); at 1e-4 it fell by about 1 nat in 16 steps, f32 and bf16
# (scripts/torch_vocoder_lr_probe.py)
VT_LR = 1e-4
VT_TIMED_STEPS = 20
# the card-vs-CPU steps run on the first 2048 samples (8 mel frames) of a
# batch; a bf16 step's loss within 2e-2 relative, as the CPU tests hold the
# port's bf16 step against JAX's
VT_CARD_CPU_SAMPLES = 2048
VT_BF16_LOSS_REL = 2e-2
VT_UNITS_FRAMES = 16  # synthesize --condition units: 16 unit hops of 64 samples
VT_EPOCH_RE = re.compile(r"^wavenet epoch (\d+): loss (\S+)", re.M)
# the width flags of every run: none, the CLI's default vocoder (a CPU
# rehearsal of the phase may set small ones)
VT_LAYERS = VT_STACKS = VT_RESIDUAL = None


def vocoder_widths(**kw):
    """``build_model``'s width arguments of the phase's vocoder."""
    import types

    return types.SimpleNamespace(residual_channels=VT_RESIDUAL, layers=VT_LAYERS,
                                 stacks=VT_STACKS, **kw)


def vocoder_width_flags() -> list:
    flags = (("--layers", VT_LAYERS), ("--stacks", VT_STACKS),
             ("--residual-channels", VT_RESIDUAL))
    return [x for flag, v in flags if v is not None for x in (flag, str(v))]


def units_flags(units_ckpt: str) -> list:
    return ["--condition", "units", "--units-vqvae-ckpt", units_ckpt, "--units-dim",
            str(TRAIN_DIM), "--units-z-dim", str(TRAIN_CODES), "--units-downsample",
            str(WAVE_DOWNSAMPLE), "--units-num-quantizers", "1"]


def run_cli_vocoder(cli_vocoder, kernels, argv) -> dict:
    """One ``cli.vocoder`` run with every launch count set to 0 just before
    it and read just after; its epoch lines parsed."""
    for k in kernels:
        k.reset_launch_count()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli_vocoder.main(argv)
    seconds = time.perf_counter() - t0
    text = out.getvalue()
    return {"seconds": seconds,
            "launches": {k.__name__.rsplit(".", 1)[-1]: k.launch_count() for k in kernels},
            "epochs": [(int(e), float(v)) for e, v in VT_EPOCH_RE.findall(text)],
            "text": text}


def check_vocoder_run(run: dict, tag: str, epochs: list, want_vq: int) -> None:
    """The run's epochs, fused_adam once per optimizer step, vq_nearest
    ``want_vq`` times, each epoch's mean loss finite. Epoch means come from
    other batches each epoch (chirps of 0.2-0.7 peak), so whether the loss
    falls is held on one fixed batch (``held_loss``)."""
    steps = len(epochs) * BATCHES_PER_EPOCH
    got = [e for e, _ in run["epochs"]]
    check(got == epochs, f"vocoder {tag}: epochs {got}, expected {epochs}")
    check(run["launches"]["fused_adam"] == steps,
          f"vocoder {tag}: fused_adam launched {run['launches']['fused_adam']} times for "
          f"{steps} steps")
    check(run["launches"]["vq_kernel"] == want_vq,
          f"vocoder {tag}: vq_nearest launched {run['launches']['vq_kernel']} times, "
          f"expected {want_vq}")
    losses = [v for _, v in run["epochs"]]
    check(all(np.isfinite(losses)), f"vocoder {tag}: losses {losses}")
    run.update(optimizer_steps=steps, epoch_losses=losses,
               steps_per_s_cli=steps / run["seconds"])


def held_loss(torch, cli_vocoder, trainer, checkpoint, cfg, widths, batch: dict,
              ckpt: str | None = None) -> float:
    """The vocoder's loss on one fixed device batch: the CLI's seeded
    initial weights (``--seed`` 0), or an artifact's."""
    model = cli_vocoder.build_model(cfg, widths, generator=torch.Generator().manual_seed(0))
    if ckpt is not None:
        checkpoint.restore_params(ckpt, model)
    with torch.no_grad():
        return float(trainer._wavenet_loss(model.to(DEVICE), cfg, batch)[1])


def check_falls(torch, cli_vocoder, trainer, checkpoint, cfg, widths, batch: dict, ckpt: str,
                tag: str) -> dict:
    """The loss on one fixed batch falls from the seeded weights a run
    starts from to the artifact it ends with."""
    before = held_loss(torch, cli_vocoder, trainer, checkpoint, cfg, widths, batch)
    after = held_loss(torch, cli_vocoder, trainer, checkpoint, cfg, widths, batch, ckpt)
    check(np.isfinite(after) and after < before,
          f"vocoder {tag}: the loss on a fixed batch did not fall ({before} -> {after})")
    return {"before": before, "after": after}


def on_device(torch, batch: dict) -> dict:
    return {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(v).to(DEVICE)
            for k, v in batch.items()}


def vocoder_run_record(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "text"}


def vocoder_batch(cli_vocoder, cfg, corpus: str, samples: int | None = None) -> dict:
    """One raw batch of the corpus as the vocoder's numpy batch, its first
    ``samples`` samples (and their mel frames) when given."""
    from neural_sound_generation_tpu_torch.data.pipeline import get_audio_data_loaders

    raw = next(iter(get_audio_data_loaders(corpus, None, VT_BATCH, cfg,
                                           batch_mode="raw")["train"]))
    y, c = cli_vocoder._batch_to_wavenet(raw, cfg)
    lengths = np.asarray(raw["input_lengths"])
    if samples is not None:
        hop = cfg.audio.effective_hop_size
        y, c = y[:, :samples], c[:, : samples // hop]
        lengths = np.minimum(lengths, samples)
    out = {"y": np.ascontiguousarray(y), "c": np.ascontiguousarray(c),
           "input_lengths": lengths.astype(np.int32)}
    g = cli_vocoder._batch_speakers(raw)
    if g is not None:
        out["g"] = g
    return out


def vocoder_card_vs_cpu(torch, cli_vocoder, checkpoint, trainer, cfg, train_dir: str,
                        batch: dict) -> dict:
    """One f32 and one bf16 step at full width, card vs CPU, from the same
    restored state (warm moments and EMA) on the same batch."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    out = {}
    for tag, bf16 in (("f32", False), ("bf16", True)):
        states, metrics = {}, {}
        for device in (DEVICE, "cpu"):
            model = cli_vocoder.build_model(cfg, vocoder_widths(bf16=bf16))
            state = create_train_state(model.to(device), cfg.train)
            checkpoint.restore(train_dir, state)
            on = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            _, m = trainer.make_train_step(model, cfg)(state, on)
            states[device], metrics[device] = state, {k: float(v) for k, v in m.items()}
        rel = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
               for k in metrics["cpu"]}
        diff = (states[DEVICE].flat.flat.cpu() - states["cpu"].flat.flat).abs()
        far = float((diff > 1e-5).float().mean())
        out[tag] = {"metrics": metrics, "rel_err": rel, "params_beyond_1e-5_frac": far,
                    "params_max_abs_err": float(diff.max())}
        del states
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    emit({"phase": "vocoder_card_vs_cpu_step", **out})
    # TF32 is off, so only the order of f32 sums differs: the loss within
    # 1e-5 relative, grad_norm 1e-4, and phase 5's rule for the parameters
    # (Adam turns a near-zero gradient's sign into a step of about lr)
    f32 = out["f32"]
    check(f32["rel_err"]["loss"] <= 1e-5 and f32["rel_err"]["grad_norm"] <= 1e-4,
          f"vocoder card vs CPU f32 step: {f32['rel_err']}")
    check(f32["params_beyond_1e-5_frac"] <= 1e-3 and f32["params_max_abs_err"] <= 1e-2,
          f"vocoder card vs CPU f32 step: {f32['params_beyond_1e-5_frac']:.3%} of parameters "
          f"beyond 1e-5, max {f32['params_max_abs_err']}")
    check(out["bf16"]["rel_err"]["loss"] <= VT_BF16_LOSS_REL,
          f"vocoder card vs CPU bf16 step: {out['bf16']['rel_err']}")
    return out


def units_card_vs_cpu(torch, cli_vocoder, cfg, units_ckpt: str, y: np.ndarray) -> dict:
    """The units of one batch from the frozen WaveVQVAE on the card and on
    the CPU: every code flip a near-tie, the conditioning equal where the
    codes agree."""
    args = cli_vocoder.parse_args(["train", "--datadir", "-", *units_flags(units_ckpt)])
    z_e, codes, cond, books = {}, {}, {}, {}
    for device in (DEVICE, "cpu"):
        units_fn, model = cli_vocoder._build_units_encoder(args, cfg, torch.device(device))
        x = torch.from_numpy(y).to(device)
        with torch.no_grad():
            z = model.encode_latents(x)
            codes[device] = model.encode(x).cpu().reshape(-1)
        z_e[device] = z.reshape(-1, z.shape[-1]).double().cpu()
        cond[device] = units_fn(x).reshape(-1, z.shape[-1]).cpu()
        books[device] = model.codebook.detach().double().cpu()
    flipped = codes[DEVICE] != codes["cpu"]
    book = books["cpu"]
    ties = near_ties(z_e["cpu"][flipped], z_e[DEVICE][flipped], book[codes[DEVICE][flipped]],
                     book[codes["cpu"][flipped]])
    same = ~flipped
    record = {"rows": int(codes["cpu"].numel()), "code_flips": int(flipped.sum()),
              "near_ties": int(ties.sum()),
              "cond_equal_where_codes_agree": bool(torch.equal(cond[DEVICE][same],
                                                               cond["cpu"][same]))}
    check(record["code_flips"] == record["near_ties"],
          f"units card vs CPU: {record['code_flips'] - record['near_ties']} flips that are "
          f"not near-ties")
    check(record["cond_equal_where_codes_agree"], "units card vs CPU: conditioning differs")
    return record


def vocoder_steps_per_s(torch, cli_vocoder, checkpoint, cfg, train_dir: str, batch: dict,
                        bf16: bool) -> float:
    """Train steps/s of the restored vocoder with a device-resident batch."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    model = cli_vocoder.build_model(cfg, vocoder_widths(bf16=bf16)).to(DEVICE)
    state = create_train_state(model, cfg.train)
    checkpoint.restore(train_dir, state)
    step = make_train_step(model, cfg)
    on = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}
    for _ in range(3):
        step(state, on)
    sync(torch)
    t0 = time.perf_counter()
    for _ in range(VT_TIMED_STEPS):
        step(state, on)
    sync(torch)
    return VT_TIMED_STEPS / (time.perf_counter() - t0)


def vocoder_synthesize(cli_vocoder, vq_kernel, argv: list, out: str, want: int,
                       sr: int) -> dict:
    """One ``cli.vocoder synthesize``: finite audio of ``want`` samples, and
    the nearest-code kernel's launches over it."""
    vq_kernel.reset_launch_count()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_vocoder.main(argv + ["--output", out, "--device", DEVICE, *vocoder_width_flags()])
    seconds = time.perf_counter() - t0
    with open(out, "rb") as f:
        wav = read_wav(f.read(), sr)
    check(len(wav) == want and np.isfinite(wav).all(),
          f"synthesize {argv[:4]}: {len(wav)} samples, expected {want} finite")
    return {"samples": len(wav), "seconds": seconds, "vq_launches": vq_kernel.launch_count()}


def vocoder_train_phase(torch, cli_vocoder, checkpoint, dsp, vq_kernel, fused_adam, root: str,
                        corpus: str, card: str) -> dict:
    """Phase 13: ``cli.vocoder train`` at the CLI's default width: the mel
    chain (MoL) for two epochs, --resume for a third, --resume
    --multi-steps 4 for a fourth; --bf16; mulaw-quantize with speakers on
    phase 10's cmu_arctic corpus; --condition units on phase 11's raw
    WaveVQVAE. Launch counts, losses, checkpoints, card-vs-CPU steps,
    steps/s, ``synthesize`` from the mel and the units artifacts, and the
    fused-Adam kernel at the vocoder's parameter counts."""
    from neural_sound_generation_tpu_torch.config import Config, load_preset
    from neural_sound_generation_tpu_torch.training import trainer

    t0 = time.perf_counter()
    out = os.path.join(root, "vocoder_train")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    kernels = (vq_kernel, fused_adam)
    cmu = os.path.join(root, "preprocess", "cmu_arctic_on_card")
    units_ckpt = os.path.join(root, "wave", "models", "wavevqvae",
                              f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")

    lr_preset = os.path.join(out, "vocoder_lr.json")
    with open(lr_preset, "w", encoding="utf-8") as f:
        json.dump({"initial_learning_rate": VT_LR}, f)

    def argv(tag, *extra, datadir=corpus, preset=lr_preset):
        return ["train", "--datadir", datadir, "--ckpt-dir", os.path.join(out, tag),
                "--preset", preset,
                "--batch-size", str(VT_BATCH), "--max-batches-per-epoch",
                str(BATCHES_PER_EPOCH), "--device", DEVICE, *vocoder_width_flags(), *extra]

    steps = BATCHES_PER_EPOCH
    runs = {}
    mel = os.path.join(out, "mel")
    cfg = load_preset(lr_preset, Config())
    full = vocoder_batch(cli_vocoder, cfg, corpus)
    check(full["y"].shape == (VT_BATCH, 7168, 1), f"vocoder batch {full['y'].shape}")
    held = on_device(torch, full)
    falls = {}
    runs["mel"] = run_cli_vocoder(cli_vocoder, kernels, argv("mel", "--epochs", "2"))
    check_vocoder_run(runs["mel"], "mel", [1, 2], 0)
    falls["mel"] = check_falls(torch, cli_vocoder, trainer, checkpoint, cfg, vocoder_widths(),
                               held, mel, "mel")
    for suffix, extra in (("", {}), ("_ema", {"averaged": True}), ("_train", {})):
        got = (checkpoint.latest_step(mel + suffix), checkpoint.read_extra(mel + suffix))
        check(got == (2 * steps, {"epoch": 2, "condition": "mel", **extra}),
              f"vocoder mel{suffix}: checkpoint {got}")
    runs["resume"] = run_cli_vocoder(cli_vocoder, kernels,
                                     argv("mel", "--epochs", "3", "--resume"))
    check(f"resumed train state from step {2 * steps}, epoch 3" in runs["resume"]["text"],
          f"vocoder --resume: {runs['resume']['text'][:300]}")
    check_vocoder_run(runs["resume"], "mel --resume", [3], 0)
    runs["multi4"] = run_cli_vocoder(cli_vocoder, kernels, argv(
        "mel", "--epochs", "4", "--resume", "--multi-steps", "4"))
    check(f"resumed train state from step {3 * steps}, epoch 4" in runs["multi4"]["text"],
          f"vocoder --multi-steps 4: {runs['multi4']['text'][:300]}")
    check_vocoder_run(runs["multi4"], "mel --multi-steps 4", [4], 0)
    check(checkpoint.latest_step(mel) == 4 * steps, "vocoder mel: checkpoint after 4 epochs")
    falls["mel_after_4_epochs"] = {"after": held_loss(
        torch, cli_vocoder, trainer, checkpoint, cfg, vocoder_widths(), held, mel)}

    runs["bf16"] = run_cli_vocoder(cli_vocoder, kernels, argv("bf16", "--epochs", "2", "--bf16"))
    check_vocoder_run(runs["bf16"], "--bf16", [1, 2], 0)
    falls["bf16"] = check_falls(torch, cli_vocoder, trainer, checkpoint, cfg,
                                vocoder_widths(bf16=True), held, os.path.join(out, "bf16"),
                                "--bf16")
    saved = torch.load(os.path.join(out, "bf16", f"step_{2 * steps}", "state.pt"),
                       weights_only=True)
    check(all(t.dtype == torch.float32 for t in saved.values()), "vocoder --bf16: not float32")
    del saved

    preset = os.path.join(out, "cmu_arctic_8bit_speakers.json")
    with open(preset, "w", encoding="utf-8") as f:
        json.dump({**CMU_PRESET, "exponential_moving_average": False,
                   "gin_channels": VT_SPEAKER_GIN, "initial_learning_rate": VT_LR}, f)
    runs["mulaw_speakers"] = run_cli_vocoder(cli_vocoder, kernels, argv(
        "mulaw", "--epochs", "2", datadir=cmu, preset=preset))
    check_vocoder_run(runs["mulaw_speakers"], "mulaw-quantize speakers", [1, 2], 0)
    mu = os.path.join(out, "mulaw")
    saved = torch.load(os.path.join(mu, f"step_{2 * steps}", "state.pt"), weights_only=True)
    shapes = {k: tuple(saved[f"params/{k}"].shape) for k in ("speaker_embed.weight",
                                                             "post2.weight")}
    # the corpus's ids index cmu_arctic's seven speakers (the preset's n_speakers)
    check(shapes == {"speaker_embed.weight": (Config().arch.n_speakers, VT_SPEAKER_GIN),
                     "post2.weight": (256, 256, 1)}, f"vocoder mulaw: shapes {shapes}")
    check(checkpoint.latest_step(mu + "_ema") is None, "vocoder mulaw: an EMA without EMA")
    del saved
    mu_cfg = load_preset(preset, Config())
    mu_batch = vocoder_batch(cli_vocoder, mu_cfg, cmu)
    check(mu_batch.get("g") is not None, "vocoder mulaw: the batch carries no speakers")
    falls["mulaw_speakers"] = check_falls(torch, cli_vocoder, trainer, checkpoint, mu_cfg,
                                          vocoder_widths(), on_device(torch, mu_batch), mu,
                                          "mulaw-quantize speakers")

    units = units_flags(units_ckpt)
    runs["units"] = run_cli_vocoder(cli_vocoder, kernels, argv("units", "--epochs", "2", *units))
    # one nearest-code search a step (Q = 1): each batch's targets encoded
    check_vocoder_run(runs["units"], "--condition units", [1, 2], 2 * steps)
    meta = {"condition": "units", "units_dim": TRAIN_DIM, "units_z_dim": TRAIN_CODES,
            "units_downsample": WAVE_DOWNSAMPLE, "units_num_quantizers": 1}
    got = checkpoint.read_extra(os.path.join(out, "units"))
    check(got == {"epoch": 2, **meta}, f"vocoder units: checkpoint {got}")
    units_args = cli_vocoder.parse_args(["train", "--datadir", corpus, *units])
    units_fn, _ = cli_vocoder._build_units_encoder(units_args, cfg, torch.device(DEVICE))
    y = held["y"][:, : held["y"].shape[1] // 2**WAVE_DOWNSAMPLE * 2**WAVE_DOWNSAMPLE]
    falls["units"] = check_falls(
        torch, cli_vocoder, trainer, checkpoint, cfg, vocoder_widths(
            condition="units", units_dim=TRAIN_DIM, units_downsample=WAVE_DOWNSAMPLE),
        {**held, "y": y, "c": units_fn(y)}, os.path.join(out, "units"), "--condition units")
    del units_fn
    emit({"phase": "vocoder_held_batch_loss", "card": card, **falls})
    for r in runs.values():
        emit({"phase": "vocoder_train_run", "card": card, **vocoder_run_record(r)})

    plain_mu = dataclasses.replace(cfg, audio=dataclasses.replace(
        cfg.audio, input_type="mulaw-quantize", quantize_channels=256))
    params = {
        "mel_mol": cli_vocoder.build_model(cfg, vocoder_widths()),
        "mulaw_quantize": cli_vocoder.build_model(plain_mu, vocoder_widths()),
        "units": cli_vocoder.build_model(cfg, vocoder_widths(
            condition="units", units_dim=TRAIN_DIM, units_downsample=WAVE_DOWNSAMPLE)),
    }
    params = {k: sum(p.numel() for p in m.parameters()) for k, m in params.items()}
    check(params == VT_PARAMS, f"vocoder parameter counts {params}, expected {VT_PARAMS}")

    card_cpu = vocoder_card_vs_cpu(torch, cli_vocoder, checkpoint, trainer, cfg, mel + "_train",
                                   vocoder_batch(cli_vocoder, cfg, corpus, VT_CARD_CPU_SAMPLES))
    units_cmp = units_card_vs_cpu(torch, cli_vocoder, cfg, units_ckpt, full["y"])
    emit({"phase": "units_card_vs_cpu", "card": card, **units_cmp})
    steps_per_s = {tag: vocoder_steps_per_s(torch, cli_vocoder, checkpoint, cfg, mel + "_train",
                                            full, bf16)
                   for tag, bf16 in (("f32", False), ("bf16", True))}
    torch.cuda.empty_cache()

    sr, hop = cfg.audio.sample_rate, cfg.audio.effective_hop_size
    mel_npy = os.path.join(out, "mel.npy")
    np.save(mel_npy, np.load(os.path.join(corpus, "m0.npy")))
    synth = {"mel": vocoder_synthesize(
        cli_vocoder, vq_kernel, ["synthesize", "--ckpt-dir", mel, "--mel-npy", mel_npy,
                                 "--max-frames", str(WN_SYNTH_FRAMES)],
        os.path.join(out, "mel.wav"), WN_SYNTH_FRAMES * hop, sr)}
    wav_in = os.path.join(out, "source.wav")
    dsp.save_wav(np.load(os.path.join(corpus, "a0.npy")), wav_in, sr)
    synth["units"] = vocoder_synthesize(
        cli_vocoder, vq_kernel, ["synthesize", "--ckpt-dir", os.path.join(out, "units"),
                                 "--wav-in", wav_in, "--max-frames", str(VT_UNITS_FRAMES),
                                 *units],
        os.path.join(out, "units.wav"), VT_UNITS_FRAMES * 2**WAVE_DOWNSAMPLE, sr)
    check(synth["units"]["vq_launches"] == 1 and synth["mel"]["vq_launches"] == 0,
          f"synthesize: vq_nearest launches {synth}")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    adam = {}
    for tag, config in VT_ADAM:
        row = compare_fused_adam(torch, fused_adam, VT_PARAMS[tag], config, gen)
        row["shape_of"] = f"vocoder_{tag}"
        emit(row)
        adam[tag] = row
    torch.cuda.empty_cache()
    return {"phase": "vocoder_train", "card": card, "batch": VT_BATCH,
            "crop_samples": int(full["y"].shape[1]), "parameters": params,
            "runs": {k: vocoder_run_record(r) for k, r in runs.items()},
            "held_batch_loss": falls,
            "card_vs_cpu_step": card_cpu, "units_card_vs_cpu": units_cmp,
            "train_steps_per_s": steps_per_s, "timed_steps": VT_TIMED_STEPS,
            "synthesize": synth, "adam_rows": adam,
            "adam_launches": sum(r["launches"]["fused_adam"] for r in runs.values()),
            "vq_launches": sum(r["launches"]["vq_kernel"] for r in runs.values())
            + synth["units"]["vq_launches"],
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 14: the routed transformer prior (switch-MoE feed-forwards)
# ---------------------------------------------------------------------------

# phase 7's prior with its MLPs routed: the JAX package's own MoE
# configuration (tools/ab_prior.py:108-113: dim 128, 4 layers of 2 heads, 4
# experts, mlp_ratio 4), the CLI's capacity factor 1.25; 2,525,328
# parameters at 512 codes. Cut in steps only: 2 epochs of 8 batches, then
# --resume --multi-steps 4 for a third
MOE_EXPERTS, MOE_EPOCHS, MOE_PARAMS = 4, 2, 2_525_328
# the cached decode is held at the CLI's capacity factor and at one where
# every row must drop tokens (E * capacity < T)
MOE_CAPACITY_FACTORS = (1.25, 0.5)
MOE_TIE_GAP = 1e-5  # a routing flip's top-2 probability gap on the CPU


@contextlib.contextmanager
def record_routing(torch, model):
    """Hooks on every routed block of ``model``: each forward appends the
    routing of its input, (probs, expert, keep) on the CPU, computed with
    the weights that forward ran with, to the list this yields. A dense
    model records nothing."""
    from neural_sound_generation_tpu_torch.models.moe import SwitchMoE

    routes = []

    def hook(moe, args, out):
        with torch.no_grad():
            probs, expert, _, _, keep = moe.dispatch(args[0])
        routes.append((probs.cpu(), expert.cpu(), keep.cpu()))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, SwitchMoE)]
    try:
        yield routes
    finally:
        for h in handles:
            h.remove()


def routing_flips(torch, card: list, cpu: list, tie_gap: float = MOE_TIE_GAP) -> dict:
    """The routing decisions of one step on the card against the CPU's,
    layer by layer (``record_routing``'s lists). A flip in a row at or
    after the first position an earlier layer flipped in that row is that
    flip's cascade (causal attention carries the other expert's output
    there); any other flip must be a near-tie, the CPU's top-2
    probabilities within ``tie_gap``. Decisions are counted, not tokens'
    outputs; with the share of tokens each layer dropped on the card and
    each row's first flipped position (T where none flipped)."""
    decisions = flips = near = cascade = 0
    gaps, dropped, first = [], [], None
    for (_, e_card, k_card), (p_cpu, e_cpu, _) in zip(card, cpu):
        b, t = e_cpu.shape
        pos = torch.arange(t).expand(b, t)
        if first is None:
            first = torch.full((b, 1), t)
        flip = e_card != e_cpu
        top2 = p_cpu.topk(2, dim=-1).values
        gap = top2[..., 0] - top2[..., 1]
        is_cascade = flip & (pos >= first)
        own = flip & ~is_cascade
        decisions += e_cpu.numel()
        flips += int(flip.sum())
        cascade += int(is_cascade.sum())
        near += int((own & (gap <= tie_gap)).sum())
        gaps += gap[own].tolist()
        first = torch.minimum(first, torch.where(flip, pos, t).min(1, keepdim=True).values)
        dropped.append(float((~k_card).float().mean()))
    return {"decisions": decisions, "flips": flips, "near_ties": near, "cascade": cascade,
            "flip_gaps": gaps, "dropped_share_by_layer": dropped,
            "first_flip": [] if first is None else first[:, 0].tolist()}


def moe_prior_phase(torch, cli_prior, serve, checkpoint, counters, root: str, vq_ckpt: str,
                    corpus: str, card: str) -> dict:
    """Phase 14: ``cli.prior train --arch transformer --moe-experts 4`` on
    phase 5's VQ-VAE and corpus, launch counts per run, the NLL falling and
    a finite load-balance mean each epoch, the checkpoint's metadata; one
    step card vs CPU from the resumed state (routing flips only at near-ties
    or their cascades); the cached decode against the forward at both
    capacity factors (drops at 0.5); steps/s; ``cli.prior sample`` and
    /sample from ``serve --prior-moe-experts``."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.models import TransformerPrior
    from neural_sound_generation_tpu_torch.models.transformer_prior import incremental_logits

    t0 = time.perf_counter()
    ckpt = os.path.join(root, "moe_prior", "models")
    widths = ["--arch", "transformer", "--prior-dim", str(PRIOR_DIM),
              "--prior-layers", str(PRIOR_LAYERS), "--moe-experts", str(MOE_EXPERTS),
              "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES), "--device", DEVICE]
    train = ["train", "--datadir", corpus, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir", ckpt,
             "--batch-size", str(PRIOR_BATCH),
             "--max-batches-per-epoch", str(PRIOR_BATCHES_PER_EPOCH), *widths]
    runs = {"train": run_cli_prior(cli_prior, counters, train + ["--epochs", str(MOE_EPOCHS)])}
    runs["resume"] = run_cli_prior(cli_prior, counters, train + [
        "--epochs", str(MOE_EPOCHS + 1), "--resume", "--multi-steps", "4"])
    for tag, epochs in (("train", MOE_EPOCHS), ("resume", 1)):
        steps = epochs * PRIOR_BATCHES_PER_EPOCH
        runs[tag]["optimizer_steps"] = steps
        check_prior_run(runs[tag], f"moe prior {tag}", epochs, {
            "vq_nearest": steps, "fused_adam": steps,
            **{k: PRIOR_LAYERS * steps for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}})
        balance = runs[tag]["epoch_load_balance"]
        check(len(balance) == epochs and all(np.isfinite(balance)),
              f"moe prior {tag}: epoch load-balance means {balance}")
    nll = runs["train"]["epoch_nll"]
    check(nll[-1] < nll[0], f"moe prior: the NLL did not fall ({nll})")
    spec = cli_prior.PriorSpec.create("transformer", TRAIN_CODES, PRIOR_DIM, PRIOR_LAYERS,
                                      PRIOR_HEADS, 10, n_experts=MOE_EXPERTS)
    extra = checkpoint.read_extra(ckpt)
    check(extra == {"epoch": MOE_EPOCHS + 1, **spec.metadata()},
          f"moe prior checkpoint metadata {extra}")
    after = checkpoint.latest_step(ckpt)
    check(after == (MOE_EPOCHS + 1) * PRIOR_BATCHES_PER_EPOCH,
          f"moe prior checkpoint at step {after}")

    # one step card vs CPU from the resumed state, on one encoded batch
    codes, _, vqvae, _ = encode_batch(torch, cli_prior, cli_prior.parse_args(train), corpus,
                                      cli_prior.LATENT_STRIDE)
    del vqvae
    labels = torch.zeros(codes.shape[0], dtype=torch.int32, device=DEVICE)
    pcfg = prior_cfg(Config())
    batch = {"codes": codes, "labels": labels}
    compare, state = prior_step_card_vs_cpu(torch, checkpoint, spec, ckpt + "_train", pcfg,
                                            batch, "moe_prior")
    params = sum(p.numel() for p in state.model.parameters())
    check(params == MOE_PARAMS, f"moe prior: {params} parameters, expected {MOE_PARAMS}")
    step_s = prior_step_seconds(torch, state, pcfg, batch, PRIOR_TIMED_STEPS)
    del state

    # the KV-cached routed decode against the forward, the trained weights
    # at the CLI's capacity factor and rebuilt at one that drops
    trained = cli_prior.load_prior(ckpt, spec, DEVICE)
    t_len = codes.shape[1] * codes.shape[2]
    cached = {}
    for cf in MOE_CAPACITY_FACTORS:
        model = TransformerPrior(TRAIN_CODES, PRIOR_DIM, PRIOR_LAYERS, PRIOR_HEADS, 10,
                                 n_experts=MOE_EXPERTS, capacity_factor=cf).to(DEVICE).eval()
        model.load_state_dict(trained.state_dict())
        with record_routing(torch, model) as routes, torch.no_grad():
            forward = model(codes[:4], labels[:4])
        err = float((incremental_logits(model, codes[:4], labels[:4]) - forward).abs().max())
        cached[f"cf={cf}"] = {"capacity": model.block_0.moe.capacity(t_len),
                              "max_abs_err": err,
                              "dropped_share_by_layer": [float((~keep).float().mean())
                                                         for _, _, keep in routes]}
        check(err <= 1e-4, f"moe prior cf={cf}: incremental_logits differ from the forward "
                           f"by {err}")
        del model
    low = cached[f"cf={MOE_CAPACITY_FACTORS[1]}"]
    check(min(low["dropped_share_by_layer"]) > 0,
          f"moe prior: no token dropped at capacity {low['capacity']} ({low})")

    sampled = run_sample_cli(cli_prior, ["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt",
                                         ckpt + "_ema", *widths],
                             os.path.join(root, "moe_prior", "samples"), "prior_sample", 4 * 28)
    served = serve_sample_requests(torch, serve, [
        "--device", DEVICE, "--ckpt-dir", vq_ckpt, "--dim", str(TRAIN_DIM),
        "--z-dim", str(TRAIN_CODES), "--prior-ckpt", ckpt, "--prior-arch", "transformer",
        "--prior-dim", str(PRIOR_DIM), "--prior-layers", str(PRIOR_LAYERS),
        "--prior-heads", str(PRIOR_HEADS), "--prior-moe-experts", str(MOE_EXPERTS)],
        counters, SAMPLE_REPEATS)
    return {
        "phase": "moe_prior", "card": card, "prior_dim": PRIOR_DIM, "prior_layers": PRIOR_LAYERS,
        "prior_heads": PRIOR_HEADS, "experts": MOE_EXPERTS, "codes": TRAIN_CODES,
        "batch": PRIOR_BATCH, "code_grid": list(codes.shape[1:]), "parameters": params,
        "runs": runs, "launches": {k: sum(r["launches"][k] for r in runs.values())
                                   for k in runs["train"]["launches"]},
        "card_vs_cpu_step": compare, "train_step_ms": 1e3 * step_s,
        "train_steps_per_s": 1.0 / step_s, "timed_steps": PRIOR_TIMED_STEPS,
        "incremental_vs_forward": cached, "sample_cli": sampled, "serve_sample": served,
        "seconds": time.perf_counter() - t0,
    }


# ---------------------------------------------------------------------------
# Phase 15: the priors in bf16, and chunked attention
# ---------------------------------------------------------------------------

# phases 7, 12 and 14's widths (the dense and the routed transformer at dim
# 128, 4 layers of 2 heads, 4 experts at capacity factor 1.25; the PixelCNN
# at the CLI's 64 x 15), batch 32 of 20 x 7 grids, with --bf16. Cut in
# steps only: 2 epochs of 8 batches, then an 8-step --resume
BF16_EPOCHS = 2
BF16_FAMILIES = {
    "transformer": ["--arch", "transformer", "--prior-dim", str(PRIOR_DIM),
                    "--prior-layers", str(PRIOR_LAYERS)],
    "moe_transformer": ["--arch", "transformer", "--prior-dim", str(PRIOR_DIM),
                        "--prior-layers", str(PRIOR_LAYERS), "--moe-experts", str(MOE_EXPERTS)],
    "pixelcnn": [],
}
# a bf16 step card vs CPU: the loss terms within 2e-2 relative (bf16
# roundings of sums in another order, as phases 6 and 13 hold bf16 steps);
# the cached and row-cached logits against the forward within 2e-2 of the
# largest logit (the JAX package's own bound, tests/test_models.py:393-395)
BF16_LOSS_REL, BF16_LOGIT_REL = 2e-2, 2e-2
# a routing flip between two bf16 computations is a near-tie when the
# reference's top-2 router probabilities are within 1e-2: the router reads a
# bf16 activation, and one bf16 ulp (2^-8 relative) in its elements moves
# the router's logits, and so the gap, by up to some 1e-2 at these widths
# (the float32 rule, MOE_TIE_GAP, is the order of f32 sums)
BF16_ROUTE_GAP = 1e-2
# chunked_causal_attention at the hierarchy's bottom grid (batch 8 x 2 heads)
CHUNKED_SHAPE = ("hier_T2240", 16, 2240, 64)


def bf16_family(torch, cli_prior, checkpoint, counters, fa, root: str, vq_ckpt: str,
                corpus: str, family: str) -> dict:
    """One family through ``cli.prior train --bf16`` (and --resume), each
    run's launch counts (kernel 4's all in bf16), the NLL falling, the
    metadata (no dtype in it); one bf16 step card vs CPU from the first
    epoch's state; the cached (transformer) or row-cached (PixelCNN) logits
    against the bf16 forward; steps/s in bf16 and f32 from the same state;
    ``cli.prior sample --bf16``; the sampler's kernels a code."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.models import pixelcnn, transformer_prior
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    t0 = time.perf_counter()
    ckpt = os.path.join(root, "bf16_prior", family)
    widths = [*BF16_FAMILIES[family], "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES),
              "--device", DEVICE, "--bf16"]
    train = ["train", "--datadir", corpus, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir", ckpt,
             "--batch-size", str(PRIOR_BATCH),
             "--max-batches-per-epoch", str(PRIOR_BATCHES_PER_EPOCH), *widths]
    args = cli_prior.parse_args(train)
    spec = cli_prior.PriorSpec.from_args(args)
    transformer = spec.arch == "transformer"
    runs = {}
    for tag, argv, epochs in (("train", ["--epochs", str(BF16_EPOCHS)], BF16_EPOCHS),
                              ("resume", ["--epochs", str(BF16_EPOCHS + 1), "--resume"], 1)):
        runs[tag] = run = run_cli_prior(cli_prior, counters, train + argv)
        run["bf16_attention_launches"] = fa.bf16_launch_counts()
        steps = epochs * PRIOR_BATCHES_PER_EPOCH
        run["optimizer_steps"] = steps
        attn = dict.fromkeys(fa.KERNELS, PRIOR_LAYERS * steps if transformer else 0)
        check_prior_run(run, f"bf16 {family} {tag}", epochs,
                        {"vq_nearest": steps, "fused_adam": steps, **attn})
        check(run["bf16_attention_launches"] == attn,
              f"bf16 {family} {tag}: bf16 attention launches "
              f"{run['bf16_attention_launches']}, expected {attn}")
    nll = runs["train"]["epoch_nll"]
    check(nll[-1] < nll[0], f"bf16 {family}: the NLL did not fall ({nll})")
    extra = checkpoint.read_extra(ckpt)
    check(extra == {"epoch": BF16_EPOCHS + 1, **spec.metadata()},
          f"bf16 {family} checkpoint metadata {extra}")

    codes, _, vqvae, _ = encode_batch(torch, cli_prior, args, corpus, cli_prior.LATENT_STRIDE)
    del vqvae
    labels = torch.zeros(codes.shape[0], dtype=torch.int32, device=DEVICE)
    pcfg = prior_cfg(Config())
    batch = {"codes": codes, "labels": labels}
    compare, state = prior_step_card_vs_cpu(torch, checkpoint, spec, ckpt + "_train", pcfg,
                                            batch, f"bf16_{family}", PRIOR_BATCHES_PER_EPOCH,
                                            bf16=True)
    del state
    step_ms = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        state = create_train_state(spec.build(dtype=dtype).to(DEVICE), pcfg.train)
        checkpoint.restore(ckpt + "_train", state)
        step_ms[name] = 1e3 * prior_step_seconds(torch, state, pcfg, batch, PRIORS_TIMED_STEPS)
        del state

    # the cached logits against the forward (kernel 4's rounding of P is not
    # the cached step's): a routed model's decisions are compared too, and
    # its logits held up to each row's first routing flip
    prior = cli_prior.load_prior(ckpt, spec, DEVICE, torch.bfloat16)
    with record_routing(torch, prior) as fwd_routes, torch.no_grad():
        forward = prior(codes[:4], labels[:4])
    with record_step_routing(torch, prior) as step_routes:
        cached = (transformer_prior if transformer else pixelcnn).incremental_logits(
            prior, codes[:4], labels[:4])
    routing = None
    held = torch.ones(forward.shape[:3], dtype=torch.bool, device=forward.device)
    if fwd_routes:
        routing = routing_flips(torch, step_routes, fwd_routes, BF16_ROUTE_GAP)
        check(routing["flips"] == routing["near_ties"] + routing["cascade"],
              f"bf16 {family}: cached vs forward routing flips that are neither near-ties nor "
              f"cascades of one ({routing})")
        pos = torch.arange(held[0].numel(), device=held.device).reshape(held.shape[1:])
        held = pos[None] < torch.tensor(routing["first_flip"], device=held.device)[:, None, None]
    err = float(((cached - forward).abs() * held[..., None]).max())
    scale = float(forward.abs().max())
    check(err <= BF16_LOGIT_REL * scale,
          f"bf16 {family}: cached logits differ from the forward by {err} (largest {scale})")
    launches_per_code = sampler_launches(torch, prior, labels[:1])
    sampled = run_sample_cli(cli_prior, ["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt",
                                         ckpt + "_ema", *widths],
                             os.path.join(root, "bf16_prior", f"{family}_samples"),
                             "prior_sample", 4 * 28)
    return {"family": family, "parameters": sum(p.numel() for p in prior.parameters()),
            "runs": runs, "card_vs_cpu_step": compare,
            "cached_vs_forward": {"max_abs_err": err, "largest_logit": scale,
                                  "positions_held": int(held.sum()), "routing": routing},
            "train_step_ms": step_ms,
            "train_steps_per_s": {k: 1e3 / v for k, v in step_ms.items()},
            "bf16_over_f32_steps_per_s": step_ms["f32"] / step_ms["bf16"],
            "launches_per_code": launches_per_code, "sample_cli": sampled,
            "seconds": time.perf_counter() - t0}


@contextlib.contextmanager
def record_step_routing(torch, model):
    """The routing of every routed block's cached ``step`` while the
    context is open, as ``record_routing``'s list: per block (probs,
    expert, keep) over (B, T), in the order the positions ran."""
    from neural_sound_generation_tpu_torch.models.moe import SwitchMoE

    moes = [m for m in model.modules() if isinstance(m, SwitchMoE)]
    calls = {id(m): [] for m in moes}

    def wrap(moe):
        step = moe.step

        def recorded(h, counts, cap):
            probs, expert, _ = moe._route(h)
            calls[id(moe)].append((probs.cpu(), expert.cpu()))
            return step(h, counts, cap)
        return recorded

    for m in moes:
        m.step = wrap(m)
    routes = []
    try:
        yield routes
    finally:
        for m in moes:
            del m.step
    for m in moes:
        probs = torch.stack([p for p, _ in calls[id(m)]], dim=1)
        expert = torch.stack([e for _, e in calls[id(m)]], dim=1)
        routes.append((probs, expert, torch.ones_like(expert, dtype=torch.bool)))


def chunked_attention_check(torch, fa) -> dict:
    """``chunked_causal_attention`` at CHUNKED_SHAPE in f32 and bf16, forward
    and gradients, against kernel 4's plain pair (ATTN_F32_REL,
    ATTN_BF16_REL, relative to the plain output's largest magnitude floored
    at 1); the stock path's output against the chunked one; the peak memory
    a forward and backward allocates above its inputs, and its ms, for the
    chunked path, the kernels and the stock path."""
    from neural_sound_generation_tpu_torch.ops import attention

    name, bh, t, d = CHUNKED_SHAPE
    scale = d**-0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {"shape_name": name, "bh": bh, "t": t, "d": d}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        limit = ATTN_BF16_REL if tag == "bf16" else ATTN_F32_REL
        q, k, v, do = (torch.randn(1, bh, t, d, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        flat = [x[0].contiguous() for x in (q, k, v, do)]
        ro, _ = fa.flash_attention_fwd_plain(*flat[:3], scale)
        rdq, rdk, rdv = fa.flash_attention_bwd_plain(*flat[:3], ro, flat[3], scale)

        def fwd_bwd(fn):
            leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            o = fn(*leaves)
            return (o.detach(), *torch.autograd.grad(o, leaves, do))

        paths = {"chunked": lambda a, b, c: attention.chunked_causal_attention(a, b, c, scale),
                 "kernel": lambda a, b, c: attention.causal_attention(a, b, c, scale),
                 "stock": lambda a, b, c: attention.stock_causal_attention(a, b, c, scale)}
        got = fwd_bwd(paths["chunked"])

        def rel(a, b):
            return float((a.float() - b.float()).abs().max()
                         / max(float(b.float().abs().max()), 1.0))

        errs = {n: rel(g[0], w) for n, g, w in zip(("o", "dq", "dk", "dv"), got,
                                                   (ro, rdq, rdk, rdv))}
        check(max(errs.values()) <= limit,
              f"chunked attention {tag}: errors {errs} against the plain pair above {limit}")
        stock = fwd_bwd(paths["stock"])
        stock_err = rel(stock[0], got[0])
        check(stock_err <= limit,
              f"stock attention {tag}: output {stock_err} from the chunked one, above {limit}")
        peak, ms = {}, {}
        base = torch.cuda.memory_allocated()
        for path, fn in paths.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd(fn)
            torch.cuda.synchronize()
            peak[path] = torch.cuda.max_memory_allocated() - base
            ms[path] = time_ms(torch, lambda: fwd_bwd(fn), 5)
        out[tag] = {"rel_err_vs_plain": errs, "stock_vs_chunked_rel": stock_err,
                    "peak_bytes_fwd_bwd": peak, "fwd_bwd_ms": ms}
        del q, k, v, do, flat, ro, rdq, rdk, rdv, got, stock
    return out


def bf16_prior_phase(torch, cli_prior, checkpoint, counters, fa, root: str, vq_ckpt: str,
                     corpus: str, f32_prior_ckpt: str, hier: dict, card: str) -> dict:
    """Phase 15: ``cli.prior train|sample --bf16`` for the dense and the
    routed transformer and the PixelCNN (``bf16_family``); ``sample --bf16``
    from phase 7's float32 checkpoint (the dtype is not checked on
    restore); ``sample --hier --bf16`` from phase 12's checkpoints
    (``hier``: vq, top, bottom); chunked attention at T 2240."""
    t0 = time.perf_counter()
    families = {}
    for family in BF16_FAMILIES:
        families[family] = bf16_family(torch, cli_prior, checkpoint, counters, fa, root,
                                       vq_ckpt, corpus, family)
        emit({"phase": f"bf16_prior_{family}", "card": card, **families[family]})
        torch.cuda.empty_cache()
    common = ["--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES), "--device", DEVICE, "--bf16"]
    from_f32 = run_sample_cli(cli_prior, [
        "sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", f32_prior_ckpt,
        *BF16_FAMILIES["transformer"], *common],
        os.path.join(root, "bf16_prior", "from_f32_samples"), "prior_sample", 4 * 28)
    hier_sampled = run_sample_cli(cli_prior, [
        "sample", "--hier", "--vqvae-ckpt", hier["vq"], "--prior-ckpt", hier["top"],
        "--bottom-ckpt", hier["bottom"], *BF16_FAMILIES["transformer"],
        "--bottom-arch", "pixelcnn", "--bottom-dim", str(PIXELCNN_DIM),
        "--bottom-layers", str(PIXELCNN_LAYERS), "--code-shape", "10", "10", *common],
        os.path.join(root, "bf16_prior", "hier_samples"), "hier_sample", 80)
    chunked = chunked_attention_check(torch, fa)
    emit({"phase": "chunked_attention", "card": card, **chunked})
    runs = [r for f in families.values() for r in f["runs"].values()]
    return {"phase": "bf16_prior", "card": card, "seconds": time.perf_counter() - t0,
            "launches": {k: sum(r["launches"][k] for r in runs) for k in runs[0]["launches"]},
            "bf16_attention_launches": {k: sum(r["bf16_attention_launches"][k] for r in runs)
                                        for k in fa.KERNELS},
            "train_steps_per_s": {f: r["train_steps_per_s"] for f, r in families.items()},
            "launches_per_code": {f: r["launches_per_code"] for f, r in families.items()},
            "sample_from_f32_checkpoint": from_f32, "sample_hier": hier_sampled,
            "chunked_attention": chunked}


# ---------------------------------------------------------------------------
# Phase 16: the motion path
# ---------------------------------------------------------------------------

# cli.motion's defaults: a 600-frame capture of the synthetic hand (replayed
# at 60 fps), 16-frame windows (one 80 x 16 mel each, a 20 x 4 latent grid),
# 3 PCA components; the model at phase 5's full width from its checkpoint
MOTION_FRAMES = 600
MOTION_WINDOW = 16
MOTION_COMPONENTS = 3
MOTION_FPS = 60.0
MOTION_WARMUP_WINDOWS = 3  # left out of the per-window p50/p90
MOTION_MEL_ATOL = 1e-3
MOTION_GOLDEN = os.path.join("tests", "golden", "motion_golden.npz")


def run_cli_motion(cli_motion, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_motion.main(argv)
    return out.getvalue()


def motion_native_checks(motion_capture, repo: str) -> dict:
    """The port's native library: its feature count, the synthetic hand at
    seed 123 against the golden frames, and the C++ joint-angle extraction
    against the numpy formulas."""
    lib = motion_capture.load_library()
    check(lib.nsg_num_features() == 18, f"nsg_num_features() = {lib.nsg_num_features()}")
    c = motion_capture.synthetic_controller(seed=123, n_frames=16)
    try:
        frames = c.drain(16)
    finally:
        c.close()
    golden_err = float(np.abs(frames - np.load(os.path.join(repo, MOTION_GOLDEN))["frames"]).max())
    check(golden_err <= 1e-12, f"synthetic hand vs golden frames: {golden_err}")
    rng = np.random.default_rng(SEED)
    direction, normal = (v / np.linalg.norm(v) for v in rng.standard_normal((2, 3)))
    bones = rng.standard_normal((5, 4, 3))
    bones /= np.linalg.norm(bones, axis=-1, keepdims=True)
    got = motion_capture.extract_features_native(
        np.concatenate([direction, normal, bones.reshape(-1)]))
    want = [np.arctan2(direction[1], -direction[2]), np.arctan2(normal[0], -normal[1]),
            np.arctan2(direction[0], -direction[2])]
    want += [float(bones[f, b - 1] @ bones[f, b]) for f in range(5) for b in range(1, 4)]
    extract_err = float(np.abs(got - np.asarray(want)).max())
    check(extract_err <= 1e-12, f"joint-angle extraction vs numpy: {extract_err}")
    return {"library": str(motion_capture.library_path()), "golden_max_abs_err": golden_err,
            "extract_max_abs_err": extract_err}


def record_decode(model) -> tuple[dict, list]:
    """Hooks keeping what ``decode_from_features`` projects (B, D) and the
    codes it hands the decoder (B, D, H', W') on each call."""
    seen = {"emb": [], "codes": []}
    hooks = [model.feature_proj.register_forward_hook(
                 lambda m, i, o: seen["emb"].append(o.detach())),
             model.decoder.register_forward_pre_hook(
                 lambda m, i: seen["codes"].append(i[0].detach()))]
    return seen, hooks


def motion_decisions(torch, card: dict, cpu: dict, codebook) -> dict:
    """Card vs CPU nearest-code decisions of ``decode_from_features``, one a
    batch item: all H' x W' rows of an item are one vector, so a near-tie
    flips them together and counts once. A flip must be a near-tie
    (``near_ties``, the card's projection against the CPU's)."""
    cb = codebook.detach().double().cpu()
    emb_card = torch.cat(card["emb"]).double().cpu()
    emb_cpu = torch.cat(cpu["emb"]).double()
    idx = []
    for codes in (torch.cat(card["codes"]).cpu(), torch.cat(cpu["codes"])):
        rows = codes.flatten(2).transpose(1, 2)  # (B, H' W', D)
        check(bool((rows == rows[:, :1]).all()), "decode_from_features: rows of an item differ")
        idx.append(torch.cdist(rows[:, 0].double(), cb).argmin(1))
    n_items, n_rows = rows.shape[:2]
    flipped = torch.nonzero(idx[0] != idx[1]).flatten()
    near = int(near_ties(emb_cpu[flipped], emb_card[flipped], cb[idx[0][flipped]],
                         cb[idx[1][flipped]]).sum())
    check(near == flipped.numel(),
          f"motion: {flipped.numel() - near} of {flipped.numel()} card vs CPU code flips are "
          f"not near-ties")
    return {"decisions": n_items, "rows": n_items * n_rows,
            "flips": int(flipped.numel()), "near_ties": near, "agree": idx[0] == idx[1],
            "distinct_codes": int(idx[0].unique().numel())}


def mel_agreement(card_mels, cpu_mels, agree) -> float:
    """Largest card vs CPU mel difference over the items whose codes agree."""
    errs = [float(np.abs(a - b).max()) for a, b, ok in zip(card_mels, cpu_mels, agree) if ok]
    err = max(errs) if errs else 0.0
    check(err <= MOTION_MEL_ATOL, f"motion: mels differ by {err} where the codes agree")
    return err


def stream_windows(motion_capture, gen, csv: str) -> tuple[list, list]:
    """``run_stream`` over the whole recording: (windows, seconds of each,
    from the controller's drain to the mel on the host)."""
    ctrl = motion_capture.replay_controller(csv, fps=MOTION_FPS)
    it = gen.run_stream(ctrl, window=MOTION_WINDOW)
    windows, seconds = [], []
    try:
        while True:
            t0 = time.perf_counter()
            try:
                windows.append(next(it))
            except StopIteration:
                break
            seconds.append(time.perf_counter() - t0)
    finally:
        ctrl.close()
    return windows, seconds


def motion_kernel_rows(torch, vq_kernel, emb_window, emb_batch, codebook, hw: int) -> dict:
    """Kernel 1 against its plain version at the motion path's shapes: one
    window's 80 rows and the batched call's 48,000, each item's rows one
    vector (``compare_vq``: mismatched rows only at near-ties, bit-identical
    over two calls, times back to back and device-only beside
    cdist+argmin). At 80 rows the search is two 64-row tiles, so its CTAs
    cannot cover the SMs."""
    rows = {}
    for name, emb in (("window", emb_window), ("batched", emb_batch)):
        x = emb[:, None, :].expand(emb.shape[0], hw, emb.shape[1]).reshape(-1, emb.shape[1])
        row = compare_vq(torch, vq_kernel, x.contiguous(), codebook.detach().contiguous())
        row["shape_of"] = f"motion_{name}"
        emit(row)
        check(row["mismatches"] == row["near_ties"],
              f"vq_nearest motion {name}: {row['mismatches'] - row['near_ties']} mismatches "
              f"that are not near-ties")
        check(row["run_to_run_identical"], f"vq_nearest motion {name}: two calls differ")
        rows[name] = row
    return rows


def check_generated(path: str, sr: int, windows: int, hop: int) -> int:
    with open(path, "rb") as f:
        wav = read_wav(f.read(), sr)
    want = hop * (windows * MOTION_WINDOW - 1)
    check(len(wav) == want, f"{path}: {len(wav)} samples, expected {want}")
    return len(wav)


def motion_phase(torch, cli_motion, motion_capture, vq_kernel, VQVAE, root: str,
                 vq_ckpt: str, card: str) -> dict:
    """Phase 16: the native runtime's checks; ``cli.motion capture``,
    ``analyze``, ``watch`` and ``watch --gestures``; phase 5's full-width
    VQ-VAE restored through ``generate``'s rule into a feature-conditioned
    model, streamed over the whole capture and in one batched call on the
    card (kernel 1's launches counted over both) and on the CPU; kernel 1
    at those shapes; ``cli.motion generate`` on the card from the checkpoint
    and at the CLI's defaults."""
    import logging

    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.motion.inference import MotionDrivenGenerator
    from neural_sound_generation_tpu_torch.motion.pca import load_pca

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    mroot = os.path.join(root, "motion")
    os.makedirs(mroot, exist_ok=True)
    native = motion_native_checks(motion_capture, repo)
    emit({"phase": "motion_native", "card": card, **native})

    csv = os.path.join(mroot, "capture.csv")
    cli_out = {"capture": run_cli_motion(cli_motion, ["capture", csv, "--frames",
                                                      str(MOTION_FRAMES)])}
    check(f"recorded {MOTION_FRAMES} frames" in cli_out["capture"], cli_out["capture"])
    cli_out["analyze"] = run_cli_motion(cli_motion, ["analyze", csv])
    check(f"{MOTION_FRAMES} frames x 18 features -> {MOTION_COMPONENTS} components"
          in cli_out["analyze"], cli_out["analyze"])
    cli_out["watch"] = run_cli_motion(cli_motion, ["watch", "--frames", "20", "--fps", "500"])
    check("watched" in cli_out["watch"] and "pitch=" in cli_out["watch"], cli_out["watch"])
    t_gestures = time.perf_counter()
    gestures = run_cli_motion(cli_motion, ["watch", "--gestures", "--fps", "1000"])
    gestures_s = time.perf_counter() - t_gestures
    for word in ("Circle", "clockwise", "counterclockwise", "Swipe", "key_tap", "screen_tap"):
        check(word in gestures, f"watch --gestures printed no {word}")

    # the full-width model through generate's restore: only feature_proj filled
    wav_ckpt = os.path.join(mroot, "generate_ckpt.wav")
    gen_argv = ["generate", csv, wav_ckpt, "--ckpt-dir", vq_ckpt, "--dim", str(TRAIN_DIM),
                "--z-dim", str(TRAIN_CODES), "--components", str(MOTION_COMPONENTS),
                "--window", str(MOTION_WINDOW), "--device", DEVICE]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("nsg.checkpoint").addHandler(handler)
    try:
        model = cli_motion.build_model(cli_motion.parse_args(gen_argv))
    finally:
        logging.getLogger("nsg.checkpoint").removeHandler(handler)
    filled = [r.getMessage() for r in records]
    check(len(filled) == 1 and "'params/feature_proj'" in filled[0],
          f"generate's restore filled {filled}, expected params/feature_proj alone")
    cpu_model = VQVAE(1, TRAIN_DIM, TRAIN_CODES, cond_features=MOTION_COMPONENTS)
    cpu_model.load_state_dict(model.state_dict())
    cfg = Config().audio
    latent_hw = (cfg.num_mels // 4, MOTION_WINDOW // 4)
    projector = load_pca(csv, MOTION_COMPONENTS)
    frames = np.genfromtxt(csv, delimiter=",")
    n_windows = -(-MOTION_FRAMES // MOTION_WINDOW)
    gens, seen, hooks, runs = {}, {}, [], {}
    for side, dev, m in (("card", DEVICE, model), ("cpu", "cpu", cpu_model)):
        gens[side] = MotionDrivenGenerator(m, projector, cfg, latent_hw, device=dev)
        seen[side], h = record_decode(m)
        hooks += h

    # the main path on the card, kernel 1's count set to 0 just before it
    sync(torch)
    vq_kernel.reset_launch_count()
    windows, seconds = stream_windows(motion_capture, gens["card"], csv)
    t_batch = time.perf_counter()
    mel_batch = gens["card"].frames_to_mel(frames)
    sync(torch)
    batch_s = time.perf_counter() - t_batch
    launches = vq_kernel.launch_count()
    check(len(windows) == n_windows, f"run_stream yielded {len(windows)} windows")
    check(launches == n_windows + 1,
          f"motion: vq_nearest launched {launches} times, expected {n_windows} windows + 1")
    check(tuple(mel_batch.shape) == (MOTION_FRAMES, cfg.num_mels, MOTION_WINDOW),
          f"frames_to_mel: {tuple(mel_batch.shape)}")
    card_mels = [w[1] for w in windows]
    check(all(np.isfinite(m).all() for m in card_mels) and bool(torch.isfinite(mel_batch).all()),
          "motion: non-finite mel")

    cpu_windows, _ = stream_windows(motion_capture, gens["cpu"], csv)
    cpu_batch = gens["cpu"].frames_to_mel(frames)
    for h in hooks:
        h.remove()
    n = len(windows)
    stream = motion_decisions(torch, {k: v[:n] for k, v in seen["card"].items()},
                              {k: v[:n] for k, v in seen["cpu"].items()}, model.codebook)
    stream["mel_max_abs_err"] = mel_agreement(card_mels, [w[1] for w in cpu_windows],
                                              stream.pop("agree"))
    batched = motion_decisions(torch, {k: v[n:] for k, v in seen["card"].items()},
                               {k: v[n:] for k, v in seen["cpu"].items()}, model.codebook)
    batched["mel_max_abs_err"] = mel_agreement(mel_batch.cpu().numpy(), cpu_batch.numpy(),
                                               batched.pop("agree"))
    latents_err = max(float(np.abs(a[0] - b[0]).max()) for a, b in zip(windows, cpu_windows))

    # per window: host-included p50/p90 after a warm-up, and device-only
    # (the latents already on the card: the host-to-device copy of a
    # pageable array waits for the stream)
    timed = np.asarray(seconds[MOTION_WARMUP_WINDOWS:]) * 1e3
    pooled = torch.from_numpy(np.float32(
        projector.project(frames[:MOTION_WINDOW]).mean(axis=0, keepdims=True))).to(DEVICE)

    def decode_window():
        with torch.no_grad():
            model.decode_from_features(pooled, latent_hw)

    device_ms, host_us = device_time_ms(torch, decode_window, 20)
    audio_s = MOTION_WINDOW * cfg.effective_hop_size / cfg.sample_rate
    emb_window = seen["card"]["emb"][0]
    emb_batch = seen["card"]["emb"][n]
    kernel_rows = motion_kernel_rows(torch, vq_kernel, emb_window, emb_batch, model.codebook,
                                     latent_hw[0] * latent_hw[1])

    # cli.motion generate on the card: every window from the checkpoint,
    # then the CLI's defaults without one
    vq_kernel.reset_launch_count()
    gen_out = run_cli_motion(cli_motion, gen_argv + ["--max-windows", str(n_windows)])
    generate_launches = vq_kernel.launch_count()
    check(f"generated {n_windows} windows" in gen_out, gen_out)
    check(generate_launches == n_windows,
          f"generate launched vq_nearest {generate_launches} times for {n_windows} windows")
    samples = check_generated(wav_ckpt, cfg.sample_rate, n_windows, cfg.effective_hop_size)
    wav_default = os.path.join(mroot, "generate_default.wav")
    default_out = run_cli_motion(cli_motion, ["generate", csv, wav_default, "--device", DEVICE])
    check("generated 8 windows" in default_out, default_out)
    default_samples = check_generated(wav_default, cfg.sample_rate, 8, cfg.effective_hop_size)
    return {
        "phase": "motion", "card": card, "seconds": time.perf_counter() - t0,
        "native": native, "watch_gestures_s": gestures_s,
        "analyze": cli_out["analyze"].strip().splitlines(),
        "model": {"dim": TRAIN_DIM, "codes": TRAIN_CODES, "cond_features": MOTION_COMPONENTS,
                  "latent_hw": list(latent_hw), "restored_from": "phase 5 checkpoint",
                  "filled": filled},
        "windows": n_windows, "vq_launches": launches, "vq_launches_expected": n_windows + 1,
        "stream_card_vs_cpu": stream, "batched_card_vs_cpu": batched,
        "latents_max_abs_err": latents_err,
        "window_ms_p50": float(np.percentile(timed, 50)),
        "window_ms_p90": float(np.percentile(timed, 90)),
        "window_device_ms": device_ms, "window_host_us": host_us,
        "batched_600_frames_ms": 1e3 * batch_s,
        "window_motion_s": MOTION_WINDOW / MOTION_FPS, "window_audio_s": audio_s,
        "window_realtime_factor": audio_s / (1e-3 * float(np.percentile(timed, 50))),
        "kernel_rows": {name: {k: r[k] for k in (
            "n", "k", "d", "kernel_ms", "kernel_device_ms", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by", "tensor_core_bound_ms",
            "mismatches", "near_ties", "split", "ctas", "sms")} for name, r in kernel_rows.items()},
        "generate": {"windows": n_windows, "samples": samples, "vq_launches": generate_launches,
                     "default_samples": default_samples},
    }, kernel_rows


# ---------------------------------------------------------------------------
# Phase 17: data parallelism over ranks (the mesh's data axis, torchrun)
# ---------------------------------------------------------------------------

DP_WORLD = 2
DP_EPOCHS = 2  # the flagship's epochs a run, BATCHES_PER_EPOCH steps and an eval batch each
DP_JOB_STEPS = 2  # the routed prior's and the vocoder's steps a run
DP_ALLREDUCE_ITERS = 10
DP_TIMEOUT_S = 480
# the flagship's first step, W ranks against one: the all-reduced flat
# gradient within 1e-4 of the one-rank gradient's norm (2e-3 when a code
# flipped: the row's codebook gradient lands on another code); the loss
# within 1e-5; after Adam's first step (the CLI's lr DP_LR) 99.9% of the
# weights within 1e-5 and all within 1e-2, the biases within 2 lr (a
# convolution bias ahead of a BatchNorm has a true gradient of 0, which
# Adam turns into a step of up to lr either way)
DP_LR = 1e-3
DP_GRAD_REL, DP_GRAD_REL_FLIPS, DP_LOSS_REL = 1e-4, 2e-3, 1e-5
DP_EVAL_PPL_REL, DP_RECON_MEAN_ABS = 1e-3, 1e-3


def dp_jobs(root: str, corpus: str, vq_ckpt: str, world: int) -> list[dict]:
    """What one torchrun launch of ``world`` ranks runs, in order, through
    the CLIs' entry points: the flagship through ``cli.main`` (and, on more
    than one rank, one --resume step), ``cli.evaluate`` on the one-rank
    flagship checkpoint, one RVQ/bf16 step (phase 6's flags), the routed
    prior (phase 14's widths) and the mulaw-quantize vocoder (phase 13's
    speaker preset, its default width)."""
    out = os.path.join(root, "dp", f"w{world}")
    flagship = ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", corpus,
                "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES),
                "--batch-size", str(TRAIN_BATCH), "--log-interval", "1",
                "--codebook-init", "data", "--device", DEVICE,
                "--ckpt-dir", os.path.join(out, "flagship", "models"),
                "--sampledir", os.path.join(out, "flagship", "results"),
                "--mesh-data", str(world)]
    one_rank_ckpt = os.path.join(root, "dp", "w1", "flagship", "models", "vqvae",
                                 f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    cmu = os.path.join(root, "preprocess", "cmu_arctic_on_card")
    preset = os.path.join(root, "dp", "cmu_arctic_8bit_speakers.json")
    jobs = [
        {"name": "flagship", "cli": "main", "record_first_vq": True,
         "argv": flagship + ["--epochs", str(DP_EPOCHS),
                             "--max-batches-per-epoch", str(BATCHES_PER_EPOCH)]},
        {"name": "evaluate", "cli": "evaluate",
         "argv": ["--datadir", corpus, "--ckpt-dir", one_rank_ckpt, "--dim", str(TRAIN_DIM),
                  "--z-dim", str(TRAIN_CODES), "--batch-size", str(TRAIN_BATCH),
                  "--max-batches", "1", "--device", DEVICE, "--mesh-data", str(world),
                  "--dump-npy", os.path.join(out, "evaluate.npy")]},
        {"name": "rvq", "cli": "main", "record_indices": True,
         "argv": rvq_argv(os.path.join(out, "rvq"), corpus) + [
             "--bf16", "--epochs", "1", "--max-batches-per-epoch", "1",
             "--mesh-data", str(world)]},
        {"name": "moe_prior", "cli": "prior",
         "argv": ["train", "--datadir", corpus, "--vqvae-ckpt", vq_ckpt,
                  "--ckpt-dir", os.path.join(out, "moe_prior"), "--batch-size", str(PRIOR_BATCH),
                  "--epochs", "1", "--max-batches-per-epoch", str(DP_JOB_STEPS),
                  "--arch", "transformer", "--prior-dim", str(PRIOR_DIM),
                  "--prior-layers", str(PRIOR_LAYERS), "--moe-experts", str(MOE_EXPERTS),
                  "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES), "--device", DEVICE,
                  "--mesh-data", str(world)]},
        {"name": "vocoder", "cli": "vocoder", "preset": preset,
         "argv": ["train", "--datadir", cmu, "--ckpt-dir", os.path.join(out, "vocoder"),
                  "--preset", preset, "--batch-size", str(VT_BATCH), "--epochs", "1",
                  "--max-batches-per-epoch", str(DP_JOB_STEPS), "--device", DEVICE,
                  *vocoder_width_flags(), "--mesh-data", str(world)]},
    ]
    if world > 1:
        jobs.insert(1, {"name": "flagship_resume", "cli": "main",
                        "argv": flagship + ["--epochs", str(DP_EPOCHS + 1),
                                            "--max-batches-per-epoch", "1", "--resume"]})
    return jobs


def state_digest(torch, state) -> str:
    """sha256 over every tensor of a train state: the parameters, moments,
    EMA shadow, EMA-codebook statistics and the model's buffers."""
    import hashlib

    h = hashlib.sha256()
    tensors = [state.flat.flat, state.opt_state.m, state.opt_state.v, state.step]
    tensors += [t for t in (state.ema_params,) if t is not None]
    tensors += list((state.codebook_ema or {}).values()) + list(state.model.buffers())
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def run_dp_job(torch, mods, kernels, job: dict) -> dict:
    """One CLI run on this rank with every launch count set to 0 just
    before it and read just after; the Trainer the CLI builds is wrapped to
    time and record each step (metrics, and after the first the all-reduced
    flat gradient and the parameters), and the nearest-code wrapper to
    record each search's rows (and, where the job asks, its indices or its
    first call's inputs)."""
    from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel
    from neural_sound_generation_tpu_torch.training import trainer as trainer_mod

    cli = mods[job["cli"]]
    rec = {"metrics": [], "step_t": [], "vq_rows": [], "vq_indices": []}
    trainers = []

    class Recorded(trainer_mod.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)
            inner = self._train_step

            def step(state, batch, generator=None):
                state, metrics = inner(state, batch, generator)
                sync(torch)
                rec["step_t"].append(time.perf_counter())
                rec["metrics"].append({k: float(v) for k, v in metrics.items()})
                if len(rec["metrics"]) == 1:
                    rec["first_grad"] = state.flat.grad.cpu().clone()
                    rec["first_params"] = state.flat.flat.cpu().clone()
                return state, metrics

            self._train_step = step

    nearest = vq_kernel.nearest_codebook_indices

    def recorded_nearest(x, cb):
        idx = nearest(x, cb)
        rec["vq_rows"].append(int(x.shape[0]))
        if job.get("record_indices"):
            rec["vq_indices"].append(idx.cpu())
        if job.get("record_first_vq") and rec["metrics"] == [] and "first_vq" not in rec:
            rec["first_vq"] = {"x": x.cpu(), "cb": cb.cpu(), "idx": idx.cpu()}
        return idx

    saved_trainer = cli.Trainer
    cli.Trainer, vq_kernel.nearest_codebook_indices = Recorded, recorded_nearest
    for k in kernels:
        k.reset_launch_count()
    t0 = time.perf_counter()
    try:
        result = cli.main(job["argv"])
    finally:
        cli.Trainer, vq_kernel.nearest_codebook_indices = saved_trainer, nearest
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = read_launches(*kernels)
    if job["cli"] == "evaluate":
        rec["means"] = result
    if trainers or pp_states:
        state = trainers[-1].state if trainers else pp_states[-1]
        rec["digest"] = state_digest(torch, state)
        if state.codebook_ema is not None:
            rec["codebook"] = state.model.codebook.detach().cpu().clone()
            rec["codebook_ema"] = {k: v.cpu().clone() for k, v in state.codebook_ema.items()}
    return rec


def time_all_reduce(torch, n: int, iters: int) -> float:
    """ms of one all-reduce of n float32 on the card over the current
    group (host clock around each call, synchronised), the median."""
    import torch.distributed as dist

    t = torch.ones(n, device=DEVICE)
    times = []
    for i in range(iters + 2):
        sync(torch)
        t0 = time.perf_counter()
        dist.all_reduce(t)
        sync(torch)
        if i >= 2:
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def dp_rank_main(spec_path: str) -> int:
    """One rank of a phase-17 launch (``chip_smoke.py --dp-rank spec.json``
    under torchrun): joins the group with the port's backend rule, runs the
    spec's jobs in order, times the all-reduce of the flagship's gradient
    and writes one record per job."""
    import torch
    import torch.distributed as dist

    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
    from neural_sound_generation_tpu_torch.ops.cuda import fused_adam, vq_kernel
    from neural_sound_generation_tpu_torch.parallel import distributed

    global DEVICE
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    DEVICE = spec["device"]
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    set_full_float32()
    distributed.initialize(device=DEVICE)
    rank, world = distributed.rank(), distributed.world_size()
    mods = tp_cli_modules()
    for job in spec["jobs"]:
        rec = run_dp_job(torch, mods, (vq_kernel, fused_adam, fa), job)
        torch.save(rec, os.path.join(spec["out"], f"{job['name']}_rank{rank}.pt"))
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    timing = {"backend": dist.get_backend() if dist.is_initialized() else None}
    if not dist.is_initialized():
        # one rank has no group; time NCCL's all-reduce in a group of one
        timing["backend"] = "nccl" if DEVICE == "cuda" else "gloo"
        dist.init_process_group(timing["backend"], world_size=1, rank=0,
                                init_method="file://" + os.path.join(spec["out"], "group_of_one"))
    timing["all_reduce_ms"] = time_all_reduce(torch, spec["grad_elems"], DP_ALLREDUCE_ITERS)
    timing["world"] = world
    with open(os.path.join(spec["out"], f"timing_rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(timing, f)
    dist.barrier()
    distributed.shutdown()
    return 0


def launch_dp(torch, root: str, jobs: list, world: int, grad_elems: int) -> dict:
    """One torchrun launch of ``world`` ranks on this card; every rank's
    records. A rank's failure fails the phase."""
    out = os.path.join(root, "dp", f"w{world}")
    os.makedirs(out, exist_ok=True)
    spec = os.path.join(out, "spec.json")
    with open(spec, "w", encoding="utf-8") as f:
        json.dump({"jobs": jobs, "out": out, "grad_elems": grad_elems, "device": DEVICE}, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    # one thread a rank at any W, as torchrun sets it for more than one
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(world), os.path.abspath(__file__), "--dp-rank", spec],
        cwd=repo, env=env, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"torchrun with {world} ranks exited {proc.returncode}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    ranks = [{job["name"]: torch.load(os.path.join(out, f"{job['name']}_rank{r}.pt"),
                                      weights_only=False) for job in jobs}
             for r in range(world)]
    timing = [json.load(open(os.path.join(out, f"timing_rank{r}.json"), encoding="utf-8"))
              for r in range(world)]
    return {"ranks": ranks, "timing": timing, "seconds": seconds, "stdout": proc.stdout}


def dp_step_rate(rec: dict) -> float:
    """Steps/s from the intervals between synchronised step ends, after
    the first two steps (kernel loads and the allocator's warm-up)."""
    gaps = np.diff(rec["step_t"])[1:]
    return float(1.0 / np.median(gaps))


def dp_rank_mean(ranks: list, job: str, step: int, key: str) -> float:
    """A step's metric over the global batch: the mean of the ranks'
    (equal rows a rank; a masked mean's share is already scaled)."""
    return float(np.mean([r[job]["metrics"][step][key] for r in ranks]))


def dp_grad_rel(one: dict, many: dict) -> float:
    g1, g2 = one["first_grad"], many["first_grad"]
    return float((g2 - g1).norm() / g1.norm())


def check_dp_launches(ranks: list, job: str, want: dict, rows: int | None = None) -> list:
    """Every rank's launch counts against ``want``; every training search
    at ``rows`` rows where given. Returns the per-rank counts."""
    counts = []
    for r, rank in enumerate(ranks):
        got = rank[job]["launches"]
        for k, n in want.items():
            check(got[k] == n, f"data parallel {job} rank {r}: {k} launched {got[k]} times, "
                  f"expected {n}")
        if rows is not None:
            check(set(rank[job]["vq_rows"]) == {rows},
                  f"data parallel {job} rank {r}: searches at {set(rank[job]['vq_rows'])} rows, "
                  f"expected {rows}")
        counts.append(got)
    return counts


def check_ranks_equal(ranks: list, job: str) -> None:
    digests = [r[job]["digest"] for r in ranks]
    check(len(set(digests)) == 1, f"data parallel {job}: the ranks' states differ ({digests})")


def flagship_flips(torch, one: dict, many: list) -> dict:
    """The first step's code flips, W ranks (their rows in rank order)
    against one rank; each must be a near-tie."""
    a = one["first_vq"]
    x2 = torch.cat([r["first_vq"]["x"] for r in many])
    i2 = torch.cat([r["first_vq"]["idx"] for r in many])
    cb_err = float((a["cb"] - many[0]["first_vq"]["cb"]).abs().max())
    check(cb_err <= 1e-5, f"data parallel flagship: the runs' data-init codebooks {cb_err} apart")
    flipped = (a["idx"] != i2).nonzero()[:, 0]
    cb = a["cb"].double()
    ties = near_ties(a["x"][flipped].double(), x2[flipped].double(),
                     cb[i2[flipped].long()], cb[a["idx"][flipped].long()])
    return {"rows": int(a["idx"].numel()), "flips": int(flipped.numel()),
            "near_ties": int(ties.sum()),
            "x_max_abs_err": float((x2 - a["x"]).abs().max()), "codebook_max_abs_err": cb_err}


def rvq_ema_compare(torch, one: dict, many: list) -> dict:
    """The RVQ step's EMA statistics, W ranks against one. Searches 4-7 of
    the run are the step's EMA branch (after 3 data-init searches and the
    step's 4 forward ones); a flip there moves one count from a code to
    another, so the clusters (0.99 old + 0.01 count, exact for equal
    counts) may differ by at most 2 x 0.01 x flips in all, and a restart
    (count 0) may change for at most 2 x flips codes."""
    ema_calls = slice(3 + RVQ_Q, 3 + 2 * RVQ_Q)
    i1 = one["vq_indices"][ema_calls]
    i2 = [torch.cat(parts) for parts in zip(*(r["vq_indices"][ema_calls] for r in many))]
    stage_flips = [int((a != b).sum()) for a, b in zip(i1, i2)]
    flips = sum(stage_flips)
    c1, c2 = one["codebook_ema"]["cluster"], many[0]["codebook_ema"]["cluster"]
    e1, e2 = one["codebook_ema"]["embed_sum"], many[0]["codebook_ema"]["embed_sum"]
    restarted = [(c == 1.0) & (e == cb).all(-1) for c, e, cb in (
        (c1, e1, one["codebook"]), (c2, e2, many[0]["codebook"]))]
    both = restarted[0] & restarted[1]
    kept = ~restarted[0] & ~restarted[1]
    scale = float(e1.abs().max())
    return {"flips": flips, "flips_by_stage": stage_flips, "rows": int(sum(a.numel() for a in i1)),
            "cluster_abs_diff_sum": float((c1 - c2)[kept].abs().sum()),
            "restarted": [int(r.sum()) for r in restarted],
            "restart_set_diff": int((restarted[0] ^ restarted[1]).sum()),
            "embed_sum_kept_max_rel": float((e1 - e2)[kept].abs().max()) / scale,
            "restarted_rows_max_rel": float(
                (one["codebook"] - many[0]["codebook"])[both].abs().max()) / scale
            if bool(both.any()) else 0.0}


def data_parallel_phase(torch, root: str, corpus: str, vq_ckpt: str, card: str) -> dict:
    """Phase 17: the training CLIs under torchrun at W = 1 (no group: the
    one-rank program) and W = 2 (gloo: the two ranks share this card), and
    the checks that W ranks compute the one-rank steps."""
    from neural_sound_generation_tpu_torch.models import VQVAE
    from neural_sound_generation_tpu_torch.training.train_state import FlatParams

    t0 = time.perf_counter()
    shutil.rmtree(os.path.join(root, "dp"), ignore_errors=True)
    os.makedirs(os.path.join(root, "dp"))
    with open(os.path.join(root, "dp", "cmu_arctic_8bit_speakers.json"), "w",
              encoding="utf-8") as f:
        json.dump({**CMU_PRESET, "exponential_moving_average": False,
                   "gin_channels": VT_SPEAKER_GIN, "initial_learning_rate": VT_LR}, f)
    n_params = sum(p.numel() for p in VQVAE(1, TRAIN_DIM, TRAIN_CODES).parameters())
    runs = {w: launch_dp(torch, root, dp_jobs(root, corpus, vq_ckpt, w), w, n_params)
            for w in (1, DP_WORLD)}
    one, many = runs[1]["ranks"][0], runs[DP_WORLD]["ranks"]
    rows = TRAIN_BATCH * (80 // 4) * (28 // 4)
    steps = DP_EPOCHS * BATCHES_PER_EPOCH

    # the flagship: launches per rank, the first step W against 1, the ranks bit-equal
    flag = {"launches": {
        w: check_dp_launches(runs[w]["ranks"], "flagship",
                             {"fused_adam": steps, "vq_nearest": steps + 2 * DP_EPOCHS}, rows // w)
        for w in runs}}
    check_ranks_equal(many, "flagship")
    flips = flagship_flips(torch, one["flagship"], [r["flagship"] for r in many])
    check(flips["near_ties"] == flips["flips"],
          f"data parallel flagship: {flips['flips'] - flips['near_ties']} code flips that are "
          "not near-ties")
    loss1 = one["flagship"]["metrics"][0]["loss"]
    loss2 = dp_rank_mean(many, "flagship", 0, "loss")
    grad_rel = dp_grad_rel(one["flagship"], many[0]["flagship"])
    diff = FlatParams(VQVAE(1, TRAIN_DIM, TRAIN_CODES)).named(
        (many[0]["flagship"]["first_params"] - one["flagship"]["first_params"]).abs())
    bias = torch.cat([t.reshape(-1) for k, t in diff.items() if k.endswith(".bias")])
    rest = torch.cat([t.reshape(-1) for k, t in diff.items() if not k.endswith(".bias")])
    far = float((rest > 1e-5).float().mean())
    flag.update(first_step={"loss_w1": loss1, "loss_w2": loss2,
                            "loss_rel": abs(loss2 - loss1) / abs(loss1), "grad_rel": grad_rel,
                            "weights_beyond_1e-5_frac": far, "weights_max_abs_err": float(rest.max()),
                            "biases_max_abs_err": float(bias.max()),
                            **flips})
    check(abs(loss2 - loss1) <= DP_LOSS_REL * abs(loss1),
          f"data parallel flagship: first loss {loss2} on {DP_WORLD} ranks, {loss1} on one")
    check(grad_rel <= (DP_GRAD_REL_FLIPS if flips["flips"] else DP_GRAD_REL),
          f"data parallel flagship: all-reduced gradient {grad_rel:.3g} of the norm away "
          f"({flips['flips']} flips)")
    check(far <= 1e-3 and float(rest.max()) <= 1e-2 and float(bias.max()) <= 2.01 * DP_LR,
          f"data parallel flagship: {far:.3%} of the weights beyond 1e-5, max "
          f"{float(rest.max())}; biases {float(bias.max())} apart")
    losses = [dp_rank_mean(many, "flagship", i, "loss") for i in range(steps)]
    check(losses[-1] < losses[0], f"data parallel flagship: the loss did not fall ({losses})")
    flag["losses_w1"] = [m["loss"] for m in one["flagship"]["metrics"]]
    flag["losses_w2"] = losses
    flag["steps_per_s"] = {w: dp_step_rate(runs[w]["ranks"][0]["flagship"]) for w in runs}
    # the resumed step
    check_dp_launches(many, "flagship_resume", {"fused_adam": 1, "vq_nearest": 1 + 2},
                      rows // DP_WORLD)
    check_ranks_equal(many, "flagship_resume")
    resumed = os.path.join(root, "dp", f"w{DP_WORLD}", "flagship", "models", "vqvae",
                           f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    want = {f"step_{BATCHES_PER_EPOCH * e}" for e in range(1, DP_EPOCHS + 1)} | {
        f"step_{steps + 1}"}
    check(set(os.listdir(resumed)) == want,
          f"data parallel --resume: checkpoints {sorted(os.listdir(resumed))}, expected {want}")

    # cli.evaluate --mesh-data 2 on the one-rank checkpoint
    m1, m2 = one["evaluate"]["means"], many[0]["evaluate"]["means"]
    check(m1.keys() == m2.keys() and all(
        abs(m2[k] - m1[k]) <= (DP_EVAL_PPL_REL if k == "perplexity" else DP_LOSS_REL) * abs(m1[k])
        for k in m1), f"data parallel evaluate: {m2} on {DP_WORLD} ranks, {m1} on one")
    r1, r2 = (np.load(os.path.join(root, "dp", f"w{w}", "evaluate.npy")) for w in runs)
    recon_err = float(np.abs(r1 - r2).mean()) if r1.shape == r2.shape else float("inf")
    check(r1.shape == r2.shape and recon_err <= DP_RECON_MEAN_ABS,
          f"data parallel evaluate: reconstruction {r2.shape} vs {r1.shape}, mean |diff| "
          f"{recon_err}")
    check_dp_launches([r for w in runs for r in runs[w]["ranks"]], "evaluate", {"vq_nearest": 2})

    # RVQ in bf16 with EMA codebooks, restarts and data init: one step
    for w in runs:
        check_dp_launches(runs[w]["ranks"], "rvq",
                          {"fused_adam": 1, "vq_nearest": 3 + 2 * RVQ_Q + 2 * RVQ_Q})
        for r in runs[w]["ranks"]:
            check(r["rvq"]["vq_rows"][:3] == [rows] * 3 and
                  set(r["rvq"]["vq_rows"][3:]) == {rows // w},
                  f"data parallel rvq: searches at {r['rvq']['vq_rows']} rows")
    check_ranks_equal(many, "rvq")
    rvq = rvq_ema_compare(torch, one["rvq"], [r["rvq"] for r in many])
    check(rvq["cluster_abs_diff_sum"] <= 2 * 0.01 * rvq["flips"] + 1e-4
          and rvq["restart_set_diff"] <= 2 * rvq["flips"],
          f"data parallel rvq: EMA statistics differ beyond the step's flips {rvq}")

    # the routed prior and the mulaw-quantize vocoder
    jobs = {}
    for job, want in (("moe_prior", {"vq_nearest": DP_JOB_STEPS, "fused_adam": DP_JOB_STEPS,
                                     **{k: PRIOR_LAYERS * DP_JOB_STEPS for k in (
                                         "flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}}),
                      ("vocoder", {"fused_adam": DP_JOB_STEPS, "vq_nearest": 0})):
        for w in runs:
            check_dp_launches(runs[w]["ranks"], job, want)
        check_ranks_equal(many, job)
        key = "loss"
        l1, l2 = one[job]["metrics"][0][key], dp_rank_mean(many, job, 0, key)
        rec = {"loss_w1": l1, "loss_w2": l2, "loss_rel": abs(l2 - l1) / abs(l1),
               "grad_rel": dp_grad_rel(one[job], many[0][job])}
        if job == "moe_prior":
            a1 = one[job]["metrics"][0]["moe_load_balance"]
            a2 = many[0][job]["metrics"][0]["moe_load_balance"]
            rec.update(load_balance_w1=a1, load_balance_w2=a2, load_balance_rel=abs(a2 - a1) / a1)
            check(rec["load_balance_rel"] <= DP_LOSS_REL,
                  f"data parallel moe prior: load balance {a2} vs {a1}")
        check(rec["loss_rel"] <= DP_LOSS_REL and rec["grad_rel"] <= DP_GRAD_REL,
              f"data parallel {job}: first step {rec}")
        jobs[job] = rec

    timing = {w: runs[w]["timing"][0] for w in runs}
    return {
        "phase": "data_parallel", "card": card, "world": DP_WORLD,
        "backend": {w: timing[w]["backend"] for w in runs},
        "note": "two ranks on one card share it: steps/s at W 2 measures the collectives' "
                "cost, not scaling",
        "flagship": flag, "rvq_first_step": rvq, "jobs": jobs,
        "all_reduce_ms": {f"w{w}_{timing[w]['backend']}": timing[w]["all_reduce_ms"]
                          for w in runs},
        "grad_elems": n_params,
        "launches": {f"w{w}": [{job: r[job]["launches"] for job in r} for r in runs[w]["ranks"]]
                     for w in runs},
        "launch_seconds": {f"w{w}": runs[w]["seconds"] for w in runs},
        "seconds": time.perf_counter() - t0,
    }


# ---------------------------------------------------------------------------
# Phase 18: tensor parallelism (the mesh's model axis, torchrun)
# ---------------------------------------------------------------------------

TP_MODEL = 2
TP_WORLDS = (2, 4)  # (data 1 x model 2), (data 2 x model 2)
TP_SHARDS = (2, 4)  # the direct kernel check's codebook shards
TP_TIMEOUT_S = 720  # a launch that phases 18-22 share (some 300 s at W 2)
#: the ranks' loaders take the Python collate (a measurement's other arm:
#: ``scripts/torch_parallel_phases.py --python-collate``); False in the smoke
PYTHON_COLLATE = False
TP_COLLECTIVE_ITERS = 5
# the header's bound on a winning score (csrc/vq_nearest.cu: "some 1e-4
# absolute at |x| = |e| = 16"), scaled by |x| |e| / 256 for other norms
VQ_SCORE_ABS_AT_256 = 1e-4


def sharded_search_check(torch, vq_kernel, vq_ops, gen) -> dict:
    """Kernel 1 at the flagship step's search (N 8,960, K 512, D 256): the
    codebook split into M row shards, one launch a shard with the scores,
    the shards merged (``ops.vq.merge_shards``) against one whole-codebook
    launch: the indices and the winning scores bit-equal. The kernel's
    winning scores against float64 within the header's bound, and the
    plain version's for comparison."""
    n, k = VQ_TRAIN_SHAPE
    x = torch.randn(n, VQ_D, generator=gen, device="cuda")
    cb = torch.randn(k, VQ_D, generator=gen, device="cuda")
    idx, score = vq_kernel.nearest_codebook_indices(x, cb, return_scores=True)
    p_idx, p_score = vq_kernel.nearest_codebook_indices_plain(x, cb, return_scores=True)
    torch.cuda.synchronize()
    x64, e64 = x.double(), cb[idx.long()].double()
    exact = (e64 * e64).sum(1) - 2.0 * (x64 * e64).sum(1)
    p_e64 = cb[p_idx.long()].double()
    p_exact = (p_e64 * p_e64).sum(1) - 2.0 * (x64 * p_e64).sum(1)
    bound = VQ_SCORE_ABS_AT_256 * float((x.norm(dim=1) * cb.norm(dim=1).max()).max()) / 256.0
    row = {"phase": "kernel", "name": "vq_nearest_sharded", "n": n, "k": k, "d": VQ_D,
           "score_max_abs_err_vs_float64": float((score.double() - exact).abs().max()),
           "plain_score_max_abs_err_vs_float64": float((p_score.double() - p_exact).abs().max()),
           "score_bound": bound,
           "kernel_vs_plain_index_mismatches": int((idx != p_idx).sum())}
    check(row["score_max_abs_err_vs_float64"] <= bound,
          f"vq_nearest scores {row['score_max_abs_err_vs_float64']} from float64, bound {bound}")
    for m in TP_SHARDS:
        kl = k // m
        parts = [vq_kernel.nearest_codebook_indices(x, cb[r * kl:(r + 1) * kl].contiguous(),
                                                    return_scores=True) for r in range(m)]
        merged = vq_ops.merge_shards(torch.stack([s for _, s in parts]),
                                     torch.stack([i.long() + r * kl
                                                  for r, (i, _) in enumerate(parts)]))
        best = torch.stack([s for _, s in parts]).min(dim=0).values
        row[f"m{m}"] = {"k_shard": kl, "index_mismatches": int((merged != idx).sum()),
                        "score_mismatches": int((best != score).sum()),
                        "plan": vq_kernel.launch_plan(x, cb[:kl].contiguous())}
        check(torch.equal(merged, idx) and torch.equal(best, score),
              f"vq_nearest over {m} shards: {row[f'm{m}']} against one whole-codebook launch")
    iters = 50
    shard = cb[:k // TP_MODEL].contiguous()
    bound_ms, bound_by = vq_bound_ms(n, k // TP_MODEL, VQ_D)
    row["shard_k256"] = {
        "ms": time_ms(torch, lambda: vq_kernel.nearest_codebook_indices(
            x, shard, return_scores=True), iters),
        "device_ms": device_time_ms(torch, lambda: vq_kernel.nearest_codebook_indices(
            x, shard, return_scores=True), iters)[0],
        "plain_ms": time_ms(torch, lambda: vq_kernel.nearest_codebook_indices_plain(
            x, shard, return_scores=True), iters),
        "library_ms": time_ms(torch, lambda: torch.cdist(x, shard).min(dim=1), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "bound_3xtf32_ms": vq_tensor_core_bound_ms(n, k // TP_MODEL, VQ_D)}
    return row


def tp_jobs(root: str, corpus: str, world: int) -> list[dict]:
    """What one torchrun launch of ``world`` ranks runs with --mesh-model
    TP_MODEL: the flagship through ``cli.main`` with phase 17's flagship
    flags; at W 2 also one --resume step from phase 17's W 1 checkpoint
    (copied first), ``cli.evaluate`` on that checkpoint and one RVQ/bf16
    step (phase 6's flags)."""
    out = os.path.join(root, "tp", f"w{world}")
    mesh = ["--mesh-model", str(TP_MODEL), "--mesh-data", str(world // TP_MODEL)]

    def flagship(tag: str, *extra) -> list:
        return ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", corpus,
                "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES),
                "--batch-size", str(TRAIN_BATCH), "--log-interval", "1",
                "--codebook-init", "data", "--device", DEVICE,
                "--ckpt-dir", os.path.join(out, tag, "models"),
                "--sampledir", os.path.join(out, tag, "results"), *mesh, *extra]

    jobs = [{"name": "flagship", "cli": "main", "record_first_vqs": True,
             "argv": flagship("flagship", "--epochs", str(DP_EPOCHS),
                              "--max-batches-per-epoch", str(BATCHES_PER_EPOCH))}]
    if world != TP_WORLDS[0]:
        return jobs
    one_rank = os.path.join(root, "dp", "w1", "flagship", "models")
    ckpt = os.path.join(one_rank, "vqvae", f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    return jobs + [
        {"name": "resume", "cli": "main", "copy": [one_rank, os.path.join(out, "resume",
                                                                         "models")],
         "argv": flagship("resume", "--epochs", str(DP_EPOCHS + 1),
                          "--max-batches-per-epoch", "1", "--resume")},
        {"name": "evaluate", "cli": "evaluate",
         "argv": ["--datadir", corpus, "--ckpt-dir", ckpt, "--dim", str(TRAIN_DIM),
                  "--z-dim", str(TRAIN_CODES), "--batch-size", str(TRAIN_BATCH),
                  "--max-batches", "1", "--device", DEVICE, *mesh,
                  "--dump-npy", os.path.join(out, "evaluate.npy")]},
        {"name": "rvq", "cli": "main", "argv": rvq_argv(os.path.join(out, "rvq"), corpus) + [
            "--bf16", "--epochs", "1", "--max-batches-per-epoch", "1", *mesh]},
    ]


def tp_digests(torch, state) -> dict:
    """sha256 over this rank's whole local state, and over its replicated
    part alone (the flat buffers past ``split_at``)."""
    import hashlib

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy()
                     .tobytes())
        return h.hexdigest()

    cut = state.flat.split_at
    vectors = [state.flat.flat, *state.opt_state.moments()]
    if state.ema_params is not None:
        vectors.append(state.ema_params)
    return {"local": state_digest(torch, state),
            "replicated": digest([v[cut:] for v in vectors])}


def run_tp_job(torch, mods, kernels, job: dict) -> dict:
    """One CLI run on this rank with every launch count set to 0 just
    before it and read just after (phase 17's ``run_dp_job`` with the
    model axis): each step's metrics and end time; the first step's
    gradient and parameters gathered over the model group, by name (on
    rank 0: they are the same on every rank); each search's rows and codebook shard; each search of the first step (its
    rows, codebook shard and global indices); with ``record_first_state``
    the model's state and the batch the first step starts from; kernel 3's
    n; the collectives of the first step. A pipe job's steps
    (``parallel.pipeline.PipelineStep``) are recorded alike, with the
    hand-offs' host seconds and bytes."""
    from neural_sound_generation_tpu_torch.ops import vq as vq_ops
    from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel
    from neural_sound_generation_tpu_torch.parallel import distributed
    from neural_sound_generation_tpu_torch.parallel import mesh as mesh_mod
    from neural_sound_generation_tpu_torch.training import train_state as ts_mod
    from neural_sound_generation_tpu_torch.training import trainer as trainer_mod

    from neural_sound_generation_tpu_torch.models.moe import SwitchMoE
    from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa_mod

    from neural_sound_generation_tpu_torch.parallel import pipeline as pp_mod

    cli = mods[job["cli"]]
    rec = {"metrics": [], "step_t": [], "searches": [], "adam_n": [], "collectives": [],
           "attention": [], "routing": []}
    trainers = []
    recording = {"on": False}
    pp_states = []

    def route(moe, args, out):
        if recording["on"]:
            with torch.no_grad():
                probs, expert, _, _, keep = moe.dispatch(args[0])
            rec["routing"].append((probs.cpu(), expert.cpu(), keep.cpu()))

    class Recorded(trainer_mod.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)
            if job.get("record_routing"):
                for m in a[0].modules():
                    if isinstance(m, SwitchMoE):
                        m.register_forward_hook(route)
            inner = self._train_step

            def step(state, batch, generator=None):
                recording["on"] = not rec["metrics"]
                if job.get("record_first_state") and not rec["metrics"]:
                    rec["first_state"] = {k: v.detach().cpu().clone()
                                          for k, v in state.model.state_dict().items()}
                    rec["first_batch"] = {k: v.cpu() for k, v in batch.items()}
                state, metrics = inner(state, batch, generator)
                recording["on"] = False
                sync(torch)
                rec["step_t"].append(time.perf_counter())
                rec["metrics"].append({k: float(v) for k, v in metrics.items()})
                if len(rec["metrics"]) == 1:
                    record_first(state)
                return state, metrics

            self._train_step = step

    def record_first(state) -> None:
        flat = state.flat
        named = {f"params/{k}": g for k, g in flat.named(flat.grad).items()}
        params = {f"params/{k}": p for k, p in flat.named(flat.flat).items()}
        if state.shards is not None:
            named = state.shards.gather_tensors(named)
            params = state.shards.gather_tensors(params)
        if distributed.rank() == 0:  # gathered: the same on every rank
            rec["first_grad"] = {k[7:]: g.cpu().clone() for k, g in named.items()}
            rec["first_params"] = {k[7:]: p.cpu().clone() for k, p in params.items()}

    pipeline_call = pp_mod.PipelineStep.__call__

    def pipeline_step(self, state, batch):
        # a pipe job's step (parallel.pipeline): recorded as a Trainer's
        recording["on"] = not rec["metrics"]
        metrics = pipeline_call(self, state, batch)
        recording["on"] = False
        sync(torch)
        rec["step_t"].append(time.perf_counter())
        rec["metrics"].append({k: float(v) for k, v in metrics.items()})
        rec["handoff_s"], rec["handoff_bytes"] = self.handoff_seconds, self.handoff_bytes
        if len(rec["metrics"]) == 1:
            record_first(state)
        pp_states[:] = [state]
        return metrics

    nearest, merged_nearest = vq_kernel.nearest_codebook_indices, vq_ops._nearest_indices
    adam = ts_mod.fused_adam_update
    saved = {name: getattr(mesh_mod.Mesh, name)
             for name in ("model_concat", "model_all_reduce", "model_all_reduce_", "all_reduce_")}

    def recorded_nearest(x, cb, **kw):
        rec["searches"].append((int(x.shape[0]), int(cb.shape[0])))
        return nearest(x, cb, **kw)

    def recorded_merged(x, cb):
        idx = merged_nearest(x, cb)
        if job.get("record_first_vqs") and recording["on"]:
            rec.setdefault("first_vqs", []).append(
                {"x": x.detach().cpu(), "cb": cb.detach().cpu(), "idx": idx.cpu()})
        return idx

    def recorded_adam(g, *a, **k):
        rec["adam_n"].append(int(g.numel()))
        return adam(g, *a, **k)

    attention = {name: getattr(fa_mod, name)
                 for name in ("launch_fwd", "launch_bwd_dq", "launch_bwd_dkdv")}

    def recorded_attention(name):
        def call(q, *a, **k):
            rec["attention"].append((name, tuple(q.shape), str(q.dtype)))
            return attention[name](q, *a, **k)
        return call

    def collective(name):
        def call(self, t, *a, **kw):
            if recording["on"]:
                rec["collectives"].append((name, tuple(t.shape), str(t.dtype),
                                           kw.get("dim", a[0] if a else None)))
            return saved[name](self, t, *a, **kw)
        return call

    saved_trainer = cli.Trainer
    cli.Trainer = Recorded
    pp_mod.PipelineStep.__call__ = pipeline_step
    vq_kernel.nearest_codebook_indices, vq_ops._nearest_indices = recorded_nearest, recorded_merged
    ts_mod.fused_adam_update = recorded_adam
    for name in saved:
        setattr(mesh_mod.Mesh, name, collective(name))
    for name in attention:
        setattr(fa_mod, name, recorded_attention(name))
    for k in kernels:
        k.reset_launch_count()
    t0 = time.perf_counter()
    try:
        result = cli.main(job["argv"])
    finally:
        cli.Trainer = saved_trainer
        pp_mod.PipelineStep.__call__ = pipeline_call
        vq_kernel.nearest_codebook_indices, vq_ops._nearest_indices = nearest, merged_nearest
        ts_mod.fused_adam_update = adam
        for name, fn in saved.items():
            setattr(mesh_mod.Mesh, name, fn)
        for name, fn in attention.items():
            setattr(fa_mod, name, fn)
    rec["seconds"] = time.perf_counter() - t0
    rec["launches"] = read_launches(*kernels)
    if job["cli"] == "evaluate":
        rec["means"] = result
    if trainers or pp_states:
        state = trainers[-1].state if trainers else pp_states[-1]
        rec["digests"] = tp_digests(torch, state)
        rec["state_bytes"] = sum(t.numel() * t.element_size() for t in (
            state.flat.flat, *state.opt_state.moments(),
            *([] if state.ema_params is None else [state.ema_params])))
        rec["local_n"] = state.flat.numel
        rec["split_at"] = state.flat.split_at
    return rec


def time_tp_collectives(torch, mesh, ops: list, iters: int = TP_COLLECTIVE_ITERS) -> dict:
    """ms of a step's collectives, replayed on tensors of the recorded
    shapes: each op timed alone (synchronised, the median of ``iters``
    after one more), summed by kind."""
    out: dict = {}
    for name, shape, dtype, arg in ops:
        t = torch.ones(shape, device=DEVICE, dtype=getattr(torch, dtype.split(".")[-1]))
        fn = getattr(mesh, name)
        times = []
        for i in range(iters + 1):
            sync(torch)
            t0 = time.perf_counter()
            fn(t, dim=arg) if arg is not None else fn(t)
            sync(torch)
            if i:
                times.append(1e3 * (time.perf_counter() - t0))
        out[name] = out.get(name, 0.0) + float(np.median(times))
    return out


def tp_rank_main(spec_path: str) -> int:
    """One rank of a phase-18 to 22 launch (``chip_smoke.py --tp-rank
    spec.json`` under torchrun): joins the group with the port's backend
    rule, runs the spec's jobs in order, replays the first-step collectives
    of each of the spec's ``timings`` jobs on a (W / 2, 2) mesh (none on
    one rank) and writes one record per job."""
    import torch
    import torch.distributed as dist

    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
    from neural_sound_generation_tpu_torch.ops.cuda import fused_adam, vq_kernel
    from neural_sound_generation_tpu_torch.parallel import distributed, make_mesh

    global DEVICE
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    DEVICE = spec["device"]
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    set_full_float32()
    distributed.initialize(device=DEVICE)
    rank, world = distributed.rank(), distributed.world_size()
    # where the launch's wall time goes, on the launcher's clock: the rank's
    # start-up, each job's wall time (its barrier, the CLI, the records) and
    # the loaders' share of it, the collectives' replay
    ready_s = time.time() - spec["t_launch"]
    loader_wait = loader_wait_meter(spec["python_collate"])
    mods = tp_cli_modules()
    records, walls = {}, {}
    for job in spec["jobs"]:
        t_job, waited = time.perf_counter(), dict(loader_wait)
        if rank == 0 and job.get("copy"):
            src, dst = job["copy"]
            shutil.rmtree(dst, ignore_errors=True)
            shutil.copytree(src, dst)
        distributed.barrier()
        rec = (run_seq_job(torch, job) if job.get("fn") == "seq"
               else run_tp_job(torch, mods, (vq_kernel, fused_adam, fa), job))
        records[job["name"]] = rec
        torch.save(rec, os.path.join(spec["out"], f"{job['name']}_rank{rank}.pt"))
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        walls[job["name"]] = {"wall_s": time.perf_counter() - t_job,
                              **{k: loader_wait[k] - waited[k] for k in loader_wait}}
    jobs_end_s = time.time() - spec["t_launch"]
    timing = {"backend": None, "world": world,
              "wall": {"ready_s": ready_s, "jobs_end_s": jobs_end_s, "jobs": walls}}
    if world > 1 and spec["timings"]:
        # the collectives' ms a step: each timing job's first step replayed
        mesh = make_mesh(n_data=world // TP_MODEL, n_model=TP_MODEL)
        by_job = {job: {"collectives_ms": time_tp_collectives(
                            torch, mesh, records[job]["collectives"], iters),
                        "collective_calls": len(records[job]["collectives"])}
                  for job, iters in spec["timings"].items()}
        timing.update(backend=dist.get_backend(), by_job=by_job)
    timing["wall"]["replay_end_s"] = time.time() - spec["t_launch"]
    with open(os.path.join(spec["out"], f"timing_rank{rank}.json"), "w", encoding="utf-8") as f:
        json.dump(timing, f)
    distributed.barrier()
    distributed.shutdown()
    return 0


def loader_wait_meter(python_collate: bool = False) -> dict:
    """From now on in this process, the seconds the loaders' consumers wait
    for a batch and the passes by path (native or Python collate), summed
    in the dict returned; with ``python_collate`` every loader made from
    now on defaults to the Python collate."""
    from neural_sound_generation_tpu_torch.data import pipeline

    if python_collate:
        pipeline.native_available = lambda: False

    meter = {"loader_wait_s": 0.0, "native_passes": 0, "python_passes": 0}
    base = pipeline.MelFrameLoader.__iter__

    def timed(self):
        meter["native_passes" if self.use_native else "python_passes"] += 1
        it = base(self)
        try:
            while True:
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                finally:
                    meter["loader_wait_s"] += time.perf_counter() - t
                yield batch
        finally:
            it.close()

    pipeline.MelFrameLoader.__iter__ = timed
    return meter


def tp_cli_modules() -> dict:
    """The CLIs a phase-17-21 job names, by name."""
    from neural_sound_generation_tpu_torch.cli import evaluate as cli_evaluate
    from neural_sound_generation_tpu_torch.cli import main as cli_main
    from neural_sound_generation_tpu_torch.cli import prior as cli_prior
    from neural_sound_generation_tpu_torch.cli import vocoder as cli_vocoder

    return {"main": cli_main, "evaluate": cli_evaluate, "prior": cli_prior,
            "vocoder": cli_vocoder}


def launch_tp(torch, root: str, jobs: list, world: int, tag: str = "tp",
              timing_job: str | None = "flagship", collective_iters: int = TP_COLLECTIVE_ITERS,
              riders: dict | None = None, rider_timings: dict | None = None) -> dict:
    """One torchrun launch of ``world`` ranks on this card, its files under
    ``root/tag``; every rank's records. A rank's failure fails the phase.
    One rank runs the jobs in this process, the one-rank program (no
    process group, as a torchrun launch of one rank has none), without a
    second process's start-up and its records' round trip through files.
    ``riders``: {phase tag: jobs} of other phases of the same world, run
    after ``jobs`` in the same launch (one rank start-up for all, some 20 s
    of the command's 1,200), each tag's (timing job, iterations) in
    ``rider_timings`` replayed; they come back under ``"riders"``, a run of
    the same shape a tag, with their own names."""
    out = os.path.join(root, tag, f"w{world}")
    os.makedirs(out, exist_ok=True)
    if world == 1:
        from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
        from neural_sound_generation_tpu_torch.ops.cuda import fused_adam, vq_kernel

        t0 = time.perf_counter()
        records = {}
        for job in jobs:
            check(not job.get("copy"), f"{tag}: a one-rank job copies nothing")
            records[job["name"]] = run_tp_job(torch, tp_cli_modules(),
                                              (vq_kernel, fused_adam, fa), job)
            torch.cuda.empty_cache()
        return {"ranks": [records], "timing": [{"backend": None, "world": 1}],
                "seconds": time.perf_counter() - t0}
    spec = os.path.join(out, "spec.json")
    riders = riders or {}
    # a rider's name carries its tag, so that two phases' jobs never share a file
    tagged = [dict(job, name=f"{rt}.{job['name']}") for rt, js in riders.items() for job in js]
    timings = {**({timing_job: collective_iters} if timing_job else {}),
               **{f"{rt}.{job}": iters for rt, (job, iters) in (rider_timings or {}).items()}}
    with open(spec, "w", encoding="utf-8") as f:
        json.dump({"jobs": jobs + tagged, "out": out, "device": DEVICE, "timings": timings,
                   "python_collate": PYTHON_COLLATE, "t_launch": time.time()}, f)
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(world), os.path.abspath(__file__), "--tp-rank", spec],
        cwd=repo, env=env, capture_output=True, text=True, timeout=TP_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{tag}: torchrun with {world} ranks exited "
          f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    def records(of: list, prefix: str = "") -> list:
        return [{job["name"]: torch.load(os.path.join(out, f"{prefix}{job['name']}_rank{r}.pt"),
                                         weights_only=False) for job in of}
                for r in range(world)]

    raw = [json.load(open(os.path.join(out, f"timing_rank{r}.json"), encoding="utf-8"))
           for r in range(world)]

    def timing(job):  # a job's replayed collectives at the top, as one launch of it has them
        return [{**t, **t.get("by_job", {}).get(job, {})} for t in raw]

    run = {"ranks": records(jobs), "timing": timing(timing_job), "seconds": seconds}
    run["riders"] = {
        rt: {"ranks": records(js, f"{rt}."), "seconds": seconds,
             "timing": timing(f"{rt}.{(rider_timings or {}).get(rt, (None,))[0]}")}
        for rt, js in riders.items()}
    return run


def launch_wall(run: dict) -> dict:
    """Where a launch's seconds went, from its ranks' ``wall`` records:
    the slowest rank's start-up, the end of its jobs and of the replay, the
    rest (the group's shutdown, torchrun's exit); the jobs' wall time and
    loader waits summed over rank 0's jobs (riders included), and each of
    those jobs' wall time."""
    walls = [t["wall"] for t in run["timing"]]
    jobs = walls[0]["jobs"]
    return {"seconds": run["seconds"], "ready_s": max(w["ready_s"] for w in walls),
            "jobs_end_s": max(w["jobs_end_s"] for w in walls),
            "replay_end_s": max(w["replay_end_s"] for w in walls),
            "jobs_wall_s": sum(j["wall_s"] for j in jobs.values()),
            "loader_wait_s": sum(j["loader_wait_s"] for j in jobs.values()),
            "native_passes": sum(j["native_passes"] for j in jobs.values()),
            "python_passes": sum(j["python_passes"] for j in jobs.values()),
            "job_wall_s": {j: jobs[j]["wall_s"] for j in jobs}}


def check_tp_groups(ranks: list, job: str) -> None:
    """Every rank's local state bit-equal across its data group (ranks r
    and r + TP_MODEL), its replicated part across its model group."""
    for r, rank in enumerate(ranks):
        for s, other in enumerate(ranks):
            a, b = rank[job]["digests"], other[job]["digests"]
            if r % TP_MODEL == s % TP_MODEL:
                check(a["local"] == b["local"],
                      f"tensor parallel {job}: ranks {r} and {s} (one data group) differ")
            if r // TP_MODEL == s // TP_MODEL:
                check(a["replicated"] == b["replicated"],
                      f"tensor parallel {job}: ranks {r} and {s} (one model group) differ "
                      "in their replicated leaves")


def check_tp_launches(ranks: list, job: str, want: dict, searches=None) -> list:
    counts = []
    for r, rank in enumerate(ranks):
        got = rank[job]["launches"]
        for k, n in want.items():
            check(got[k] == n, f"tensor parallel {job} rank {r}: {k} launched {got[k]} times, "
                  f"expected {n}")
        if searches is not None:
            check(searches(rank[job]["searches"]),
                  f"tensor parallel {job} rank {r}: searches (rows, codes) "
                  f"{sorted(set(rank[job]['searches']))}")
        check(set(rank[job]["adam_n"]) <= {rank[job].get("local_n")},
              f"tensor parallel {job} rank {r}: kernel 3 at n {set(rank[job]['adam_n'])}, "
              f"the local buffer has {rank[job].get('local_n')}")
        counts.append(got)
    return counts


def tp_first_step(torch, one: dict, ranks: list) -> dict:
    """The flagship's first step on the model axis against W 1 (phase 17's
    one-rank run): the loss, the gathered gradient relative to its norm,
    the code flips (each a near-tie) of the first search."""
    from neural_sound_generation_tpu_torch.models import VQVAE
    from neural_sound_generation_tpu_torch.training.train_state import FlatParams

    names = FlatParams(VQVAE(1, TRAIN_DIM, TRAIN_CODES))
    g1 = names.named(one["first_grad"])
    g2 = ranks[0]["flagship"]["first_grad"]  # gathered: the same on every rank
    keys = sorted(g1)
    v1 = torch.cat([g1[k].reshape(-1) for k in keys])
    v2 = torch.cat([g2[k].reshape(-1) for k in keys])
    lead = [r["flagship"] for r in ranks[::TP_MODEL]]  # model rank 0 of each data rank
    a = one["first_vq"]
    x2 = torch.cat([r["first_vqs"][0]["x"] for r in lead])
    i2 = torch.cat([r["first_vqs"][0]["idx"] for r in lead])
    kl = TRAIN_CODES // TP_MODEL
    cb_err = max(float((a["cb"][m * kl:(m + 1) * kl] - ranks[m]["flagship"]["first_vqs"][0]["cb"])
                       .abs().max()) for m in range(TP_MODEL))
    flipped = (a["idx"] != i2).nonzero()[:, 0]
    cb = a["cb"].double()
    ties = near_ties(a["x"][flipped].double(), x2[flipped].double(),
                     cb[i2[flipped].long()], cb[a["idx"][flipped].long()])
    loss1 = one["metrics"][0]["loss"]
    loss2 = float(np.mean([r["metrics"][0]["loss"] for r in lead]))
    p1 = names.named(one["first_params"])
    p2 = ranks[0]["flagship"]["first_params"]
    diff = {k: (p2[k] - p1[k]).abs() for k in keys}
    bias = torch.cat([t.reshape(-1) for k, t in diff.items() if k.endswith(".bias")])
    rest = torch.cat([t.reshape(-1) for k, t in diff.items() if not k.endswith(".bias")])
    return {"loss_w1": loss1, "loss": loss2, "loss_rel": abs(loss2 - loss1) / abs(loss1),
            "grad_rel": float((v2 - v1).norm() / v1.norm()),
            "rows": int(a["idx"].numel()), "flips": int(flipped.numel()),
            "near_ties": int(ties.sum()), "codebook_max_abs_err": cb_err,
            "x_max_abs_err": float((x2 - a["x"]).abs().max()),
            "weights_beyond_1e-5_frac": float((rest > 1e-5).float().mean()),
            "weights_max_abs_err": float(rest.max()), "biases_max_abs_err": float(bias.max())}


def tensor_parallel_phase(torch, root: str, corpus: str, card: str, dp: dict, vq_kernel,
                          fused_adam, gen, runs: dict | None = None) -> tuple[dict, dict]:
    """Phase 18: ``cli.main --mesh-model 2`` under torchrun at W 2 (data 1
    x model 2) and W 4 (data 2 x model 2), the ranks sharing this card over
    gloo, against phase 17's W 1 run; at W 2 a --resume step from phase
    17's W 1 checkpoint, ``cli.evaluate --mesh-model 2`` and one RVQ/bf16
    step; kernel 1 sharded against one launch, kernel 3 at the local n.
    ``runs``: its launches' records where they ran already (riding phase
    21's). Returns (the record, the kernel rows)."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.models import VQVAE
    from neural_sound_generation_tpu_torch.ops import vq as vq_ops
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    t0 = time.perf_counter()
    kernel_row = sharded_search_check(torch, vq_kernel, vq_ops, gen)
    emit(kernel_row)
    if runs is None:
        shutil.rmtree(os.path.join(root, "tp"), ignore_errors=True)
        runs = {w: launch_tp(torch, root, tp_jobs(root, corpus, w), w) for w in TP_WORLDS}
    one = {job: torch.load(os.path.join(root, "dp", "w1", f"{job}_rank0.pt"),
                           weights_only=False) for job in ("flagship", "evaluate", "rvq")}
    rows = TRAIN_BATCH * (80 // 4) * (28 // 4)
    steps = DP_EPOCHS * BATCHES_PER_EPOCH
    kl = TRAIN_CODES // TP_MODEL
    out = {"phase": "tensor_parallel", "card": card, "model": TP_MODEL,
           "note": "the ranks share one card over gloo: steps/s measures equality's and the "
                   "collectives' cost, not scaling"}
    flag = {}
    for w, run in runs.items():
        n_data = w // TP_MODEL
        ranks = run["ranks"]
        check_tp_launches(ranks, "flagship", {"fused_adam": steps,
                                              "vq_nearest": steps + 2 * DP_EPOCHS},
                          lambda s, n_data=n_data: set(s) == {(rows // n_data, kl)})
        check_tp_groups(ranks, "flagship")
        first = tp_first_step(torch, one["flagship"], ranks)
        check(first["near_ties"] == first["flips"],
              f"tensor parallel W {w}: {first['flips'] - first['near_ties']} code flips that "
              "are not near-ties")
        check(first["codebook_max_abs_err"] <= 1e-5,
              f"tensor parallel W {w}: data-init codebook shards {first['codebook_max_abs_err']}"
              " from the W 1 codebook")
        check(first["loss_rel"] <= DP_LOSS_REL,
              f"tensor parallel W {w}: first loss {first['loss']} against {first['loss_w1']}")
        check(first["grad_rel"] <= (DP_GRAD_REL_FLIPS if first["flips"] else DP_GRAD_REL),
              f"tensor parallel W {w}: the gathered gradient {first['grad_rel']:.3g} of its norm "
              f"away ({first['flips']} flips)")
        check(first["weights_beyond_1e-5_frac"] <= 1e-3 and first["weights_max_abs_err"] <= 1e-2
              and first["biases_max_abs_err"] <= 2.01 * DP_LR,
              f"tensor parallel W {w}: parameters after the first step {first}")
        losses = [float(np.mean([r["flagship"]["metrics"][i]["loss"]
                                 for r in ranks[::TP_MODEL]])) for i in range(steps)]
        check(losses[-1] < losses[0], f"tensor parallel W {w}: the loss did not fall {losses}")
        flag[f"w{w}"] = {
            "first_step": first, "losses": losses,
            "steps_per_s": dp_step_rate(ranks[0]["flagship"]),
            "local_n": [r["flagship"]["local_n"] for r in ranks],
            "split_at": ranks[0]["flagship"]["split_at"],
            "state_bytes_a_rank": [r["flagship"]["state_bytes"] for r in ranks],
            "collectives_ms_a_step": run["timing"][0]["collectives_ms"],
            "collective_calls_a_step": run["timing"][0]["collective_calls"],
            "backend": run["timing"][0]["backend"], "launch_seconds": run["seconds"],
            "launches": [r["flagship"]["launches"] for r in ranks]}
    whole = create_train_state(VQVAE(1, TRAIN_DIM, TRAIN_CODES).to(DEVICE), Config().train)
    flag["w1_state_bytes"] = sum(t.numel() * t.element_size() for t in (
        whole.flat.flat, whole.opt_state.m, whole.opt_state.v,
        *([] if whole.ema_params is None else [whole.ema_params])))
    flag["w1_steps_per_s"] = dp_step_rate(one["flagship"])
    del whole
    out["flagship"] = flag

    w2 = runs[TP_WORLDS[0]]["ranks"]
    # the --resume step from phase 17's W 1 checkpoint
    check_tp_launches(w2, "resume", {"fused_adam": 1, "vq_nearest": 1 + 2})
    check_tp_groups(w2, "resume")
    resumed = os.path.join(root, "tp", f"w{TP_WORLDS[0]}", "resume", "models", "vqvae",
                           f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
    want = {f"step_{BATCHES_PER_EPOCH * e}" for e in range(1, DP_EPOCHS + 1)} | {
        f"step_{steps + 1}"}
    check(set(os.listdir(resumed)) == want,
          f"tensor parallel --resume: checkpoints {sorted(os.listdir(resumed))}, expected {want}")
    out["resume"] = {"loss": w2[0]["resume"]["metrics"][0]["loss"], "checkpoints": sorted(want)}
    # cli.evaluate --mesh-model 2 on the W 1 checkpoint
    m1, m2 = one["evaluate"]["means"], w2[0]["evaluate"]["means"]
    check(m1.keys() == m2.keys() and all(
        abs(m2[k] - m1[k]) <= (DP_EVAL_PPL_REL if k == "perplexity" else DP_LOSS_REL) * abs(m1[k])
        for k in m1), f"tensor parallel evaluate: {m2} against W 1's {m1}")
    check_tp_launches(w2, "evaluate", {"vq_nearest": 2},
                      lambda s: set(s) == {(rows, kl)})
    out["evaluate"] = {"w1": m1, "w2": m2}
    # one RVQ/bf16 step: Q - 1 data-init searches of the whole codebook
    # before sharding, then Q in the forward, Q in the EMA branch, 2Q in eval
    init = RVQ_Q - 1
    check_tp_launches(w2, "rvq", {"fused_adam": 1, "vq_nearest": init + 2 * RVQ_Q + 2 * RVQ_Q},
                      lambda s: s[:init] == [(rows, TRAIN_CODES)] * init
                      and set(s[init:]) == {(rows, kl)})
    check_tp_groups(w2, "rvq")
    l1, l2 = one["rvq"]["metrics"][0]["loss"], w2[0]["rvq"]["metrics"][0]["loss"]
    check(abs(l2 - l1) <= 2e-2 * abs(l1), f"tensor parallel rvq bf16: loss {l2} against {l1}")
    out["rvq"] = {"loss_w1": l1, "loss": l2, "loss_rel": abs(l2 - l1) / abs(l1)}

    # kernel 3 at the local n of W 2's ranks
    local_n = flag[f"w{TP_WORLDS[0]}"]["local_n"][0]
    adam_row = compare_fused_adam(torch, fused_adam, local_n, ADAM_CONFIGS[0], gen)
    adam_row["shape_of"] = "tensor_parallel_rank"
    emit(adam_row)
    out["launches"] = {f"w{w}": [{job: r[job]["launches"] for job in r} for r in runs[w]["ranks"]]
                       for w in runs}
    out["seconds"] = time.perf_counter() - t0
    return out, {"vq_sharded": kernel_row, "adam_local": adam_row}


# ---------------------------------------------------------------------------
# Phase 19: the transformer prior on the model axis
# ---------------------------------------------------------------------------

P19_WORLDS = (1, 2, 4)  # one rank, (data 1 x model 2), (data 2 x model 2)
P19_STEPS = 4  # the dense runs' steps (steps/s reads the last two intervals)
# kernel 4 at a model rank's share of phase 7's step: batch 32 of 20 x 7
# grids, one of the two heads (BH 32), f32 and bf16
P19_ATTN_SHAPES = [("tp_prior_T140", 32, 140, 64, False),
                   ("tp_prior_T140_bf16", 32, 140, 64, True)]
P19_SAMPLE_GRID = (20, 7)


def p19_jobs(root: str, corpus: str, vq_ckpt: str, world: int) -> list[dict]:
    """What one torchrun launch of ``world`` ranks runs through ``cli.prior
    train --arch transformer`` at phase 7's widths on phase 5's VQ-VAE,
    with --mesh-model TP_MODEL above one rank: the dense prior for
    P19_STEPS steps and the routed prior (phase 14's 4 experts) for
    DP_JOB_STEPS; at W 1 and W 2 one --bf16 dense step; at W 2 one
    --resume step from W 1's dense checkpoint (copied first)."""
    out = os.path.join(root, "tp_prior", f"w{world}")
    mesh = [] if world == 1 else ["--mesh-model", str(TP_MODEL),
                                  "--mesh-data", str(world // TP_MODEL)]

    def train(tag: str, steps: int, *extra, epochs: int = 1) -> list:
        return ["train", "--datadir", corpus, "--vqvae-ckpt", vq_ckpt,
                "--ckpt-dir", os.path.join(out, tag, "prior"), "--batch-size", str(PRIOR_BATCH),
                "--epochs", str(epochs), "--max-batches-per-epoch", str(steps),
                "--arch", "transformer", "--prior-dim", str(PRIOR_DIM),
                "--prior-layers", str(PRIOR_LAYERS), "--dim", str(TRAIN_DIM),
                "--z-dim", str(TRAIN_CODES), "--device", DEVICE, *mesh, *extra]

    jobs = [{"name": "dense", "cli": "prior", "argv": train("dense", P19_STEPS)},
            {"name": "routed", "cli": "prior", "record_routing": True,
             "argv": train("routed", DP_JOB_STEPS, "--moe-experts", str(MOE_EXPERTS))}]
    if world == P19_WORLDS[-1]:
        return jobs
    jobs.append({"name": "bf16", "cli": "prior", "argv": train("bf16", 1, "--bf16")})
    if world == TP_MODEL:
        jobs.append({"name": "resume", "cli": "prior",
                     "copy": [os.path.join(root, "tp_prior", "w1", "dense"),
                              os.path.join(out, "resume")],
                     "argv": train("resume", 1, "--resume", epochs=2)})
    return jobs


def p19_runs(torch, root: str, corpus: str, vq_ckpt: str) -> dict:
    """Phase 19's W 1 jobs, in this process, from an empty ``tp_prior``."""
    shutil.rmtree(os.path.join(root, "tp_prior"), ignore_errors=True)
    return launch_tp(torch, root, p19_jobs(root, corpus, vq_ckpt, 1), 1, "tp_prior")


def p19_first_step(torch, one: dict, ranks: list) -> dict:
    """A job's first step on the model axis against W 1's: the loss (the
    data ranks' mean), the gathered gradient relative to W 1's norm, and
    for a routed prior the routing decisions of every block against W 1's
    (``routing_flips``, W 1's probabilities deciding the near-ties)."""
    lead = ranks[::TP_MODEL]  # model rank 0 of each data rank, in row order
    g1, g2 = one["first_grad"], ranks[0]["first_grad"]
    keys = sorted(g1)
    v1 = torch.cat([g1[k].reshape(-1) for k in keys])
    v2 = torch.cat([g2[k].reshape(-1) for k in keys])
    loss1 = one["metrics"][0]["loss"]
    loss2 = float(np.mean([r["metrics"][0]["loss"] for r in lead]))
    p1, p2 = one["first_params"], ranks[0]["first_params"]
    out = {"loss_w1": loss1, "loss": loss2, "loss_rel": abs(loss2 - loss1) / abs(loss1),
           "grad_rel": float((v2 - v1).norm() / v1.norm()),
           "params_max_abs_err": max(float((p2[k] - p1[k]).abs().max()) for k in keys)}
    if one["routing"]:
        layers = range(len(one["routing"]))
        tp = [(None, torch.cat([r["routing"][i][1] for r in lead]),
               torch.cat([r["routing"][i][2] for r in lead])) for i in layers]
        out["routing"] = routing_flips(torch, tp, one["routing"])
    return out


def p19_bh(world: int) -> int:
    """Kernel 4's BH on a rank: its rows of the batch times its heads."""
    n_data, n_model = (1, 1) if world == 1 else (world // TP_MODEL, TP_MODEL)
    return PRIOR_BATCH // n_data * (PRIOR_HEADS // n_model)


def prior_tensor_parallel_phase(torch, cli_prior, root: str, corpus: str, vq_ckpt: str,
                                card: str, fa, fused_adam, gen,
                                runs: dict | None = None) -> tuple[dict, dict]:
    """Phase 19: ``cli.prior train --arch transformer --mesh-model 2`` under
    torchrun at W 2 (data 1 x model 2) and W 4 (data 2 x model 2), the
    ranks sharing this card over gloo, each job against a W 1 launch of the
    same flags: the dense prior, the routed prior (expert parallelism), one
    --bf16 step and, at W 2, a --resume step from W 1's checkpoint; then
    ``cli.prior sample`` from W 2's checkpoint on this process, kernel 4 at
    a rank's BH 32 and kernel 3 at the dense and routed ranks' n. ``runs``:
    the launches' records where they ran already (W 1's from ``p19_runs``,
    W 2's and 4's riding phase 21's launches). Returns (the record, the
    kernel rows, with W 1's records)."""
    t0 = time.perf_counter()
    if runs is None:
        runs = {1: p19_runs(torch, root, corpus, vq_ckpt)}
        runs.update({w: launch_tp(torch, root, p19_jobs(root, corpus, vq_ckpt, w), w,
                                  "tp_prior", "dense") for w in P19_WORLDS[1:]})
    one = runs[1]["ranks"][0]
    layers = PRIOR_LAYERS
    out = {"phase": "tensor_parallel_prior", "card": card, "model": TP_MODEL,
           "widths": {"prior_dim": PRIOR_DIM, "prior_layers": layers, "prior_heads": PRIOR_HEADS,
                      "batch": PRIOR_BATCH, "codes": TRAIN_CODES, "experts": MOE_EXPERTS},
           "note": "the ranks share one card over gloo: steps/s measures equality's and the "
                   "collectives' cost, not scaling"}
    jobs = {}
    for w, run in runs.items():
        ranks = run["ranks"]
        bh = p19_bh(w)
        for job in ranks[0]:
            steps = len(one[job]["metrics"]) if job != "resume" else 1
            want = {"vq_nearest": steps, "fused_adam": steps,
                    **{k: layers * steps for k in fa.KERNELS}}
            check_tp_launches(ranks, job, want)
            for r, rank in enumerate(ranks):
                shapes = {q[0] for _, q, _ in rank[job]["attention"]}
                check(len(rank[job]["attention"]) == 3 * layers * steps and shapes == {bh},
                      f"tensor parallel prior {job} W {w} rank {r}: kernel 4 at BH {shapes}, "
                      f"{len(rank[job]['attention'])} launches, expected BH {bh}")
            if w > 1:
                check_tp_groups(ranks, job)
            rec = {"losses": [float(np.mean([r[job]["metrics"][i]["loss"]
                                             for r in ranks[::TP_MODEL if w > 1 else 1]]))
                              for i in range(steps)],
                   "launches": [r[job]["launches"] for r in ranks],
                   "local_n": [r[job]["local_n"] for r in ranks],
                   "state_bytes_a_rank": [r[job]["state_bytes"] for r in ranks],
                   "attention_bh": bh}
            if w > 1 and job != "resume":
                first = p19_first_step(torch, one[job], [r[job] for r in ranks])
                bf16 = job == "bf16"
                limit = BF16_LOSS_REL if bf16 else DP_LOSS_REL
                check(first["loss_rel"] <= limit,
                      f"tensor parallel prior {job} W {w}: first loss {first['loss']} against "
                      f"W 1's {first['loss_w1']}")
                routing = first.get("routing")
                if routing is not None:
                    check(routing["flips"] == routing["near_ties"] + routing["cascade"],
                          f"tensor parallel prior {job} W {w}: routing flips that are neither "
                          f"near-ties nor cascades of one ({routing})")
                if not bf16 and not (routing and routing["flips"]):
                    check(first["grad_rel"] <= DP_GRAD_REL,
                          f"tensor parallel prior {job} W {w}: the gathered gradient "
                          f"{first['grad_rel']:.3g} of its norm away")
                rec["first_step"] = first
            if job == "dense":
                check(rec["losses"][-1] < rec["losses"][0],
                      f"tensor parallel prior W {w}: the loss did not fall {rec['losses']}")
                rec["steps_per_s"] = dp_step_rate(ranks[0][job])
                rec["collectives_ms_a_step"] = run["timing"][0].get("collectives_ms")
                rec["collective_calls_a_step"] = run["timing"][0].get("collective_calls")
                rec["backend"] = run["timing"][0]["backend"]
            jobs[f"{job}_w{w}"] = rec
        jobs[f"launch_seconds_w{w}"] = run["seconds"]
    out["jobs"] = jobs

    # the --resume step at M 2 from W 1's dense checkpoint
    resumed = os.path.join(root, "tp_prior", f"w{TP_MODEL}", "resume", "prior")
    for sub in ("", "_ema", "_train"):
        check(checkpoint_steps(resumed + sub) == [P19_STEPS, P19_STEPS + 1],
              f"tensor parallel prior --resume: {resumed + sub} holds "
              f"{checkpoint_steps(resumed + sub)}")
    # the M 2 checkpoint samples on one rank (this process)
    ckpt = os.path.join(root, "tp_prior", f"w{TP_MODEL}", "dense", "prior")
    h, w_ = P19_SAMPLE_GRID
    out["sample_cli"] = run_sample_cli(cli_prior, [
        "sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpt + "_ema", "--arch", "transformer",
        "--prior-dim", str(PRIOR_DIM), "--prior-layers", str(layers), "--dim", str(TRAIN_DIM),
        "--z-dim", str(TRAIN_CODES), "--code-shape", str(h), str(w_), "--device", DEVICE],
        os.path.join(root, "tp_prior", "samples"), "prior_sample", 4 * w_)

    # kernel 4 at a model rank's BH, kernel 3 at the dense and routed ranks' n
    attn_rows = {}
    for shape in P19_ATTN_SHAPES:
        row = compare_attention(torch, fa, shape, gen)
        emit(row)
        limit = ATTN_BF16_REL if shape[4] else ATTN_F32_REL
        check(max(row["rel_err"].values()) <= limit and row["run_to_run_identical"],
              f"flash attention {shape[0]}: errors {row['rel_err']} above {limit}")
        for kernel, plan in row["plan"].items():
            check(plan["spill_bytes"] == 0,
                  f"{kernel} {shape[0]}: {plan['spill_bytes']} bytes spilled per thread")
        attn_rows[shape[0]] = row
    adam_rows = {}
    for job in ("dense", "routed"):
        n = jobs[f"{job}_w{TP_MODEL}"]["local_n"][0]
        row = compare_fused_adam(torch, fused_adam, n, ADAM_CONFIGS[0], gen)
        row["shape_of"] = f"tensor_parallel_{job}_prior_rank"
        emit(row)
        adam_rows[job] = row
    out["launches"] = {f"w{w}": [{job: r[job]["launches"] for job in r}
                                 for r in runs[w]["ranks"]] for w in P19_WORLDS}
    out["seconds"] = time.perf_counter() - t0
    return out, {"attention": attn_rows, "adam": adam_rows, "w1": one}


# ---------------------------------------------------------------------------
# Phase 20: the other autoencoders on the model axis
# ---------------------------------------------------------------------------

P20_WORLDS = (1, 2, 4)  # one rank, (data 1 x model 2), (data 2 x model 2)
P20_STEPS = 2  # a training job's steps, one eval batch after them
P20_FAMILIES = ("hier", "wave_raw", "wave_mulaw", "vae")
P20_W4_FAMILIES = ("wave_raw",)  # the jobs of the (2 x 2) launch
# each job's whole-codebook searches of its data init, before it shards
P20_INIT_SEARCHES = {"hier": 4, "wave_raw": 0, "wave_mulaw": 1, "vae": 0}
P20_COLLECTIVE_ITERS = 1  # the wave step moves some 2 GB through gloo
P20_SHARE_TOL = 1e-3  # a rank's flat buffer against the table's share (alignment padding)
# the first step's gathered gradient against W 1's: phase 17's limits, or
# where a gap is above them, P20_CPU_GAP_C times the gap of W 1's own step
# on the CPU (``p20_cpu_grad``): the encoders' backward chains through
# BatchNorm amplify the order of sums into 1e-4-2e-3 of the norm between
# two correct one-rank runs at these widths (PERF.md section 6;
# scripts/torch_tp_autoencoder_grad_probe.py measures them)
P20_CPU_GAP_C = 2.0


def p20_models(torch):
    """Each family at phase 11's full widths, seeded (the table's shares)."""
    from neural_sound_generation_tpu_torch.models import VAE, HierVQVAE, WaveVQVAE

    return {"hier": HierVQVAE(1, TRAIN_DIM, TRAIN_CODES),
            "wave_raw": WaveVQVAE(TRAIN_DIM, TRAIN_CODES, WAVE_DOWNSAMPLE),
            "wave_mulaw": WaveVQVAE(TRAIN_DIM, TRAIN_CODES, WAVE_DOWNSAMPLE,
                                    input_type="mulaw-quantize", quantize_channels=256,
                                    num_quantizers=2),
            "vae": VAE(1, TRAIN_DIM, VAE_Z)}


def p20_jobs(root: str, data: dict, world: int) -> list[dict]:
    """What one torchrun launch of ``world`` ranks runs through ``cli.main``
    and ``cli.evaluate`` at phase 11's full widths and flags, with
    --mesh-model TP_MODEL above one rank: each family for P20_STEPS steps
    and an eval batch (at W 4 the raw wave model only); at W 1 and W 2
    ``cli.evaluate`` on W 1's hier and wave checkpoints; at W 2 one
    --resume step from each of them (copied first)."""
    out = os.path.join(root, "tp_ae", f"w{world}")
    mesh = [] if world == 1 else ["--mesh-model", str(TP_MODEL),
                                  "--mesh-data", str(world // TP_MODEL)]
    # phase 11's flags; the data init of the codebooks apart (a resume has none)
    flags = {
        "hier": ("hiervqvae", data["corpus"], "ljspeech", None, []),
        "wave_raw": ("wavevqvae", data["corpus"], "ljspeech", None, [
            "--num-downsample", str(WAVE_DOWNSAMPLE), "--ema-codebook",
            "--restart-dead-threshold", "1.0"]),
        "wave_mulaw": ("wavevqvae", data["mulaw"], "ljspeech", None, [
            "--preset", data["preset"], "--num-quantizers", "2",
            "--num-downsample", str(WAVE_DOWNSAMPLE)]),
        "vae": ("vae", data["mnist"], "MNIST", VAE_Z, []),
    }
    data_init = ["--codebook-init", "data"]

    def train(job: str, tag: str, *extra) -> list:
        model, datadir, dataset, z_dim, family = flags[job]
        return (other_argv(model, os.path.join(out, tag), datadir, dataset, z_dim) + family
                + ["--epochs", "1", "--max-batches-per-epoch", str(P20_STEPS), *mesh, *extra])

    families = P20_W4_FAMILIES if world == P20_WORLDS[-1] else P20_FAMILIES
    jobs = [{"name": job, "cli": "main", "record_first_vqs": True,
             "record_first_state": world == 1,
             "argv": train(job, job, *(data_init if job != "vae" else []))}
            for job in families]
    if world == P20_WORLDS[-1]:
        return jobs
    one = os.path.join(root, "tp_ae", "w1")
    for job, model in (("hier", "hiervqvae"), ("wave_raw", "wavevqvae")):
        ckpt = os.path.join(one, job, "models", model,
                            f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
        extra = ["--num-downsample", str(WAVE_DOWNSAMPLE)] if job == "wave_raw" else []
        jobs.append({"name": f"evaluate_{job}", "cli": "evaluate", "argv": [
            "--model", model, "--datadir", data["corpus"], "--ckpt-dir", ckpt,
            "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES),
            "--batch-size", str(TRAIN_BATCH), "--max-batches", "1", "--device", DEVICE,
            *extra, *mesh]})
        if world == TP_MODEL:
            jobs.append({"name": f"resume_{job}", "cli": "main",
                         "copy": [os.path.join(one, job, "models"),
                                  os.path.join(out, f"resume_{job}", "models")],
                         "argv": train(job, f"resume_{job}", "--epochs", "2",
                                       "--max-batches-per-epoch", "1", "--resume")})
    return jobs


def p20_first_step(torch, one: dict, ranks: list) -> dict:
    """A job's first step on the model axis against W 1's: the loss (the
    data ranks' mean), the gathered gradient relative to W 1's norm, and
    each search of the step (top then bottom, or stage by stage) against
    W 1's: its flips, and how many are near-ties on W 1's whole codebook.
    A search after one that flipped is that flip's cascade (its inputs
    moved), so only its count is kept."""
    lead = ranks[::TP_MODEL]  # model rank 0 of each data rank, in row order
    g1, g2 = one["first_grad"], ranks[0]["first_grad"]
    keys = sorted(g1)
    v1 = torch.cat([g1[k].reshape(-1) for k in keys])
    v2 = torch.cat([g2[k].reshape(-1) for k in keys])
    loss1 = one["metrics"][0]["loss"]
    loss2 = float(np.mean([r["metrics"][0]["loss"] for r in lead]))
    searches, cascade = [], False
    for i, a in enumerate(one.get("first_vqs", [])):
        x2 = torch.cat([r["first_vqs"][i]["x"] for r in lead])
        i2 = torch.cat([r["first_vqs"][i]["idx"] for r in lead])
        flipped = (a["idx"] != i2).nonzero()[:, 0]
        cb = a["cb"].double()
        ties = near_ties(a["x"][flipped].double(), x2[flipped].double(),
                         cb[i2[flipped].long()], cb[a["idx"][flipped].long()])
        kl = a["cb"].shape[0] // TP_MODEL
        shard = ranks[0]["first_vqs"][i]["cb"]
        searches.append({"rows": int(a["idx"].numel()), "k_shard": int(shard.shape[0]),
                         "flips": int(flipped.numel()), "near_ties": int(ties.sum()),
                         "cascade": cascade,
                         "shard_max_abs_err": float((a["cb"][:kl] - shard).abs().max())})
        cascade = cascade or bool(flipped.numel())
    return {"loss_w1": loss1, "loss": loss2, "loss_rel": abs(loss2 - loss1) / abs(loss1),
            "grad_rel": float((v2 - v1).norm() / v1.norm()), "searches": searches,
            "flips": sum(s["flips"] for s in searches)}


def p20_cpu_grad(torch, one: dict, argv: list) -> dict:
    """W 1's first step again on the CPU (float32, this process's threads)
    from W 1's recorded state and batch, with W 1's codes at every search
    (so no near-tie can flip): the gradient by name after the step (an EMA
    codebook's zeroed). The gap between two devices' one-rank gradients is
    the float32 order-of-sums noise of this state, which the model axis's
    split sums meet too."""
    from neural_sound_generation_tpu_torch.cli import main as cli_main
    from neural_sound_generation_tpu_torch.ops import vq as vq_ops
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import (
        make_train_step,
        uses_ema_codebook,
    )

    args = cli_main.parse_args(argv)
    cfg = cli_main.build_config(args)
    model = cli_main.make_model(cfg, norm=args.norm)
    model.load_state_dict(one["first_state"])
    state = create_train_state(model, cfg.train, ema_codebook=uses_ema_codebook(model, cfg))
    codes = [r["idx"] for r in one.get("first_vqs", [])]
    nearest = vq_ops._nearest_indices
    vq_ops._nearest_indices = lambda x, cb: codes.pop(0)
    try:
        make_train_step(model, cfg)(state, one["first_batch"], torch.Generator().manual_seed(SEED))
    finally:
        vq_ops._nearest_indices = nearest
    check(not codes, f"the CPU step made {len(one.get('first_vqs', [])) - len(codes)} searches, "
          f"W 1's first step {len(one.get('first_vqs', []))}")
    return {k: g.clone() for k, g in state.flat.named(state.flat.grad).items()}


def p20_shares(torch, models: dict) -> dict:
    """A model rank's share of each family's parameters under the port's
    table at M TP_MODEL: the split leaves over M, the others whole."""
    from neural_sound_generation_tpu_torch.training.sharding import tensor_parallel_layout

    out = {}
    for job, model in models.items():
        split = tensor_parallel_layout(model, TP_MODEL).params
        whole = sum(p.numel() for p in model.parameters())
        out[job] = sum(p.numel() // (TP_MODEL if n in split else 1)
                       for n, p in model.named_parameters()) / whole
    return out


def p20_data(torch, dsp, root: str, corpus: str) -> dict:
    """Phase 20's inputs in an empty ``tp_ae``: the corpus, a
    mulaw-quantize preset and mu-law copy, MNIST."""
    base = os.path.join(root, "tp_ae")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    preset = os.path.join(base, "mulaw_quantize.json")
    with open(preset, "w", encoding="utf-8") as f:
        json.dump({"input_type": "mulaw-quantize", "quantize_channels": 256}, f)
    return {"corpus": corpus, "preset": preset,
            "mulaw": mulaw_corpus(torch, dsp, corpus, os.path.join(base, "corpus_mulaw"), 256),
            "mnist": write_mnist(os.path.join(base, "mnist"))}


def autoencoder_tensor_parallel_phase(torch, dsp, root: str, corpus: str, card: str,
                                      vq_kernel, fused_adam, gen, data: dict | None = None,
                                      runs: dict | None = None) -> tuple[dict, dict]:
    """Phase 20: ``cli.main --model hiervqvae|wavevqvae|vae --mesh-model 2``
    under torchrun at W 1, W 2 (data 1 x model 2) and, for the raw wave
    model, W 4 (2 x 2), the ranks sharing this card over gloo, at phase
    11's full widths and flags, each job against W 1's; ``cli.evaluate
    --mesh-model 2`` and a --resume step from W 1's hier and wave
    checkpoints; kernel 1 at the rank's K 256 shards and kernel 3 at each
    rank's n against their plain versions. ``data`` (``p20_data``) and
    ``runs``: its inputs and launches' records where they were made
    already (W 1 here, W 2 and 4 riding phase 21's launches). Returns (the
    record, the kernel rows)."""
    t0 = time.perf_counter()
    base = os.path.join(root, "tp_ae")
    if runs is None:
        data = p20_data(torch, dsp, root, corpus)
        runs = {w: launch_tp(torch, root, p20_jobs(root, data, w), w, "tp_ae", "wave_raw",
                             P20_COLLECTIVE_ITERS) for w in P20_WORLDS}
    one = runs[1]["ranks"][0]
    argv_w1 = {job["name"]: job["argv"] for job in p20_jobs(root, data, 1)}
    cpu_gaps: dict = {}

    def cpu_gap(job: str) -> float:
        # W 1's first step on the CPU, relative to W 1's norm (once a job)
        if job not in cpu_gaps:
            t_cpu = time.perf_counter()
            g1, g_cpu = one[job]["first_grad"], p20_cpu_grad(torch, one[job], argv_w1[job])
            keys = sorted(g1)
            v1 = torch.cat([g1[k].reshape(-1) for k in keys])
            v_cpu = torch.cat([g_cpu[k].reshape(-1) for k in keys])
            cpu_gaps[job] = {"grad_rel": float((v_cpu - v1).norm() / v1.norm()),
                             "seconds": time.perf_counter() - t_cpu}
        return cpu_gaps[job]["grad_rel"]

    shares = p20_shares(torch, p20_models(torch))
    out = {"phase": "tensor_parallel_autoencoders", "card": card, "model": TP_MODEL,
           "widths": {"dim": TRAIN_DIM, "codes": TRAIN_CODES, "batch": TRAIN_BATCH,
                      "num_downsample": WAVE_DOWNSAMPLE, "vae_z": VAE_Z, "steps": P20_STEPS},
           "table_share_a_rank": shares,
           "note": "the ranks share one card over gloo: steps/s measures equality's and the "
                   "collectives' cost, not scaling"}
    jobs = {}
    for w in P20_WORLDS[1:]:
        run, n_data = runs[w], w // TP_MODEL
        ranks = run["ranks"]
        for job in (P20_W4_FAMILIES if w == P20_WORLDS[-1] else P20_FAMILIES):
            init = P20_INIT_SEARCHES[job]
            want_s = one[job]["searches"]

            def searches(s, init=init, want_s=want_s, n_data=n_data):
                # the data init's whole-codebook searches, then every one on
                # this rank's rows and K / M codes
                return s[:init] == want_s[:init] and s[init:] == [
                    (r // n_data, k // TP_MODEL) for r, k in want_s[init:]]

            check_tp_launches(ranks, job, one[job]["launches"], searches)
            check_tp_groups(ranks, job)
            first = p20_first_step(torch, one[job], [r[job] for r in ranks])
            for i, s in enumerate(first["searches"]):
                check(s["cascade"] or s["flips"] == s["near_ties"],
                      f"tensor parallel {job} W {w}: search {i} flipped {s['flips']} codes, "
                      f"{s['flips'] - s['near_ties']} of them not near-ties")
                check(s["shard_max_abs_err"] <= 1e-5,
                      f"tensor parallel {job} W {w}: codebook shard {s['shard_max_abs_err']} "
                      "from W 1's rows")
            check(first["loss_rel"] <= DP_LOSS_REL,
                  f"tensor parallel {job} W {w}: first loss {first['loss']} against "
                  f"W 1's {first['loss_w1']}")
            limit = DP_GRAD_REL_FLIPS if first["flips"] else DP_GRAD_REL
            if first["grad_rel"] > limit and job != "vae":
                first["cpu_grad_rel"] = cpu_gap(job)
                limit = max(limit, P20_CPU_GAP_C * first["cpu_grad_rel"])
            check(first["grad_rel"] <= limit,
                  f"tensor parallel {job} W {w}: the gathered gradient {first['grad_rel']:.3g} "
                  f"of its norm away ({first['flips']} flips; the limit {limit:.3g})")
            share = [r[job]["local_n"] / one[job]["local_n"] for r in ranks]
            check(all(abs(s - shares[job]) <= P20_SHARE_TOL for s in share),
                  f"tensor parallel {job} W {w}: a rank's flat buffer is {share} of W 1's, the "
                  f"table's share is {shares[job]}")
            losses = [float(np.mean([r[job]["metrics"][i]["loss"] for r in ranks[::TP_MODEL]]))
                      for i in range(P20_STEPS)]
            check(all(np.isfinite(losses)), f"tensor parallel {job} W {w}: losses {losses}")
            jobs[f"{job}_w{w}"] = {
                "first_step": first, "losses": losses,
                "losses_w1": [m["loss"] for m in one[job]["metrics"]],
                "local_n": [r[job]["local_n"] for r in ranks], "local_n_w1": one[job]["local_n"],
                "split_at": ranks[0][job]["split_at"],
                "state_bytes_a_rank": [r[job]["state_bytes"] for r in ranks],
                "state_bytes_w1": one[job]["state_bytes"], "share_of_w1": share,
                "seconds": ranks[0][job]["seconds"], "seconds_w1": one[job]["seconds"],
                "launches": [r[job]["launches"] for r in ranks],
                "launches_w1": one[job]["launches"]}
        jobs[f"launch_seconds_w{w}"] = run["seconds"]
        jobs[f"wave_raw_w{w}"].update(
            collectives_ms_a_step=run["timing"][0]["collectives_ms"],
            collective_calls_a_step=run["timing"][0]["collective_calls"],
            backend=run["timing"][0]["backend"])
    jobs["launch_seconds_w1"] = runs[1]["seconds"]
    out["jobs"] = jobs
    out["cpu_first_step"] = cpu_gaps
    # steps/s of the raw wave model: the one interval between its two steps
    out["wave_raw_steps_per_s"] = {
        f"w{w}": float(1.0 / np.diff(runs[w]["ranks"][0]["wave_raw"]["step_t"])[0])
        for w in P20_WORLDS}

    # cli.evaluate --mesh-model 2 on W 1's checkpoints, against W 1's sweep
    w2 = runs[TP_MODEL]["ranks"]
    out["evaluate"] = {}
    for job in ("hier", "wave_raw"):
        name = f"evaluate_{job}"
        m1, m2 = one[name]["means"], w2[0][name]["means"]
        check(m1.keys() == m2.keys() and all(
            abs(m2[k] - m1[k]) <= (DP_EVAL_PPL_REL if k.startswith("perplexity")
                                   else DP_LOSS_REL) * abs(m1[k]) for k in m1),
              f"tensor parallel {name}: {m2} against W 1's {m1}")
        check_tp_launches(w2, name, one[name]["launches"],
                          lambda s, want=one[name]["searches"]: s == [
                              (r, k // TP_MODEL) for r, k in want])
        out["evaluate"][job] = {"w1": m1, "w2": m2}
        # one --resume step at M 2 from W 1's checkpoint
        name = f"resume_{job}"
        check_tp_launches(w2, name, {"fused_adam": 1})
        check_tp_groups(w2, name)
        model = "hiervqvae" if job == "hier" else "wavevqvae"
        resumed = os.path.join(base, f"w{TP_MODEL}", name, "models", model,
                               f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
        check(checkpoint_steps(resumed) == [P20_STEPS, P20_STEPS + 1],
              f"tensor parallel {name}: {resumed} holds {checkpoint_steps(resumed)}")
        out[name] = {"loss": w2[0][name]["metrics"][0]["loss"],
                     "launches": [r[name]["launches"] for r in w2]}

    # kernel 1 at a rank's K 256 shards on the first step's rows; kernel 3
    # at each rank's n
    vq_rows = {}
    for job, i, label in (("hier", 0, "hier_top"), ("hier", 1, "hier_bottom"),
                          ("wave_raw", 0, "wave_units")):
        rec = w2[0][job]["first_vqs"][i]
        row = compare_vq(torch, vq_kernel, rec["x"].to(DEVICE).contiguous(),
                         rec["cb"].to(DEVICE).contiguous())
        row["shape_of"] = f"tensor_parallel_{label}_shard"
        emit(row)
        check(row["mismatches"] == row["near_ties"] and row["run_to_run_identical"],
              f"vq_nearest {label} shard: {row['mismatches'] - row['near_ties']} mismatches "
              "that are not near-ties, or two calls differ")
        vq_rows[label] = row
    adam_rows = {}
    for job in P20_FAMILIES:
        row = compare_fused_adam(torch, fused_adam, w2[0][job]["local_n"], ADAM_CONFIGS[0], gen)
        row["shape_of"] = f"tensor_parallel_{job}_rank"
        emit(row)
        adam_rows[job] = row
    out["launches"] = {f"w{w}": [{job: r[job]["launches"] for job in r}
                                 for r in runs[w]["ranks"]] for w in P20_WORLDS}
    out["seconds"] = time.perf_counter() - t0
    return out, {"vq": vq_rows, "adam": adam_rows}


# ---------------------------------------------------------------------------
# Phase 21: the gated families on the model axis
# ---------------------------------------------------------------------------

P21_WORLDS = (1, 2, 4)  # one rank, (data 1 x model 2), (data 2 x model 2)
P21_VOCODER_STEPS = 2  # the vocoder's steps a job (mel MoL, mulaw-quantize)
P21_PIXELCNN_STEPS = 4  # the flat PixelCNN's (steps/s reads the last two intervals)
P21_HIER_STEPS = 2  # the spatially conditioned bottom prior's
P21_COLLECTIVE_ITERS = 1  # the vocoder step moves some 2 GB through gloo
P21_SHARE_TOL = 1e-3  # a rank's flat buffer against the table's share (alignment padding)
P21_SPEAKERS = 7  # the default arch's n_speakers, assigned to the corpus in turn
#: each job's CLI and whether it runs in bf16
P21_JOBS = {"mel": ("vocoder", False), "pixelcnn": ("prior", False),
            "mel_bf16": ("vocoder", True), "mulaw": ("vocoder", False),
            "units": ("vocoder", False), "hier_bottom": ("prior", False),
            "pixelcnn_bf16": ("prior", True), "mel_resume": ("vocoder", False),
            "pixelcnn_resume": ("prior", False)}
P21_W4_JOBS = ("mel", "pixelcnn")  # the jobs of the (2 x 2) launch


def p21_mulaw_corpus(torch, dsp, corpus: str, out: str) -> str:
    """The chirp corpus as mu-law integers (256 levels) with speaker ids
    0..P21_SPEAKERS-1 in turn: the vocoder's mulaw-quantize input with the
    speaker path (``speaker_embed`` and every ``g_i``)."""
    from neural_sound_generation_tpu_torch.data.manifest import read_manifest, write_manifest

    mulaw_corpus(torch, dsp, corpus, out, 256)
    entries = [dataclasses.replace(e, speaker_id=i % P21_SPEAKERS)
               for i, e in enumerate(read_manifest(out))]
    write_manifest(out, entries)
    return out


def p21_jobs(root: str, data: dict, world: int) -> list[dict]:
    """What one torchrun launch of ``world`` ranks runs with --mesh-model
    TP_MODEL above one rank: ``cli.vocoder train`` at phase 13's default
    vocoder (mel MoL, P21_VOCODER_STEPS steps) and ``cli.prior train`` at
    the CLI's default PixelCNN on phase 5's VQ-VAE (P21_PIXELCNN_STEPS);
    at W 1 and W 2 also one --bf16 step of each, mulaw-quantize with
    speakers, --condition units on phase 11's WaveVQVAE and the
    spatially conditioned bottom prior on phase 11's HierVQVAE; at W 2 one
    --resume step of each family from W 1's checkpoint (copied first)."""
    out = os.path.join(root, "tp_gated", f"w{world}")
    one = os.path.join(root, "tp_gated", "w1")
    mesh = [] if world == 1 else ["--mesh-model", str(TP_MODEL),
                                  "--mesh-data", str(world // TP_MODEL)]

    def vocoder(tag: str, steps: int, *extra, datadir=data["corpus"], preset=data["lr"],
                epochs: int = 1) -> list:
        return ["train", "--datadir", datadir, "--ckpt-dir", os.path.join(out, tag, "wavenet"),
                "--preset", preset, "--batch-size", str(VT_BATCH), "--epochs", str(epochs),
                "--max-batches-per-epoch", str(steps), "--device", DEVICE,
                *vocoder_width_flags(), *mesh, *extra]

    def prior(tag: str, steps: int, *extra, vq=data["vq"], epochs: int = 1) -> list:
        return ["train", "--datadir", data["corpus"], "--vqvae-ckpt", vq,
                "--ckpt-dir", os.path.join(out, tag, "prior"), "--batch-size", str(PRIOR_BATCH),
                "--epochs", str(epochs), "--max-batches-per-epoch", str(steps),
                "--dim", str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES), "--device", DEVICE,
                *mesh, *extra]

    argv = {"mel": vocoder("mel", P21_VOCODER_STEPS),
            "pixelcnn": prior("pixelcnn", P21_PIXELCNN_STEPS),
            "mel_bf16": vocoder("mel_bf16", 1, "--bf16"),
            "mulaw": vocoder("mulaw", P21_VOCODER_STEPS, datadir=data["mulaw"],
                             preset=data["mulaw_preset"]),
            "units": vocoder("units", 1, *units_flags(data["units"])),
            "hier_bottom": prior("hier_bottom", P21_HIER_STEPS, "--hier", "--hier-level",
                                 "bottom", vq=data["hier"]),
            "pixelcnn_bf16": prior("pixelcnn_bf16", 1, "--bf16"),
            "mel_resume": vocoder("mel_resume", 1, "--resume", epochs=2),
            "pixelcnn_resume": prior("pixelcnn_resume", 1, "--resume", epochs=2)}
    names = list(P21_W4_JOBS) if world == P21_WORLDS[-1] else [
        j for j in P21_JOBS if world == TP_MODEL or not j.endswith("_resume")]
    jobs = []
    for name in names:
        job = {"name": name, "cli": P21_JOBS[name][0], "argv": argv[name],
               "record_first_state": world == 1}
        if name.endswith("_resume"):
            source = name[:-len("_resume")]
            job["copy"] = [os.path.join(one, source), os.path.join(out, name)]
        jobs.append(job)
    return jobs


def p21_data(torch, dsp, base: str, data: dict) -> dict:
    """``data`` with the vocoder jobs' presets under ``base`` (the lr,
    mulaw-quantize with speakers) and the mu-law copy of the corpus."""
    data = dict(data, lr=os.path.join(base, "vocoder_lr.json"),
                mulaw_preset=os.path.join(base, "mulaw_speakers.json"),
                mulaw=p21_mulaw_corpus(torch, dsp, data["corpus"],
                                       os.path.join(base, "corpus_mulaw")))
    with open(data["lr"], "w", encoding="utf-8") as f:
        json.dump({"initial_learning_rate": VT_LR}, f)
    with open(data["mulaw_preset"], "w", encoding="utf-8") as f:
        json.dump({"input_type": "mulaw-quantize", "quantize_channels": 256,
                   "exponential_moving_average": False, "gin_channels": VT_SPEAKER_GIN,
                   "initial_learning_rate": VT_LR}, f)
    return data


def p21_cpu_grad(torch, cli, one: dict, argv: list) -> dict:
    """W 1's first step again on the CPU (float32, this process's threads)
    from W 1's recorded state and batch: the gradient by name after the
    step. The gap between two devices' one-rank gradients is the float32
    order-of-sums noise of this state, which the model axis's split sums
    meet too (phase 20's ``p20_cpu_grad`` for the vocoder and the prior)."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    args = cli.parse_args(argv)
    if hasattr(cli, "build_model"):  # cli.vocoder
        cfg = cli._load_cfg(args)
        model = cli.build_model(cfg, args)
    else:
        cfg = cli._prior_cfg(args)
        bottom = args.hier and args.hier_level == "bottom"
        model = cli.PriorSpec.from_args(args, cond_dim=args.dim if bottom else 0).build(args.seed)
    model.load_state_dict(one["first_state"])
    state = create_train_state(model, cfg.train)
    make_train_step(model, cfg)(state, one["first_batch"], torch.Generator().manual_seed(SEED))
    return {k: g.clone() for k, g in state.flat.named(state.flat.grad).items()}


def p21_shares(torch, cli_vocoder, cfg) -> dict:
    """A model rank's share of the default vocoder's and PixelCNN's
    parameters under the port's table at M TP_MODEL."""
    from neural_sound_generation_tpu_torch.models import GatedPixelCNN

    return p20_shares(torch, {
        "mel": cli_vocoder.build_model(cfg, vocoder_widths()),
        "pixelcnn": GatedPixelCNN(TRAIN_CODES, PIXELCNN_DIM, PIXELCNN_LAYERS)})


def gated_tensor_parallel_phase(torch, dsp, cli_vocoder, cli_prior, root: str, data: dict,
                                card: str, vq_kernel, fused_adam, gen,
                                riders=None) -> tuple[dict, dict]:
    """Phase 21: ``cli.vocoder train --mesh-model 2`` and ``cli.prior train
    --mesh-model 2`` (the default ``--arch pixelcnn``) under torchrun at W
    1, W 2 (data 1 x model 2) and W 4 (2 x 2), the ranks sharing this card
    over gloo, each job against a W 1 launch of the same flags (see
    ``p21_jobs``); then ``synthesize`` and ``cli.prior sample`` from W 2's
    checkpoints on this process, kernel 1 at the ranks' encode shapes and
    kernel 3 at the ranks' n. ``data``: the chirp corpus ("corpus"), phase
    5's VQ-VAE ("vq"), phase 11's HierVQVAE ("hier") and WaveVQVAE
    ("units"). ``riders(data, world) -> ({tag: jobs}, {tag: (timing job,
    iterations)})``: other phases' jobs that ride this phase's launches of
    the same world (phases 18, 19, 20 and 22). Returns (the record, the
    kernel rows, with W 1's records, their argv and the derived data, which
    phase 22 holds its pipe jobs against, and the riders' runs by world and
    tag)."""
    from neural_sound_generation_tpu_torch.config import Config, load_preset

    t0 = time.perf_counter()
    base = os.path.join(root, "tp_gated")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    data = p21_data(torch, dsp, base, data)
    runs = {}
    for w in P21_WORLDS:
        jobs, timings = riders(data, w) if riders and w > 1 else ({}, {})
        runs[w] = launch_tp(torch, root, p21_jobs(root, data, w), w, "tp_gated", "mel",
                            P21_COLLECTIVE_ITERS, jobs, timings)
    one = runs[1]["ranks"][0]
    argv_w1 = {job["name"]: job["argv"] for job in p21_jobs(root, data, 1)}
    mods = {"vocoder": cli_vocoder, "prior": cli_prior}
    cpu_gaps: dict = {}

    def cpu_gap(job: str) -> float:
        # W 1's first step on the CPU, relative to W 1's norm (once a job)
        if job not in cpu_gaps:
            t_cpu = time.perf_counter()
            g1 = one[job]["first_grad"]
            g_cpu = p21_cpu_grad(torch, mods[P21_JOBS[job][0]], one[job], argv_w1[job])
            keys = sorted(g1)
            v1 = torch.cat([g1[k].reshape(-1) for k in keys])
            v_cpu = torch.cat([g_cpu[k].reshape(-1) for k in keys])
            cpu_gaps[job] = {"grad_rel": float((v_cpu - v1).norm() / v1.norm()),
                             "seconds": time.perf_counter() - t_cpu}
        return cpu_gaps[job]["grad_rel"]

    cfg = load_preset(data["lr"], Config())
    shares = p21_shares(torch, cli_vocoder, cfg)
    out = {"phase": "tensor_parallel_gated", "card": card, "model": TP_MODEL,
           "widths": {"vocoder": {"layers": 24, "stacks": 4, "residual": 512, "gate": 512,
                                  "skip": 256, "cin": 80, "batch": VT_BATCH, "samples": 7168},
                      "pixelcnn": {"dim": PIXELCNN_DIM, "layers": PIXELCNN_LAYERS,
                                   "codes": TRAIN_CODES, "batch": PRIOR_BATCH, "grid": [20, 7]},
                      "steps": {"vocoder": P21_VOCODER_STEPS, "pixelcnn": P21_PIXELCNN_STEPS,
                                "hier_bottom": P21_HIER_STEPS}},
           "table_share_a_rank": shares,
           "note": "the ranks share one card over gloo: steps/s measures equality's and the "
                   "collectives' cost, not scaling"}
    jobs = {}
    for w in P21_WORLDS[1:]:
        run = runs[w]
        ranks = run["ranks"]
        for job in ranks[0]:
            if job.endswith("_resume"):
                want = {"fused_adam": 1, "vq_nearest": one[job[:-len("_resume")]]["launches"][
                    "vq_nearest"] // len(one[job[:-len("_resume")]]["metrics"])}
            else:
                want = one[job]["launches"]
            check_tp_launches(ranks, job, want)
            check_tp_groups(ranks, job)
            losses = [float(np.mean([r[job]["metrics"][i]["loss"] for r in ranks[::TP_MODEL]]))
                      for i in range(len(ranks[0][job]["metrics"]))]
            check(all(np.isfinite(losses)), f"tensor parallel {job} W {w}: losses {losses}")
            rec = {"losses": losses,
                   "launches": [r[job]["launches"] for r in ranks],
                   "local_n": [r[job]["local_n"] for r in ranks],
                   "split_at": ranks[0][job]["split_at"],
                   "state_bytes_a_rank": [r[job]["state_bytes"] for r in ranks],
                   "seconds": ranks[0][job]["seconds"]}
            if not job.endswith("_resume"):
                bf16 = P21_JOBS[job][1]
                first = p19_first_step(torch, one[job], [r[job] for r in ranks])
                check(first["loss_rel"] <= (BF16_LOSS_REL if bf16 else DP_LOSS_REL),
                      f"tensor parallel {job} W {w}: first loss {first['loss']} against "
                      f"W 1's {first['loss_w1']}")
                if not bf16:
                    limit = DP_GRAD_REL
                    if first["grad_rel"] > limit:
                        first["cpu_grad_rel"] = cpu_gap(job)
                        limit = max(limit, P20_CPU_GAP_C * first["cpu_grad_rel"])
                    check(first["grad_rel"] <= limit,
                          f"tensor parallel {job} W {w}: the gathered gradient "
                          f"{first['grad_rel']:.3g} of its norm away (the limit {limit:.3g})")
                rec.update(first_step=first, losses_w1=[m["loss"] for m in one[job]["metrics"]],
                           local_n_w1=one[job]["local_n"], seconds_w1=one[job]["seconds"],
                           launches_w1=one[job]["launches"])
            if job in shares:
                share = [n / one[job]["local_n"] for n in rec["local_n"]]
                check(all(abs(s - shares[job]) <= P21_SHARE_TOL for s in share),
                      f"tensor parallel {job} W {w}: a rank's flat buffer is {share} of W 1's, "
                      f"the table's share is {shares[job]}")
                rec["share_of_w1"] = share
            jobs[f"{job}_w{w}"] = rec
        jobs[f"launch_seconds_w{w}"] = run["seconds"]
        jobs[f"launch_wall_w{w}"] = launch_wall(run)
        jobs[f"mel_w{w}"].update(
            collectives_ms_a_step=run["timing"][0]["collectives_ms"],
            collective_calls_a_step=run["timing"][0]["collective_calls"],
            backend=run["timing"][0]["backend"])
    jobs["launch_seconds_w1"] = runs[1]["seconds"]
    out["jobs"] = jobs
    out["cpu_first_step"] = cpu_gaps
    # steps/s: the vocoder's one interval between its two steps, the
    # PixelCNN's median of its last two
    out["steps_per_s"] = {
        "mel": {f"w{w}": float(1.0 / np.diff(runs[w]["ranks"][0]["mel"]["step_t"])[0])
                for w in P21_WORLDS},
        "pixelcnn": {f"w{w}": dp_step_rate(runs[w]["ranks"][0]["pixelcnn"])
                     for w in P21_WORLDS}}

    # the --resume steps at M 2 from W 1's checkpoints
    w2 = os.path.join(base, f"w{TP_MODEL}")
    for job, name, steps in (("mel_resume", "wavenet", P21_VOCODER_STEPS),
                             ("pixelcnn_resume", "prior", P21_PIXELCNN_STEPS)):
        for sub in ("", "_train"):
            got = checkpoint_steps(os.path.join(w2, job, name + sub))
            check(got == [steps, steps + 1], f"tensor parallel {job}: {name + sub} holds {got}")
    # W 2's checkpoints synthesize and sample on one rank (this process)
    sr, hop = cfg.audio.sample_rate, cfg.audio.effective_hop_size
    mel_npy = os.path.join(base, "mel.npy")
    np.save(mel_npy, np.load(os.path.join(data["corpus"], "m0.npy")))
    out["synthesize"] = vocoder_synthesize(
        cli_vocoder, vq_kernel, ["synthesize", "--ckpt-dir", os.path.join(w2, "mel", "wavenet"),
                                 "--mel-npy", mel_npy, "--max-frames", str(WN_SYNTH_FRAMES)],
        os.path.join(base, "mel.wav"), WN_SYNTH_FRAMES * hop, sr)
    h, w_ = P19_SAMPLE_GRID
    out["sample_cli"] = run_sample_cli(cli_prior, [
        "sample", "--vqvae-ckpt", data["vq"], "--prior-ckpt",
        os.path.join(w2, "pixelcnn", "prior") + "_ema", "--dim", str(TRAIN_DIM),
        "--z-dim", str(TRAIN_CODES), "--code-shape", str(h), str(w_), "--device", DEVICE],
        os.path.join(base, "samples"), "prior_sample", 4 * w_)

    # kernel 1 at each new (rows, codes) shape a rank searched (the frozen
    # encoders whole, on its rows); kernel 3 at the ranks' n
    shapes = sorted({s for w in P21_WORLDS[1:] for job in runs[w]["ranks"][0]
                     for s in runs[w]["ranks"][0][job]["searches"]})
    vq_rows = {}
    for n, k in shapes:
        x = torch.randn(n, VQ_D, generator=gen, device=DEVICE)
        cb = torch.randn(k, VQ_D, generator=gen, device=DEVICE)
        row = compare_vq(torch, vq_kernel, x, cb)
        row["shape_of"] = f"tensor_parallel_gated_n{n}"
        emit(row)
        check(row["mismatches"] == row["near_ties"] and row["run_to_run_identical"],
              f"vq_nearest N={n} K={k}: {row['mismatches'] - row['near_ties']} mismatches "
              "that are not near-ties, or two calls differ")
        vq_rows[f"n{n}"] = row
    adam_rows = {}
    for job in ("mel", "mulaw", "pixelcnn"):
        row = compare_fused_adam(torch, fused_adam, jobs[f"{job}_w{TP_MODEL}"]["local_n"][0],
                                 ADAM_CONFIGS[0], gen)
        row["shape_of"] = f"tensor_parallel_{job}_rank"
        emit(row)
        adam_rows[job] = row
    out["launches"] = {f"w{w}": [{job: r[job]["launches"] for job in r}
                                 for r in runs[w]["ranks"]] for w in P21_WORLDS}
    out["seconds"] = time.perf_counter() - t0
    return out, {"vq": vq_rows, "adam": adam_rows, "w1": one, "w1_argv": argv_w1, "data": data,
                 "riders": {w: run["riders"] for w, run in runs.items() if run.get("riders")}}


# ---------------------------------------------------------------------------
# Phase 22: the pipe axis (GPipe)
# ---------------------------------------------------------------------------

P22_PRIOR_STEPS = 2  # the dense pipe-2 prior's steps (its _pp_train feeds the pipe-4 resume)
P22_BATCH4 = 4  # the pipe-4 vocoder's batch: one row a microbatch
#: each pipe job: (its W 1 record's job, its CLI, bf16, the mesh flags);
#: the jobs of a launch of W ranks are those whose flags make W (they ride
#: phase 21's launches, so their names are its and phase 19's apart)
P22_JOBS = {
    "pp_dense": ("dense", "prior", False, ["--mesh-pipe", "2"]),
    "pp_routed": ("routed", "prior", False, ["--mesh-pipe", "2"]),
    "pp_bf16": ("bf16", "prior", True, ["--mesh-pipe", "2"]),
    "pp_hier_bottom": ("hier_bottom", "prior", False, ["--mesh-pipe", "2"]),
    "pp_mel": ("mel", "vocoder", False, ["--mesh-pipe", "2"]),
    "pp_mel_bf16": ("mel_bf16", "vocoder", True, ["--mesh-pipe", "2"]),
    "pp_mulaw": ("mulaw", "vocoder", False, ["--mesh-pipe", "2"]),
    "pp_units": ("units", "vocoder", False, ["--mesh-pipe", "2"]),
    "pp_dense_d2": ("dense", "prior", False, ["--mesh-pipe", "2", "--mesh-data", "2"]),
    "pp_dense_p4": ("dense", "prior", False, ["--mesh-pipe", "4", "--pp-microbatches", "4"]),
    "pp_resume_p4": (None, "prior", False, ["--mesh-pipe", "4", "--resume", "--epochs", "2"]),
    "pp_mel_p4": ("mel_b4", "vocoder", False, ["--mesh-pipe", "4"]),
}
# kernel 4 at a stage's microbatches of phase 7's step (batch 32 of 20 x 7
# grids, 2 heads): 16 rows at pipe 2 (BH 32), 8 on a (2 x 2) mesh's rows
# and at pipe 4 over 4 microbatches (BH 16), f32 and bf16
P22_ATTN_SHAPES = [("pp_prior_T140_bh32", 32, 140, 64, False),
                   ("pp_prior_T140_bh32_bf16", 32, 140, 64, True),
                   ("pp_prior_T140_bh16", 16, 140, 64, False),
                   ("pp_prior_T140_bh16_bf16", 16, 140, 64, True)]


def p22_mesh(flags: list) -> tuple[int, int, int]:
    """(D, S, M) of a job's mesh flags."""
    def value(flag, default):
        return int(flags[flags.index(flag) + 1]) if flag in flags else default

    n_pipe = value("--mesh-pipe", 1)
    return value("--mesh-data", 1), n_pipe, value("--pp-microbatches", n_pipe)


def p22_argv(argv: list, out: str, tag: str, flags: list, steps: int = 1) -> list:
    """A W 1 job's argv for a pipe job: its own --ckpt-dir under ``out``,
    ``steps`` batches, the mesh flags last (a later --epochs wins)."""
    a = list(argv)
    i = a.index("--ckpt-dir")
    a[i + 1] = os.path.join(out, tag, os.path.basename(a[i + 1]))
    a[a.index("--max-batches-per-epoch") + 1] = str(steps)
    return a + flags


def p22_w1_argv(root: str, corpus: str, vq_ckpt: str, hier_ckpt: str, gated_data: dict) -> dict:
    """The argv of each W 1 job a pipe job is held against: phase 19's and
    21's (from phase 21's ``data``), and two that phase 22 runs itself, the
    hier-bottom transformer and the batch-4 vocoder."""
    argv = {job["name"]: job["argv"] for job in p19_jobs(root, corpus, vq_ckpt, 1)}
    argv.update({job["name"]: job["argv"] for job in p21_jobs(root, gated_data, 1)})
    here = os.path.join(root, "pp", "w1")
    bottom = p22_argv(argv["dense"], here, "hier_bottom", ["--hier", "--hier-level", "bottom"])
    bottom[bottom.index("--vqvae-ckpt") + 1] = hier_ckpt
    mel_b4 = p22_argv(argv["mel"], here, "mel_b4", [])
    mel_b4[mel_b4.index("--batch-size") + 1] = str(P22_BATCH4)
    return {**argv, "hier_bottom": bottom, "mel_b4": mel_b4}


def p22_jobs(root: str, w1_argv: dict, world: int) -> list[dict]:
    """The pipe jobs of a launch of ``world`` ranks, each built from its W 1
    job's argv; the pipe-4 resume copies the pipe-2 dense run's
    checkpoints (its ``_pp_train`` at step P22_PRIOR_STEPS) first."""
    out = os.path.join(root, "pp", f"w{world}")
    jobs = []
    for name, (w1, cli, _, flags) in P22_JOBS.items():
        n_data, n_pipe, _ = p22_mesh(flags)
        if n_data * n_pipe != world:
            continue
        job = {"name": name, "cli": cli}
        if name == "pp_resume_p4":
            job["copy"] = [os.path.join(root, "pp", "w2", "pp_dense"), os.path.join(out, name)]
            job["argv"] = p22_argv(w1_argv["dense"], out, name, flags)
        else:
            steps = P22_PRIOR_STEPS if name == "pp_dense" else 1
            job["argv"] = p22_argv(w1_argv[w1], out, name, flags, steps)
        jobs.append(job)
    return jobs


def p22_stage_n(torch, cli, argv: list, n_pipe: int) -> list[tuple[int, int]]:
    """Each stage's (parameter count, parameter tensors) of a job's model
    (built whole on the host, then cut to the stage as
    ``parallel.pipeline.place_stage`` cuts it)."""
    import argparse

    from neural_sound_generation_tpu_torch.parallel import pipeline as pp

    args = cli.parse_args(argv)
    counts = []
    for s in range(n_pipe):
        if hasattr(cli, "build_model"):  # cli.vocoder
            model = cli.build_model(cli._load_cfg(args),
                                    argparse.Namespace(**{**vars(args), "bf16": False}))
            pp.pp_wavenet_partition(model, pp.Stage(s, n_pipe))
        else:
            bottom = args.hier and args.hier_level == "bottom"
            model = cli.PriorSpec.from_args(args, cond_dim=args.dim if bottom else 0).build()
            pp.pp_prior_partition(model, pp.Stage(s, n_pipe))
        params = list(model.parameters())
        counts.append((sum(p.numel() for p in params), len(params)))
    return counts


def check_pp_groups(ranks: list, job: str, n_pipe: int) -> None:
    """Every rank's local state bit-equal across its data group (the ranks
    of its stage), its rest (past ``split_at``) across its pipe group."""
    for r, rank in enumerate(ranks):
        for s, other in enumerate(ranks):
            a, b = rank[job]["digests"], other[job]["digests"]
            if r % n_pipe == s % n_pipe:
                check(a["local"] == b["local"],
                      f"pipeline {job}: ranks {r} and {s} (one stage) differ")
            if r // n_pipe == s // n_pipe:
                check(a["replicated"] == b["replicated"],
                      f"pipeline {job}: ranks {r} and {s} (one pipe group) differ in the rest")


def p22_first_step(torch, one: dict, ranks: list, n_pipe: int) -> dict:
    """A job's first step under the pipe against W 1's: the loss (the
    mean of the data rows', each its pipe group's), the gradient norm, the
    gathered gradient relative to W 1's norm, and the parameters after the
    step (rank 0's gathered records, the same on every rank)."""
    rank0 = ranks[0]
    g1, g2 = one["first_grad"], rank0["first_grad"]
    keys = sorted(g1)
    check(sorted(g2) == keys, "pipeline: the gathered gradient's names differ from W 1's")
    v1 = torch.cat([g1[k].reshape(-1) for k in keys])
    v2 = torch.cat([g2[k].reshape(-1) for k in keys])
    loss1 = one["metrics"][0]["loss"]
    loss2 = float(np.mean([r["metrics"][0]["loss"] for r in ranks[::n_pipe]]))
    norm1, norm2 = one["metrics"][0]["grad_norm"], rank0["metrics"][0]["grad_norm"]
    p1, p2 = one["first_params"], rank0["first_params"]
    return {"loss_w1": loss1, "loss": loss2, "loss_rel": abs(loss2 - loss1) / abs(loss1),
            "grad_norm_w1": norm1, "grad_norm": norm2,
            "grad_norm_rel": abs(norm2 - norm1) / abs(norm1),
            "grad_rel": float((v2 - v1).norm() / v1.norm()),
            "params_max_abs_err": max(float((p2[k] - p1[k]).abs().max()) for k in keys)}


def pipeline_parallel_phase(torch, cli_prior, cli_vocoder, root: str, corpus: str,
                            vq_ckpt: str, hier_ckpt: str, card: str, tpp_rows: dict,
                            tpg_rows: dict, fa, vq_kernel, fused_adam, gen,
                            runs: dict | None = None) -> tuple[dict, dict]:
    """Phase 22: ``cli.prior train --arch transformer --mesh-pipe`` and
    ``cli.vocoder train --mesh-pipe`` under torchrun, the ranks sharing this
    card over gloo: at W 2 (pipe 2) the dense, routed, bf16 and
    hier-bottom priors and the mel MoL, bf16, mulaw-quantize-with-speakers
    and units vocoders; at W 4 the dense prior on (data 2 x pipe 2) and at
    pipe 4 with 4 microbatches, a pipe-4 --resume from the pipe-2 run's
    ``_pp_train`` sibling, the vocoder at pipe 4 on batch 4. Each job is
    held against its W 1 run of the same flags (phases 19 and 21 ran most
    of them; the hier-bottom transformer and the batch-4 vocoder run here,
    in this process). Then ``cli.prior sample`` and ``cli.vocoder
    synthesize`` from the pipe-2 artifacts on one rank, kernel 4 at the
    stages' BH 16 and 32, kernel 3 at a stage's n and kernel 1 at a rank's
    rows. ``runs``: the pipe launches' records where they ran already
    (riding phase 21's launches). Returns (the record, the kernel rows)."""
    from neural_sound_generation_tpu_torch.config import Config, load_preset

    t0 = time.perf_counter()
    base = os.path.join(root, "pp")
    w1_argv = p22_w1_argv(root, corpus, vq_ckpt, hier_ckpt, tpg_rows["data"])
    if runs is None:
        shutil.rmtree(base, ignore_errors=True)
        runs = {w: launch_tp(torch, root, p22_jobs(root, w1_argv, w), w, "pp", None)
                for w in (2, 4)}
    one = {**tpp_rows["w1"], **tpg_rows["w1"]}
    # the W 1 runs no earlier phase made: the hier-bottom transformer, the batch-4 vocoder
    extra = launch_tp(torch, root, [
        {"name": "hier_bottom", "cli": "prior", "argv": w1_argv["hier_bottom"]},
        {"name": "mel_b4", "cli": "vocoder", "argv": w1_argv["mel_b4"],
         "record_first_state": True}], 1, "pp_w1")
    one.update(extra["ranks"][0])
    mods = {"prior": cli_prior, "vocoder": cli_vocoder}
    out = {"phase": "pipeline_parallel", "card": card,
           "widths": {"prior": {"dim": PRIOR_DIM, "layers": PRIOR_LAYERS, "heads": PRIOR_HEADS,
                                "batch": PRIOR_BATCH, "grid": [20, 7]},
                      "vocoder": {"layers": 24, "stacks": 4, "residual": 512, "gate": 512,
                                  "skip": 256, "cin": 80, "batch": VT_BATCH, "samples": 7168,
                                  "batch_pipe4": P22_BATCH4}},
           "note": "the ranks share one card over gloo: a step's time measures the hand-offs' "
                   "and the collectives' cost, not scaling"}
    jobs, cpu_gaps, shares = {}, {}, {}
    for w, run in runs.items():
        ranks = run["ranks"]
        argvs = {j["name"]: j["argv"] for j in p22_jobs(root, w1_argv, w)}
        for job in ranks[0]:
            w1, cli, bf16, flags = P22_JOBS[job]
            n_data, n_pipe, n_micro = p22_mesh(flags)
            steps = len(ranks[0][job]["metrics"])
            check(steps == (P22_PRIOR_STEPS if job == "pp_dense" else 1),
                  f"pipeline {job}: {steps} steps")
            argv = argvs[job]
            args = mods[cli].parse_args(argv)
            want = {"fused_adam": steps}
            if cli == "prior":
                want["vq_nearest"] = steps * (2 if args.hier else 1)
                want.update({k: args.prior_layers // n_pipe * n_micro * steps
                             for k in fa.KERNELS})
            else:
                want["vq_nearest"] = steps if args.condition == "units" else 0
            check_tp_launches(ranks, job, want)
            rows = args.batch_size // n_data // n_micro
            for r, rank in enumerate(ranks):
                bhs = {q[0] for _, q, _ in rank[job]["attention"]}
                check(cli != "prior" or bhs == {rows * PRIOR_HEADS},
                      f"pipeline {job} rank {r}: kernel 4 at BH {bhs}, expected "
                      f"{rows * PRIOR_HEADS}")
            check_pp_groups(ranks, job, n_pipe)
            key = (cli, w1 or "dense", n_pipe)
            if key not in shares:
                shares[key] = p22_stage_n(torch, mods[cli], argv, n_pipe)
            for r, rank in enumerate(ranks):
                # its stage's parameters, each leaf padded to 16 bytes
                n, leaves = shares[key][r % n_pipe]
                check(0 <= rank[job]["local_n"] - n < 4 * leaves,
                      f"pipeline {job} rank {r}: a flat buffer of {rank[job]['local_n']} for "
                      f"a stage of {n} parameters")
            rec = {"mesh": {"data": n_data, "pipe": n_pipe, "microbatches": n_micro},
                   "losses": [float(np.mean([r[job]["metrics"][i]["loss"]
                                             for r in ranks[::n_pipe]]))
                              for i in range(steps)],
                   "launches": [r[job]["launches"] for r in ranks],
                   "local_n": [r[job]["local_n"] for r in ranks],
                   "stage_n": [n for n, _ in shares[key]],
                   "split_at": [r[job]["split_at"] for r in ranks],
                   "state_bytes_a_rank": [r[job]["state_bytes"] for r in ranks],
                   "handoff_s": [r[job].get("handoff_s") for r in ranks],
                   "handoff_bytes": [r[job].get("handoff_bytes") for r in ranks],
                   "seconds": ranks[0][job]["seconds"]}
            check(all(np.isfinite(rec["losses"])), f"pipeline {job}: losses {rec['losses']}")
            if w1 is not None:
                first = p22_first_step(torch, one[w1], [r[job] for r in ranks], n_pipe)
                check(first["loss_rel"] <= (BF16_LOSS_REL if bf16 else DP_LOSS_REL),
                      f"pipeline {job}: first loss {first['loss']} against W 1's "
                      f"{first['loss_w1']}")
                if not bf16:
                    # a routed step may flip near-tie routings (phase 17's bound);
                    # the vocoder's dilated weight gradients are not
                    # deterministic on the card: twice the CPU's gap (phase 21)
                    limit = DP_GRAD_REL_FLIPS if job == "routed" else DP_GRAD_REL
                    if first["grad_rel"] > limit and cli == "vocoder":
                        if w1 not in cpu_gaps:
                            g1 = one[w1]["first_grad"]
                            g_cpu = p21_cpu_grad(torch, cli_vocoder, one[w1], w1_argv[w1])
                            v1 = torch.cat([g1[k].reshape(-1) for k in sorted(g1)])
                            v_cpu = torch.cat([g_cpu[k].reshape(-1) for k in sorted(g1)])
                            cpu_gaps[w1] = float((v_cpu - v1).norm() / v1.norm())
                        first["cpu_grad_rel"] = cpu_gaps[w1]
                        limit = max(limit, P20_CPU_GAP_C * cpu_gaps[w1])
                    check(first["grad_rel"] <= limit and first["grad_norm_rel"] <= limit,
                          f"pipeline {job}: the gathered gradient {first['grad_rel']:.3g} and "
                          f"its norm {first['grad_norm_rel']:.3g} of the norm away (the limit "
                          f"{limit:.3g})")
                    # Adam's first (cold) step moves an element by at most lr
                    # whatever its gradient, so two correct runs part by 2 lr
                    # where a gradient is rounding noise
                    lr = args.lr if cli == "prior" else VT_LR
                    check(first["params_max_abs_err"] <= 2 * lr * 1.0001,
                          f"pipeline {job}: parameters after the first step "
                          f"{first['params_max_abs_err']:.3g} from W 1's (2 lr {2 * lr:.3g})")
                rec["first_step"] = first
            jobs[f"{job}_w{w}"] = rec
        jobs[f"launch_seconds_w{w}"] = run["seconds"]
    jobs["w1_seconds_here"] = extra["seconds"]
    out["jobs"] = jobs
    out["cpu_first_step_grad_rel"] = cpu_gaps

    # the pipe-4 resume: the pipe-2 run's two steps, then one
    resumed = os.path.join(base, "w4", "pp_resume_p4", "prior")
    for sub in ("", "_ema", "_pp_train"):
        got = checkpoint_steps(resumed + sub)
        check(got == [P22_PRIOR_STEPS, P22_PRIOR_STEPS + 1],
              f"pipeline --resume at pipe 4: {resumed + sub} holds {got}")
    # the pipe-2 artifacts sample and synthesize on one rank (this process)
    w2 = os.path.join(base, "w2")
    h, w_ = P19_SAMPLE_GRID
    out["sample_cli"] = run_sample_cli(cli_prior, [
        "sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt",
        os.path.join(w2, "pp_dense", "prior") + "_ema", "--arch", "transformer",
        "--prior-dim", str(PRIOR_DIM), "--prior-layers", str(PRIOR_LAYERS), "--dim",
        str(TRAIN_DIM), "--z-dim", str(TRAIN_CODES), "--code-shape", str(h), str(w_),
        "--device", DEVICE], os.path.join(base, "samples"), "prior_sample", 4 * w_)
    cfg = load_preset(tpg_rows["data"]["lr"], Config())
    mel_npy = os.path.join(base, "mel.npy")
    np.save(mel_npy, np.load(os.path.join(corpus, "m0.npy")))
    out["synthesize"] = vocoder_synthesize(
        cli_vocoder, vq_kernel, ["synthesize", "--ckpt-dir", os.path.join(w2, "pp_mel", "wavenet"),
                                 "--mel-npy", mel_npy, "--max-frames", str(WN_SYNTH_FRAMES)],
        os.path.join(base, "mel.wav"), WN_SYNTH_FRAMES * cfg.audio.effective_hop_size,
        cfg.audio.sample_rate)

    # kernel 4 at the stages' BH, kernel 3 at a stage's n, kernel 1 at a rank's rows
    attn_rows = {}
    for shape in P22_ATTN_SHAPES:
        row = compare_attention(torch, fa, shape, gen)
        emit(row)
        limit = ATTN_BF16_REL if shape[4] else ATTN_F32_REL
        check(max(row["rel_err"].values()) <= limit and row["run_to_run_identical"],
              f"flash attention {shape[0]}: errors {row['rel_err']} above {limit}")
        for kernel, plan in row["plan"].items():
            check(plan["spill_bytes"] == 0,
                  f"{kernel} {shape[0]}: {plan['spill_bytes']} bytes spilled per thread")
        attn_rows[shape[0]] = row
    adam_rows = {}
    for job in ("pp_dense", "pp_mel"):
        row = compare_fused_adam(torch, fused_adam, jobs[f"{job}_w2"]["local_n"][0],
                                 ADAM_CONFIGS[0], gen)
        row["shape_of"] = f"pipeline_{job[3:]}_stage0"
        emit(row)
        adam_rows[job[3:]] = row
    vq_rows = {}
    for n, k in sorted({s for run in runs.values() for job in run["ranks"][0]
                        for s in run["ranks"][0][job]["searches"]}):
        x = torch.randn(n, VQ_D, generator=gen, device=DEVICE)
        cb = torch.randn(k, VQ_D, generator=gen, device=DEVICE)
        row = compare_vq(torch, vq_kernel, x, cb)
        row["shape_of"] = f"pipeline_n{n}"
        emit(row)
        check(row["mismatches"] == row["near_ties"] and row["run_to_run_identical"],
              f"vq_nearest N={n} K={k}: {row['mismatches'] - row['near_ties']} mismatches "
              "that are not near-ties, or two calls differ")
        vq_rows[f"n{n}"] = row
    out["launches"] = {f"w{w}": [{job: r[job]["launches"] for job in r}
                                 for r in runs[w]["ranks"]] for w in runs}
    out["launches"]["w1"] = [{job: r["launches"] for job, r in extra["ranks"][0].items()}]
    out["seconds"] = time.perf_counter() - t0
    return out, {"attention": attn_rows, "adam": adam_rows, "vq": vq_rows}


# ---------------------------------------------------------------------------
# Phase 23: sequence parallelism and the utilities
# ---------------------------------------------------------------------------

SEQ_B, SEQ_T = 2, 131_072  # 5.9 s at 22,050 Hz; divides over 2 and 4 ranks
SEQ_CHUNKS = 4  # the input is 4 seeded chunks of T / 4: one array at W 2 and W 4
#: job -> (Cin, Cout, K, dilation, causal): the default vocoder's widest
#: dilated layer (24 layers in 4 stacks) and the WaveVQVAE encoder's "same"
#: convolution
SEQ_JOBS = {"vocoder_dilated": (512, 512, 3, 32, True),
            "wavevqvae_same": (256, 256, 3, 1, False)}
SEQ_GATHER_T = 16_384  # sharded_conv1d's end-to-end run (the whole array gathered)
SEQ_EXCHANGE_ITERS = 5
# of the largest magnitude of the one-rank result: cuDNN may pick other
# algorithms at other lengths, and the kernel's gradient sums the ranks' parts
SEQ_OUT_REL = 1e-5
SEQ_GRAD_REL = 1e-4
# the spectrogram on the card against the CPU, of the largest magnitude:
# two float32 FFT libraries (the CPU test measures XLA's against PyTorch's
# at 4e-6 of the largest)
SPEC_CARD_REL = 1e-4
TRACED_STEPS = 3  # phase 5's steps under StepTimer and trace_context


def seq_array(torch, seed: int, t: int, c: int, lo: int, hi: int):
    """Chunks ``lo`` to ``hi`` - 1 of the seeded (SEQ_B, t, c) array of
    SEQ_CHUNKS chunks along T, on the card: each chunk from a generator of
    its own, so that a rank builds its shard alone."""
    per = t // SEQ_CHUNKS
    parts = []
    for j in range(lo, hi):
        g = torch.Generator(device=DEVICE).manual_seed(seed * SEQ_CHUNKS + j)
        parts.append(torch.randn((SEQ_B, per, c), generator=g, device=DEVICE))
    return torch.cat(parts, dim=1)


def seq_reference(torch, x, kernel, dilation: int, causal: bool):
    """A one-rank cuDNN ``conv1d`` of the whole (B, T, Cin) array."""
    import torch.nn.functional as F

    halo = (kernel.shape[0] - 1) * dilation
    pad = (halo, 0) if causal else (halo // 2, halo - halo // 2)
    return F.conv1d(F.pad(x.transpose(1, 2), pad), kernel.permute(2, 1, 0),
                    dilation=dilation).transpose(1, 2)


def seq_jobs() -> list[dict]:
    """Phase 23's rider jobs of a launch: one a convolution of SEQ_JOBS."""
    return [{"name": name, "fn": "seq", "seed": n + 1, "gather": n == 0}
            for n, name in enumerate(SEQ_JOBS)]


def run_seq_job(torch, job: dict) -> dict:
    """One rank of a phase-23 job: its shard of the seeded input through
    ``halo_conv1d`` (forward and the backward of sum(y * w)), the exchange
    alone timed, the kernel's gradient summed over the ranks; then the
    one-rank convolution of the whole array on this rank, the reference.
    With ``gather``, ``sharded_conv1d`` end to end at SEQ_GATHER_T."""
    from neural_sound_generation_tpu_torch.parallel import distributed, make_mesh, sequence

    t0 = time.perf_counter()
    cin, cout, k, dilation, causal = SEQ_JOBS[job["name"].split(".")[-1]]
    mesh = make_mesh(n_data=distributed.world_size())
    n, i = mesh.axis_size("data"), mesh.axis_index("data")
    per, t = SEQ_CHUNKS // n, SEQ_T // n
    seed = job["seed"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    kernel = torch.randn((k, cin, cout), generator=g, device=DEVICE) / (k * cin) ** 0.5

    def rel(got, want, scale) -> float:
        return float((got - want).abs().max() / scale.abs().max())

    x_local = seq_array(torch, 10 * seed, SEQ_T, cin, i * per, (i + 1) * per).requires_grad_(True)
    w_local = seq_array(torch, 10 * seed + 1, SEQ_T, cout, i * per, (i + 1) * per)
    k_local = kernel.clone().requires_grad_(True)
    sync(torch)
    t_conv = time.perf_counter()
    y = sequence.halo_conv1d(x_local, k_local, "data", causal, dilation, mesh)
    (y * w_local).sum().backward()
    sync(torch)
    conv_s = time.perf_counter() - t_conv
    left, right = sequence._pads(k, dilation, causal)
    times = []
    for it in range(SEQ_EXCHANGE_ITERS + 1):
        sync(torch)
        ts = time.perf_counter()
        sequence._Halo.apply(x_local.detach(), mesh, "data", left, right)
        sync(torch)
        if it:
            times.append(1e3 * (time.perf_counter() - ts))
    dk = k_local.grad.clone()
    mesh.all_reduce_(dk)
    x = seq_array(torch, 10 * seed, SEQ_T, cin, 0, SEQ_CHUNKS).requires_grad_(True)
    kk = kernel.clone().requires_grad_(True)
    y_ref = seq_reference(torch, x, kk, dilation, causal)
    (y_ref * seq_array(torch, 10 * seed + 1, SEQ_T, cout, 0, SEQ_CHUNKS)).sum().backward()
    mine = slice(i * t, (i + 1) * t)
    row = 4 * SEQ_B * cin  # bytes of one sample across the batch and channels
    rec = {"world": n, "index": i, "shape": [SEQ_B, SEQ_T, cin, cout], "k": k,
           "dilation": dilation, "causal": causal, "halo": [left, right],
           "out_rel": rel(y.detach(), y_ref.detach()[:, mine], y_ref.detach()),
           "x_grad_rel": rel(x_local.grad, x.grad[:, mine], x.grad),
           "kernel_grad_rel": rel(dk, kk.grad, kk.grad),
           "halo_bytes_sent": row * ((left if i < n - 1 else 0) + (right if i > 0 else 0)),
           "halo_bytes_received": row * ((left if i > 0 else 0) + (right if i < n - 1 else 0)),
           "exchange_ms": float(np.median(times)), "halo_conv_s": conv_s}
    del x, kk, y_ref, x_local, w_local, k_local, y
    if job.get("gather"):
        xg = seq_array(torch, 10 * seed + 2, SEQ_GATHER_T, cin, 0, SEQ_CHUNKS).requires_grad_(True)
        wg = seq_array(torch, 10 * seed + 3, SEQ_GATHER_T, cout, 0, SEQ_CHUNKS)
        kg = kernel.clone().requires_grad_(True)
        sync(torch)
        ts = time.perf_counter()
        yg = sequence.sharded_conv1d(xg, kg, mesh, causal, dilation)
        (yg * wg).sum().backward()
        sync(torch)
        gather_s = time.perf_counter() - ts
        xr = xg.detach().clone().requires_grad_(True)
        kr = kernel.clone().requires_grad_(True)
        yr = seq_reference(torch, xr, kr, dilation, causal)
        (yr * wg).sum().backward()
        rec["gather"] = {"t": SEQ_GATHER_T, "out_rel": rel(yg.detach(), yr.detach(), yr.detach()),
                         "x_grad_rel": rel(xg.grad, xr.grad, xr.grad),
                         "kernel_grad_rel": rel(kg.grad, kr.grad, kr.grad), "seconds": gather_s}
    rec["seconds"] = time.perf_counter() - t0
    return rec


def utils_checks(torch, root: str, vq_ckpt: str) -> dict:
    """``utils`` in this process: the spectrogram parser on the card against
    the CPU, the codebook projection of phase 5's trained codebook, and
    its plot where matplotlib is installed."""
    import importlib.util

    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.training import checkpoint
    from neural_sound_generation_tpu_torch.utils import project_codebook_2d, visualize_embedding
    from neural_sound_generation_tpu_torch.utils.spectrogram_dataset import SpectrogramParser

    t0 = time.perf_counter()
    out_dir = os.path.join(root, "utils")
    os.makedirs(out_dir, exist_ok=True)
    sr = 16000
    t = np.arange(2 * sr) / sr
    wav = (0.5 * np.sin(2 * np.pi * (200 * t + 1500 * t**2))).astype(np.float32)
    path = os.path.join(out_dir, "chirp.wav")
    dsp.save_wav(wav, path, sr)
    card_spec = SpectrogramParser(sample_rate=sr, device=DEVICE).parse_audio(path)
    cpu_spec = SpectrogramParser(sample_rate=sr, device="cpu").parse_audio(path)
    spec_rel = float(np.abs(card_spec - cpu_spec).max() / np.abs(cpu_spec).max())
    check(card_spec.shape == cpu_spec.shape and spec_rel <= SPEC_CARD_REL,
          f"SpectrogramParser card vs CPU: {spec_rel:.3g} of the largest (limit "
          f"{SPEC_CARD_REL}), shapes {card_spec.shape} {cpu_spec.shape}")
    state = torch.load(os.path.join(vq_ckpt, f"step_{checkpoint.latest_step(vq_ckpt)}",
                                    "state.pt"), weights_only=True)
    codebook = state["params/codebook"].numpy()
    coords = project_codebook_2d(codebook)
    var = coords.var(axis=0)
    check(coords.shape == (codebook.shape[0], 2) and bool(np.isfinite(coords).all())
          and var[0] >= var[1],
          f"project_codebook_2d: shape {coords.shape}, variances {var.tolist()}")
    matplotlib = importlib.util.find_spec("matplotlib") is not None
    emit({"phase": "matplotlib", "installed": matplotlib})
    png = None
    if matplotlib:
        png_path = os.path.join(out_dir, "codebook.png")
        visualize_embedding(codebook, png_path)
        png = os.path.getsize(png_path)
        check(png > 0, "visualize_embedding wrote an empty file")
    return {"spectrogram": {"shape": list(card_spec.shape), "card_vs_cpu_rel": spec_rel,
                            "limit": SPEC_CARD_REL},
            "codebook_projection": {"codes": int(coords.shape[0]),
                                    "variances": [float(v) for v in var]},
            "matplotlib": matplotlib, "png_bytes": png, "seconds": time.perf_counter() - t0}


def sequence_parallel_phase(torch, rode: dict, root: str, vq_ckpt: str, card: str,
                            phase5_s: float) -> dict:
    """Phase 23: the checks of the halo-convolution jobs that rode phase
    21's W 2 and W 4 launches, then ``utils_checks``. ``phase5_s``: what
    the native-loader and tracing checks added to phase 5."""
    out = {"phase": "sequence_parallel", "card": card, "batch": SEQ_B, "samples": SEQ_T,
           "jobs": {}, "limits": {"out_rel": SEQ_OUT_REL, "grad_rel": SEQ_GRAD_REL}}
    rider_s = 0.0
    for w, by_tag in sorted(rode.items()):
        ranks = by_tag["seq"]["ranks"]
        for name in SEQ_JOBS:
            recs = [r[name] for r in ranks]
            check(sorted(r["index"] for r in recs) == list(range(w)),
                  f"seq {name} W {w}: shard indices {[r['index'] for r in recs]}")
            worst = {key: max(r[key] for r in recs)
                     for key in ("out_rel", "x_grad_rel", "kernel_grad_rel")}
            check(worst["out_rel"] <= SEQ_OUT_REL and worst["x_grad_rel"] <= SEQ_GRAD_REL
                  and worst["kernel_grad_rel"] <= SEQ_GRAD_REL,
                  f"halo_conv1d {name} W {w} against the whole array: {worst}")
            job = {**worst, "halo": recs[0]["halo"],
                   "halo_bytes_sent": [r["halo_bytes_sent"] for r in recs],
                   "exchange_ms": [r["exchange_ms"] for r in recs],
                   "halo_conv_s": [r["halo_conv_s"] for r in recs],
                   "rank0_seconds": recs[0]["seconds"]}
            if "gather" in recs[0]:
                gw = {key: max(r["gather"][key] for r in recs)
                      for key in ("out_rel", "x_grad_rel", "kernel_grad_rel")}
                check(gw["out_rel"] <= SEQ_OUT_REL and gw["x_grad_rel"] <= SEQ_GRAD_REL
                      and gw["kernel_grad_rel"] <= SEQ_GRAD_REL,
                      f"sharded_conv1d {name} W {w} against the whole array: {gw}")
                job["sharded_conv1d"] = {**gw, "t": SEQ_GATHER_T,
                                         "seconds": recs[0]["gather"]["seconds"]}
            out["jobs"][f"{name}_w{w}"] = job
            rider_s += recs[0]["seconds"]
    out["utils"] = utils_checks(torch, root, vq_ckpt)
    out["rider_s"] = rider_s
    out["added_s"] = rider_s + out["utils"]["seconds"] + phase5_s
    return out


def checkpoint_steps(ckpt_dir: str) -> list:
    """The step numbers a checkpoint directory holds, in order."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(n[len("step_"):]) for n in os.listdir(ckpt_dir) if n.startswith("step_"))


def dp_launch_totals(dp: dict) -> dict:
    """Phase 17's launches of each kernel, summed over its runs and ranks."""
    totals: dict = {}
    for ranks in dp["launches"].values():
        for rank in ranks:
            for counts in rank.values():
                for k, n in counts.items():
                    totals[k] = totals.get(k, 0) + n
    return totals


ATTN_REPLACES = {
    "flash_fwd": "neural_sound_generation_tpu/ops/pallas/attention.py:165",
    "flash_bwd_dq": "neural_sound_generation_tpu/ops/pallas/attention.py:233",
    "flash_bwd_dkdv": "neural_sound_generation_tpu/ops/pallas/attention.py:233",
}


def attention_summary(rows: dict, name: str, launches_by_path: dict,
                      bf16_launches: int) -> dict:
    """One attention kernel's entry of the kernels line, at the shape the
    prior's training path gives it (ATTN_MAIN), with its time at every
    shape beside and its launches on bf16 inputs (phase 15's, all of them
    in bf16). The backward kernels have no library call of their own;
    their entries carry the whole backward's times under ``backward``."""
    main = rows[ATTN_MAIN]
    entry = {
        "name": name, "route": "cuda",
        "source": "neural_sound_generation_tpu_torch/csrc/flash_attention.cu",
        "replaces": ATTN_REPLACES[name], "status": "ported",
        "shape": {"bh": main["bh"], "t": main["t"], "d": main["d"], "dtype": main["dtype"]},
        "launches": sum(launches_by_path.values()), "launches_by_path": launches_by_path,
        "bf16_launches": bf16_launches,
        "max_abs_err": main["max_abs_err"][name],
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


def build_phase(build, modules, motion_capture, native_loader) -> list[dict]:
    """Every kernel's library, one nvcc per source, and the native
    libraries of the motion path and the data loader (g++), all started
    together."""
    errors: dict = {}
    gxx_s = {}

    def load(mod):
        try:
            t = time.perf_counter()
            if mod in (motion_capture, native_loader):
                mod.load_library(rebuild=True)
                gxx_s[mod] = time.perf_counter() - t
            else:
                mod.load(rebuild=True)
        except (RuntimeError, OSError) as e:  # reported below, the run fails
            errors[mod.__name__] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=load, args=(m,))
               for m in (*modules, motion_capture, native_loader)]
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
    for mod, name in ((motion_capture, "nsgmotion"), (native_loader, "nsgloader")):
        path = mod.library_path()
        check(path.parent == mod.BUILD_DIR,
              f"{name} library at {path}, expected under {mod.BUILD_DIR}")
        rows.append({"phase": "build", "library": name, "seconds": seconds,
                     "gxx_seconds": gxx_s[mod], "path": str(path)})
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        from neural_sound_generation_tpu_torch.cli import evaluate as cli_evaluate
        from neural_sound_generation_tpu_torch.cli import main as cli_main
        from neural_sound_generation_tpu_torch.cli import motion as cli_motion
        from neural_sound_generation_tpu_torch.cli import prior as cli_prior
        from neural_sound_generation_tpu_torch.cli import serve
        from neural_sound_generation_tpu_torch.cli import vocoder as cli_vocoder
        from neural_sound_generation_tpu_torch.data import native_loader
        from neural_sound_generation_tpu_torch.device import set_full_float32
        from neural_sound_generation_tpu_torch.models import VQVAE, GatedPixelCNN
        from neural_sound_generation_tpu_torch.models import wavenet as wn
        from neural_sound_generation_tpu_torch.motion import capture as motion_capture
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
        for row in build_phase(build, (vq_kernel, fused_adam, fa, wavenet_gen, conv3x3),
                               motion_capture, native_loader):
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
        # kernel 3 at the default PixelCNN's parameter count (phase 12's steps)
        n_pixelcnn = sum(p.numel() for p in GatedPixelCNN(
            TRAIN_CODES, PIXELCNN_DIM, PIXELCNN_LAYERS).parameters())
        adam_pixelcnn = compare_fused_adam(torch, fused_adam, n_pixelcnn, ADAM_CONFIGS[0], gen)
        adam_pixelcnn["shape_of"] = "pixelcnn"
        emit(adam_pixelcnn)
        # and at the routed prior's (phase 14's steps)
        adam_moe = compare_fused_adam(torch, fused_adam, MOE_PARAMS, ADAM_CONFIGS[0], gen)
        adam_moe["shape_of"] = "moe_prior"
        emit(adam_moe)
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
        torch.cuda.empty_cache()

        # phase 11: the other autoencoders through cli.main, cli.evaluate and
        # cli.serve, with launch counts from each run; kernel 1 at their shapes
        others = other_autoencoders_phase(torch, cli_main, cli_evaluate, serve, checkpoint, dsp,
                                          vq_kernel, fused_adam, root, corpus, card)
        emit(others)
        torch.cuda.empty_cache()

        # phase 12: the PixelCNN prior and the hierarchical chain through
        # cli.prior and cli.serve, with launch counts from each run
        priors = priors_phase(torch, cli_prior, serve, checkpoint, (vq_kernel, fused_adam, fa),
                              root, vq_ckpt, corpus, card)
        emit(priors)
        torch.cuda.empty_cache()

        # phase 13: vocoder training through cli.vocoder, with launch counts
        # from each run; kernel 3 at the vocoder's parameter counts
        vtrain = vocoder_train_phase(torch, cli_vocoder, checkpoint, dsp, vq_kernel, fused_adam,
                                     root, corpus, card)
        emit(vtrain)
        torch.cuda.empty_cache()

        # phase 14: the routed transformer prior through cli.prior and
        # cli.serve, with launch counts from each run
        moe = moe_prior_phase(torch, cli_prior, serve, checkpoint, (vq_kernel, fused_adam, fa),
                              root, vq_ckpt, corpus, card)
        emit(moe)
        torch.cuda.empty_cache()

        # phase 15: the priors in bf16 through cli.prior, with launch counts
        # from each run (kernel 4's in bf16), and chunked attention
        hier = {"vq": os.path.join(root, "hier", "models", "hiervqvae",
                                   f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}"),
                "top": os.path.join(root, "hier_prior", "top_ema"),
                "bottom": os.path.join(root, "hier_prior", "bottom_ema")}
        bf16 = bf16_prior_phase(torch, cli_prior, checkpoint, (vq_kernel, fused_adam, fa), fa,
                                root, vq_ckpt, corpus,
                                os.path.join(root, "prior", "models_ema"), hier, card)
        emit(bf16)
        torch.cuda.empty_cache()

        # phase 16: the motion path through cli.motion and
        # MotionDrivenGenerator, with kernel 1's launches over the stream
        motion, motion_rows = motion_phase(torch, cli_motion, motion_capture, vq_kernel, VQVAE,
                                           root, vq_ckpt, card)
        emit(motion)
        torch.cuda.empty_cache()

        # phase 17: the training CLIs under torchrun on one rank and on two
        # sharing this card, with each rank's launch counts
        dp = data_parallel_phase(torch, root, corpus, vq_ckpt, card)
        emit(dp)
        torch.cuda.empty_cache()

        # phases 18 to 23 share one torchrun launch a world: phase 21's
        # launches carry the two- and four-rank jobs of phases 18, 19, 20, 22
        # and 23 (a launch's rank start-up costs some 20 s of the command's
        # 1,200); the one-rank jobs of phases 19 and 20 run here first, and
        # each phase's checks follow phase 21
        tpp_w1 = p19_runs(torch, root, corpus, vq_ckpt)
        ae_data = p20_data(torch, dsp, root, corpus)
        tpa_w1 = launch_tp(torch, root, p20_jobs(root, ae_data, 1), 1, "tp_ae")
        hier_ckpt = os.path.join(root, "hier", "models", "hiervqvae",
                                 f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")
        for tag in ("tp", "pp"):
            shutil.rmtree(os.path.join(root, tag), ignore_errors=True)
        for w in TP_WORLDS:  # phase 18's evaluate job writes its dump there
            os.makedirs(os.path.join(root, "tp", f"w{w}"))

        def riders(data, world):
            return ({"tp": tp_jobs(root, corpus, world),
                     "tp_prior": p19_jobs(root, corpus, vq_ckpt, world),
                     "tp_ae": p20_jobs(root, ae_data, world),
                     "pp": p22_jobs(root, p22_w1_argv(root, corpus, vq_ckpt, hier_ckpt, data),
                                    world),
                     "seq": seq_jobs()},
                    {"tp": ("flagship", TP_COLLECTIVE_ITERS),
                     "tp_prior": ("dense", TP_COLLECTIVE_ITERS),
                     "tp_ae": ("wave_raw", P20_COLLECTIVE_ITERS)})

        # phase 21: cli.vocoder train and cli.prior train (the PixelCNN)
        # with --mesh-model 2 under torchrun (ranks sharing this card), with
        # each rank's launch counts; kernel 1 at the ranks' encode shapes,
        # kernel 3 at each rank's n
        tpg, tpg_rows = gated_tensor_parallel_phase(
            torch, dsp, cli_vocoder, cli_prior, root, {
                "corpus": corpus, "vq": vq_ckpt, "hier": hier_ckpt,
                "units": os.path.join(root, "wave", "models", "wavevqvae",
                                      f"checkpoint_ljspeech_{TRAIN_DIM}_{TRAIN_CODES}")},
            card, vq_kernel, fused_adam, gen, riders)
        emit(tpg)
        rode = tpg_rows["riders"]
        torch.cuda.empty_cache()

        # phase 18: cli.main and cli.evaluate with --mesh-model 2 under
        # torchrun (ranks sharing this card), with each rank's launch
        # counts; kernel 1 over codebook shards, kernel 3 at a rank's n
        tp, tp_rows = tensor_parallel_phase(torch, root, corpus, card, dp, vq_kernel,
                                            fused_adam, gen,
                                            {w: rode[w]["tp"] for w in TP_WORLDS})
        emit(tp)

        # phase 19: cli.prior train --arch transformer with --mesh-model 2
        # under torchrun (ranks sharing this card), dense, routed, bf16 and
        # --resume, with each rank's launch counts; kernel 4 at a rank's
        # heads, kernel 3 at a rank's n
        tpp, tpp_rows = prior_tensor_parallel_phase(
            torch, cli_prior, root, corpus, vq_ckpt, card, fa, fused_adam, gen,
            {1: tpp_w1, **{w: rode[w]["tp_prior"] for w in P19_WORLDS[1:]}})
        emit(tpp)

        # phase 20: cli.main and cli.evaluate with --mesh-model 2 for the
        # HierVQVAE, the WaveVQVAE and the VAE under torchrun (ranks sharing
        # this card), with each rank's launch counts; kernel 1 on a rank's
        # K 256 shards, kernel 3 at each rank's n
        tpa, tpa_rows = autoencoder_tensor_parallel_phase(
            torch, dsp, root, corpus, card, vq_kernel, fused_adam, gen, ae_data,
            {1: tpa_w1, **{w: rode[w]["tp_ae"] for w in P20_WORLDS[1:]}})
        emit(tpa)
        torch.cuda.empty_cache()

        # phase 22: cli.prior train --arch transformer and cli.vocoder train
        # with --mesh-pipe under torchrun (ranks sharing this card), each job
        # against W 1's, with each rank's launch counts; kernel 4 at the
        # stages' BH, kernel 3 at a stage's n, kernel 1 at a rank's rows
        ppl, ppl_rows = pipeline_parallel_phase(
            torch, cli_prior, cli_vocoder, root, corpus, vq_ckpt, hier_ckpt, card, tpp_rows,
            tpg_rows, fa, vq_kernel, fused_adam, gen, {w: rode[w]["pp"] for w in (2, 4)})
        emit(ppl)

        # phase 23: the halo convolution's jobs of phase 21's launches, then
        # the utilities in this process
        seq = sequence_parallel_phase(torch, rode, root, vq_ckpt, card, training["added_s"])
        emit(seq)
    except (SmokeFailure, RuntimeError, ValueError, OSError, KeyError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # summary and result
    dp_launches = dp_launch_totals(dp)
    tp_launches = dp_launch_totals(tp)
    tpp_launches = dp_launch_totals(tpp)
    tpa_launches = dp_launch_totals(tpa)
    tpg_launches = dp_launch_totals(tpg)
    ppl_launches = dp_launch_totals(ppl)
    sharded, adam_local = tp_rows["vq_sharded"], tp_rows["adam_local"]
    train_runs = [*training["runs"].values(), rvq["run"]]
    train_vq = sum(r["launches"]["vq_kernel"] for r in train_runs)
    train_adam = sum(r["launches"]["fused_adam"] for r in train_runs)
    prior_runs = prior["runs"].values()
    prior_launches = {k: sum(r["launches"][k] for r in prior_runs)
                      for k in ("vq_nearest", "fused_adam", *fa.KERNELS)}
    priors_launches = priors["launches"]
    moe_launches = moe["launches"]
    bf16_launches = bf16["launches"]
    main_row, train_row = rows[VQ_MAIN_SHAPE], rows[VQ_TRAIN_SHAPE]
    adam_row = adam_rows[ADAM_CONFIGS[0][0]]
    emit({"kernels": [{
        "name": "vq_nearest", "route": "cuda",
        "source": "neural_sound_generation_tpu_torch/csrc/vq_nearest.cu",
        "replaces": "neural_sound_generation_tpu/ops/pallas/vq_kernel.py:49",
        "status": "ported", "shape": {"n": VQ_MAIN_SHAPE[0], "k": VQ_MAIN_SHAPE[1], "d": VQ_D},
        "launches": (serving["vq_launches"] + train_vq + prior_launches["vq_nearest"]
                     + prep["vq_launches"] + others["vq_launches"]
                     + priors_launches["vq_nearest"] + vtrain["vq_launches"]
                     + moe_launches["vq_nearest"] + bf16_launches["vq_nearest"]
                     + motion["vq_launches"] + dp_launches["vq_nearest"]
                     + tp_launches["vq_nearest"] + tpp_launches["vq_nearest"]
                     + tpa_launches["vq_nearest"] + tpg_launches["vq_nearest"]
                     + ppl_launches["vq_nearest"]),
        "launches_by_path": {"serving": serving["vq_launches"], "training": train_vq,
                             "prior": prior_launches["vq_nearest"],
                             "preprocess_units": prep["vq_launches"],
                             "other_autoencoders": others["vq_launches"],
                             "pixelcnn_and_hier_priors": priors_launches["vq_nearest"],
                             "vocoder_units": vtrain["vq_launches"],
                             "moe_prior": moe_launches["vq_nearest"],
                             "bf16_prior": bf16_launches["vq_nearest"],
                             "motion": motion["vq_launches"],
                             "data_parallel": dp_launches["vq_nearest"],
                             "tensor_parallel": tp_launches["vq_nearest"],
                             "tensor_parallel_prior": tpp_launches["vq_nearest"],
                             "tensor_parallel_autoencoders": tpa_launches["vq_nearest"],
                             "tensor_parallel_gated": tpg_launches["vq_nearest"],
                             "pipeline_parallel": ppl_launches["vq_nearest"]},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "training_shape": {"n": VQ_TRAIN_SHAPE[0], "ms": train_row["kernel_ms"],
                           "plain_ms": train_row["plain_ms"], "bound_ms": train_row["bound_ms"],
                           "library_ms": train_row["library_ms"]},
        "other_autoencoder_shapes": {
            name: {"n": r["n"], "ms": r["kernel_ms"], "device_ms": r["kernel_device_ms"],
                   "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "library_ms": r["library_ms"], "max_abs_err": r["max_abs_err"]}
            for name, r in others["vq_rows"].items()},
        "motion_shapes": {
            name: {"n": r["n"], "ms": r["kernel_ms"], "device_ms": r["kernel_device_ms"],
                   "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                   "bound_3xtf32_ms": r["tensor_core_bound_ms"], "library_ms": r["library_ms"],
                   "ctas": r["ctas"], "max_abs_err": r["max_abs_err"]}
            for name, r in motion_rows.items()},
        "sharded_shape": {"n": sharded["n"], "k": TRAIN_CODES // TP_MODEL,
                          **{k: sharded["shard_k256"][k] for k in (
                              "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                              "bound_3xtf32_ms", "library_ms")},
                          "index_mismatches_vs_whole": {
                              f"m{m}": sharded[f"m{m}"]["index_mismatches"] for m in TP_SHARDS},
                          "score_mismatches_vs_whole": {
                              f"m{m}": sharded[f"m{m}"]["score_mismatches"] for m in TP_SHARDS},
                          "score_max_abs_err_vs_float64": sharded["score_max_abs_err_vs_float64"]},
        "tensor_parallel_autoencoder_shapes": {
            name: {"n": r["n"], "k": r["k"], "ms": r["kernel_ms"],
                   "device_ms": r["kernel_device_ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                   "bound_3xtf32_ms": r["tensor_core_bound_ms"], "library_ms": r["library_ms"],
                   "library_device_ms": r["library_device_ms"], "ctas": r["ctas"],
                   "max_abs_err": r["max_abs_err"]}
            for name, r in tpa_rows["vq"].items()},
        "tensor_parallel_gated_shapes": {
            name: {"n": r["n"], "k": r["k"], "ms": r["kernel_ms"],
                   "device_ms": r["kernel_device_ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                   "bound_3xtf32_ms": r["tensor_core_bound_ms"], "library_ms": r["library_ms"],
                   "library_device_ms": r["library_device_ms"], "ctas": r["ctas"],
                   "max_abs_err": r["max_abs_err"]}
            for name, r in tpg_rows["vq"].items()},
        "pipeline_parallel_shapes": {
            name: {"n": r["n"], "k": r["k"], "ms": r["kernel_ms"],
                   "device_ms": r["kernel_device_ms"], "plain_ms": r["plain_ms"],
                   "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                   "bound_3xtf32_ms": r["tensor_core_bound_ms"], "library_ms": r["library_ms"],
                   "library_device_ms": r["library_device_ms"], "ctas": r["ctas"],
                   "max_abs_err": r["max_abs_err"]}
            for name, r in ppl_rows["vq"].items()},
    }, {
        "name": "fused_adam", "route": "cuda",
        "source": "neural_sound_generation_tpu_torch/csrc/fused_adam.cu",
        "replaces": "neural_sound_generation_tpu/ops/pallas/fused_adam.py:49",
        "status": "ported", "shape": {"n": n_params, "config": adam_row["config"]},
        "launches": (train_adam + prior_launches["fused_adam"] + others["adam_launches"]
                     + priors_launches["fused_adam"] + vtrain["adam_launches"]
                     + moe_launches["fused_adam"] + bf16_launches["fused_adam"]
                     + dp_launches["fused_adam"] + tp_launches["fused_adam"]
                     + tpp_launches["fused_adam"] + tpa_launches["fused_adam"]
                     + tpg_launches["fused_adam"] + ppl_launches["fused_adam"]),
        "launches_by_path": {"training": train_adam, "prior": prior_launches["fused_adam"],
                             "other_autoencoders": others["adam_launches"],
                             "pixelcnn_and_hier_priors": priors_launches["fused_adam"],
                             "vocoder_training": vtrain["adam_launches"],
                             "moe_prior": moe_launches["fused_adam"],
                             "bf16_prior": bf16_launches["fused_adam"],
                             "data_parallel": dp_launches["fused_adam"],
                             "tensor_parallel": tp_launches["fused_adam"],
                             "tensor_parallel_prior": tpp_launches["fused_adam"],
                             "tensor_parallel_autoencoders": tpa_launches["fused_adam"],
                             "tensor_parallel_gated": tpg_launches["fused_adam"],
                             "pipeline_parallel": ppl_launches["fused_adam"]},
        "max_abs_err": adam_row["max_abs_err"],
        "ms": adam_row["kernel_ms"], "plain_ms": adam_row["plain_ms"],
        "bound_ms": adam_row["bound_ms"], "bound_by": adam_row["bound_by"],
        "library_ms": adam_row["library_ms"],
        "pixelcnn_shape": {k: adam_pixelcnn[k] for k in ADAM_ROW_KEYS},
        "moe_prior_shape": {k: adam_moe[k] for k in ADAM_ROW_KEYS},
        "tensor_parallel_rank_shape": {k: adam_local[k] for k in ADAM_ROW_KEYS},
        **{f"tensor_parallel_{job}_prior_rank_shape": {k: r[k] for k in ADAM_ROW_KEYS}
           for job, r in tpp_rows["adam"].items()},
        **{f"tensor_parallel_{job}_rank_shape": {k: r[k] for k in ADAM_ROW_KEYS}
           for job, r in tpa_rows["adam"].items()},
        **{f"tensor_parallel_gated_{job}_rank_shape": {k: r[k] for k in ADAM_ROW_KEYS}
           for job, r in tpg_rows["adam"].items()},
        **{f"pipeline_{job}_stage_shape": {k: r[k] for k in ADAM_ROW_KEYS}
           for job, r in ppl_rows["adam"].items()},
        "vocoder_shapes": {tag: {k: r[k] for k in ("config",) + ADAM_ROW_KEYS}
                           for tag, r in vtrain["adam_rows"].items()},
    }] + [attention_summary({**attn_rows, **tpp_rows["attention"], **ppl_rows["attention"]},
                            name,
                            {"prior": prior_launches[name],
                             "hier_top_prior": priors_launches[name],
                             "moe_prior": moe_launches[name],
                             "bf16_prior": bf16_launches[name],
                             "data_parallel": dp_launches[name],
                             "tensor_parallel": tp_launches.get(name, 0),
                             "tensor_parallel_prior": tpp_launches[name],
                             "tensor_parallel_autoencoders": tpa_launches.get(name, 0),
                             "tensor_parallel_gated": tpg_launches.get(name, 0),
                             "pipeline_parallel": ppl_launches[name]},
                            bf16["bf16_attention_launches"][name])
          for name in fa.KERNELS]
      + wavenet_summary(wn_rows, wn_api) + conv_summary(conv_rows, conv_ab)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank_main(sys.argv[2]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(sys.argv[2]))
    sys.exit(main())

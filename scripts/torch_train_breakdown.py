#!/usr/bin/env python3
"""Where the time of one training step goes in the PyTorch port, on a CUDA card.

Builds the flagship mel VQ-VAE (dim 256, 512 codes) and its train state on
the card, seeds the codebook from the encoder outputs of one batch of 64
mel crops of 80 x 28 (uniform values in [0, 1), the range of normalized
mels), float32 with TF32 off, and:

  * times the phases of a step with CUDA events (median of REPEATS steps
    after a warm-up): forward with the loss, backward, the optimizer
    (global norm, per-step scalars and the fused kernel), the whole step;
  * times the host's enqueue of one step (no synchronization): when it
    is as long as the device's step, the host bounds the step;
  * times the two kernels of the step alone at its shapes;
  * traces PROFILED_STEPS steps with ``torch.profiler`` and prints the
    kernels that take the most device time and the device's busy share
    of the steps' wall time.

``--bf16`` runs the convolutions in bf16 (``cli.main --bf16``);
``--num-quantizers Q`` trains residual VQ; ``--ema-codebook`` learns the
codebook by EMA with dead-code restarts at threshold 1.0, timed as a
fourth phase.

Run from the repository root: ``python3 scripts/torch_train_breakdown.py
[--bf16] [--num-quantizers Q] [--ema-codebook]``. Prints one JSON line per
measurement; fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 20
PROFILED_STEPS = 10
BATCH, N_MELS, FRAMES = 64, 80, 28


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="where a train step's time goes")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--num-quantizers", type=int, default=1)
    p.add_argument("--ema-codebook", action="store_true")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neural_sound_generation_tpu_torch.cli.main import apply_data_codebook_init
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import resolve_device
    from neural_sound_generation_tpu_torch.models import VQVAE
    from neural_sound_generation_tpu_torch.ops.cuda import fused_adam, vq_kernel
    from neural_sound_generation_tpu_torch.training.losses import vqvae_loss
    from neural_sound_generation_tpu_torch.training.train_state import (
        create_train_state,
        fused_flat_update,
    )
    from neural_sound_generation_tpu_torch.training.trainer import (
        _ema_codebook_step,
        make_train_step,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    device = resolve_device("cuda")
    cfg = Config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_quantizers=args.num_quantizers, ema_codebook=args.ema_codebook,
        restart_dead_threshold=1.0 if args.ema_codebook else 0.0))
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(BATCH, N_MELS, FRAMES, 1, generator=gen, device=device)
    model = VQVAE(1, 256, 512, generator=torch.Generator().manual_seed(0),
                  num_quantizers=args.num_quantizers,
                  dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    apply_data_codebook_init(model, x, gen)
    state = create_train_state(model, cfg.train, ema_codebook=args.ema_codebook)
    step = make_train_step(model, cfg)
    for _ in range(5):
        step(state, {"x": x}, gen)
    torch.cuda.synchronize()

    # the phases of a step, between events on the device's timeline
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(REPEATS)]
    model.train()
    for ev in events:
        ev[0].record()
        state.flat.zero_grad()
        x_tilde, z_e, z_q = model(x)
        total, _ = vqvae_loss(x_tilde, x, z_e, z_q, cfg.model.beta)
        ev[1].record()
        total.backward()
        ev[2].record()
        with torch.no_grad():
            if args.ema_codebook:
                state.flat.view("codebook", state.flat.grad).zero_()
                cb_old = model.codebook.detach().clone()
            fused_flat_update(state.opt_state, state.flat.flat, state.flat.grad,
                              state.ema_params, state.ema_decay, state.ema_warmup, state.step)
            state.step.add_(1)
            ev[3].record()
            if args.ema_codebook:
                _ema_codebook_step(state, cfg, cb_old, z_e.detach(), gen)
        ev[4].record()
    torch.cuda.synchronize()
    phase_ms = {
        name: float(np.median([ev[i].elapsed_time(ev[i + 1]) for ev in events]))
        for i, name in enumerate(("forward_and_loss", "backward", "optimizer", "ema_codebook"))
    }
    phase_ms["step"] = float(np.median([ev[0].elapsed_time(ev[4]) for ev in events]))

    enqueue = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, {"x": x}, gen)
        enqueue.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()

    def kernel_ms(fn, iters=50):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    flat_z = z_e.detach().reshape(-1, 256).contiguous()
    first_book = model.codebook.detach()
    first_book = first_book[0] if first_book.ndim == 3 else first_book
    scalars = torch.tensor([1.0, 1e-3, 0.5, 0.01, 0.9999], device=device)
    s = state.opt_state
    kernels = {
        "vq_nearest": kernel_ms(lambda: vq_kernel.nearest_codebook_indices(
            flat_z, first_book)),
        "fused_adam": kernel_ms(lambda: fused_adam.fused_adam_update(
            state.flat.grad, state.flat.flat, s.m, s.v, state.ema_params, scalars,
            b1=s.b1, b2=s.b2, eps=s.eps, clip=False, wd=0.0)),
    }
    print(json.dumps({
        "card": card, "bf16": args.bf16, "num_quantizers": args.num_quantizers,
        "ema_codebook": args.ema_codebook, "batch": list(x.shape), "params": state.flat.numel,
        "vq_rows": flat_z.shape[0], "device_ms_median": phase_ms,
        "host_enqueue_ms_median": float(np.median(enqueue)),
        "kernel_ms": kernels,
    }), flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(state, {"x": x}, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device kernels only: an aten op also reports its kernels' time
    device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "device_time_total", None) or e.cuda_time_total

    busy_ms = sum(dev_us(e) for e in device_events) / 1e3
    top = sorted(device_events, key=dev_us, reverse=True)[:12]
    print(json.dumps({
        "profile": f"{PROFILED_STEPS} train steps", "card": card, "bf16": args.bf16,
        "num_quantizers": args.num_quantizers, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in device_events) / PROFILED_STEPS,
        "top_device_ms_per_step": {e.key[:80]: dev_us(e) / 1e3 / PROFILED_STEPS for e in top},
        "top_counts": {e.key[:80]: e.count for e in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

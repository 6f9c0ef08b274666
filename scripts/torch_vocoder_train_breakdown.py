#!/usr/bin/env python3
"""Where the time of one vocoder training step goes in the PyTorch port, on a
CUDA card.

Builds the CLI's default vocoder (``cli.vocoder train``'s ``build_model``:
24 layers, 4 stacks, R = G = 512, S = 256, cin 80, a 10-mixture MoL head)
and its train state on the card, one batch of 2 crops of 7168 samples (28
mel frames: the presets' ``max_time_steps`` 8000 after the loader's crop)
with seeded targets in [-1, 1] and mels in [0, 1), TF32 off, and for the
float32 and the ``--bf16`` model in turn:

  * times the phases of a step with CUDA events (median of REPEATS steps
    after a warm-up): forward with the MoL loss, backward, the optimizer
    (global norm, per-step scalars and the fused kernel), the whole step;
  * times REPEATS unprofiled steps on the host's clock (the step time a
    user pays) and the host's enqueue of one step;
  * traces PROFILED_STEPS steps with ``torch.profiler``: device ms by
    kernel, launches a step, and the device's busy share of the unprofiled
    step time.

Run from the repository root: ``python3
scripts/torch_vocoder_train_breakdown.py [--dtypes f32,bf16]``. Prints the
card, then one JSON line per measurement; fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 20
PROFILED_STEPS = 5
BATCH, SAMPLES, HOP = 2, 7168, 256


def breakdown(torch, card: str, bf16: bool) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neural_sound_generation_tpu_torch.cli import vocoder
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.models import WaveNet
    from neural_sound_generation_tpu_torch.training.losses import discretized_mix_logistic_loss
    from neural_sound_generation_tpu_torch.training.train_state import (
        create_train_state,
        fused_flat_update,
    )
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    device = torch.device("cuda")
    cfg = Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=BATCH))
    model = vocoder.build_model(
        cfg, types.SimpleNamespace(residual_channels=None, layers=None, stacks=None, bf16=bf16),
        generator=torch.Generator().manual_seed(0)).to(device)
    state = create_train_state(model, cfg.train)
    gen = torch.Generator(device=device).manual_seed(0)
    t = torch.arange(SAMPLES, device=device)[None] / SAMPLES
    freq = 50 + 400 * torch.rand(BATCH, 1, generator=gen, device=device)
    y = (0.6 * torch.sin(2 * torch.pi * freq * t))[..., None]
    batch = {"y": y, "c": torch.rand(BATCH, SAMPLES // HOP, 80, generator=gen, device=device),
             "input_lengths": torch.full((BATCH,), SAMPLES, dtype=torch.int32, device=device)}
    step = make_train_step(model, cfg)
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()

    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(REPEATS)]
    model.train()
    for ev in events:
        ev[0].record()
        state.flat.zero_grad()
        y_hat = model(WaveNet.shift_inputs(batch["y"], True), batch["c"])
        loss = discretized_mix_logistic_loss(
            y_hat, batch["y"], cfg.audio.quantize_channels, cfg.arch.log_scale_min,
            batch["input_lengths"])
        ev[1].record()
        loss.backward()
        ev[2].record()
        with torch.no_grad():
            fused_flat_update(state.opt_state, state.flat.flat, state.flat.grad,
                              state.ema_params, state.ema_decay, state.ema_warmup, state.step)
            state.step.add_(1)
        ev[3].record()
    torch.cuda.synchronize()
    phase_ms = {name: float(np.median([ev[i].elapsed_time(ev[i + 1]) for ev in events]))
                for i, name in enumerate(("forward_and_loss", "backward", "optimizer"))}
    phase_ms["step"] = float(np.median([ev[0].elapsed_time(ev[3]) for ev in events]))

    enqueue = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        enqueue.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        step(state, batch)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / REPEATS
    print(json.dumps({
        "card": card, "bf16": bf16, "batch": [BATCH, SAMPLES], "params": state.flat.numel,
        "device_ms_median": phase_ms, "host_enqueue_ms_median": float(np.median(enqueue)),
        "step_ms": step_ms, "steps_per_s": 1e3 / step_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device kernels only: an aten op also reports its kernels' time
    device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "device_time_total", None) or e.cuda_time_total

    busy_ms = sum(dev_us(e) for e in device_events) / 1e3 / PROFILED_STEPS
    top = sorted(device_events, key=dev_us, reverse=True)[:15]
    print(json.dumps({
        "profile": f"{PROFILED_STEPS} train steps", "card": card, "bf16": bf16,
        "profiled_wall_ms_per_step": wall_ms / PROFILED_STEPS,
        "device_busy_ms_per_step": busy_ms, "device_busy_share_of_unprofiled_step":
        busy_ms / step_ms,
        "kernel_launches_per_step": sum(e.count for e in device_events) / PROFILED_STEPS,
        "top_device_ms_per_step": {e.key[:90]: dev_us(e) / 1e3 / PROFILED_STEPS for e in top},
        "top_counts_per_step": {e.key[:90]: e.count / PROFILED_STEPS for e in top},
    }), flush=True)
    del state, model, step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="where a vocoder train step's time goes")
    p.add_argument("--dtypes", default="f32,bf16")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from neural_sound_generation_tpu_torch.device import resolve_device

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    for name in args.dtypes.split(","):
        breakdown(torch, card, bf16=name == "bf16")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

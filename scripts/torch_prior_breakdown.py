#!/usr/bin/env python3
"""Where the time of one prior training step goes in the PyTorch port, on a CUDA card.

Builds the transformer prior the JAX package measured (dim 128, 4 layers
of 2 heads of 64, 512 codes, 10 classes) and its train state on the card,
float32 with TF32 off, a batch of 32 seeded random code grids at the CLI's
training grid (20 x 7) and at the flagship grid (20 x 28), and for each:

  * times the phases of a step with CUDA events (median of REPEATS steps
    after a warm-up): forward with the loss, backward, the optimizer
    (global norm, per-step scalars and the fused kernel), the whole step;
  * times the host's enqueue of one step (no synchronization): when it is
    as long as the device's step, the host bounds the step;
  * times the three attention kernels alone at the step's shape;
  * traces PROFILED_STEPS steps with ``torch.profiler`` and prints the
    kernels that take the most device time, the launches per step and the
    device's busy share of the steps' wall time.

Run from the repository root: ``python3 scripts/torch_prior_breakdown.py``.
Prints one JSON line per measurement; fails without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 20
PROFILED_STEPS = 10
BATCH, CODES, CLASSES = 32, 512, 10
DIM, LAYERS, HEADS = 128, 4, 2
GRIDS = [(20, 7), (20, 28)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import resolve_device
    from neural_sound_generation_tpu_torch.models import TransformerPrior
    from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
    from neural_sound_generation_tpu_torch.training.losses import prior_nll
    from neural_sound_generation_tpu_torch.training.train_state import (
        create_train_state,
        fused_flat_update,
    )
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    device = resolve_device("cuda")
    cfg = Config()
    gen = torch.Generator(device=device).manual_seed(0)

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

    def dev_us(e):
        return getattr(e, "device_time_total", None) or e.cuda_time_total

    for h, w in GRIDS:
        model = TransformerPrior(CODES, DIM, LAYERS, HEADS, CLASSES,
                                 generator=torch.Generator().manual_seed(0)).to(device)
        state = create_train_state(model, cfg.train)
        step = make_train_step(model, cfg)
        batch = {"codes": torch.randint(0, CODES, (BATCH, h, w), generator=gen, device=device,
                                        dtype=torch.int32),
                 "labels": torch.randint(0, CLASSES, (BATCH,), generator=gen, device=device,
                                         dtype=torch.int32)}
        for _ in range(5):
            step(state, batch)
        torch.cuda.synchronize()

        events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
                  for _ in range(REPEATS)]
        for ev in events:
            ev[0].record()
            state.flat.zero_grad()
            total, _ = prior_nll(model(batch["codes"], batch["labels"]), batch["codes"])
            ev[1].record()
            total.backward()
            ev[2].record()
            with torch.no_grad():
                fused_flat_update(state.opt_state, state.flat.flat, state.flat.grad,
                                  state.ema_params, state.ema_decay, state.ema_warmup,
                                  state.step)
                state.step.add_(1)
            ev[3].record()
        torch.cuda.synchronize()
        phase_ms = {
            name: float(np.median([ev[i].elapsed_time(ev[i + 1]) for ev in events]))
            for i, name in enumerate(("forward_and_loss", "backward", "optimizer"))
        }
        phase_ms["step"] = float(np.median([ev[0].elapsed_time(ev[3]) for ev in events]))

        enqueue = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            enqueue.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()

        bh, t, hd = BATCH * HEADS, h * w, DIM // HEADS
        q, k, v, do = (torch.randn(bh, t, hd, generator=gen, device=device) for _ in range(4))
        o, lse = fa.launch_fwd(q, k, v, hd**-0.5)
        dq, delta = fa.launch_bwd_dq(q, k, v, o, do, lse, hd**-0.5)
        kernels = {
            "flash_fwd": kernel_ms(lambda: fa.launch_fwd(q, k, v, hd**-0.5)),
            "flash_bwd_dq": kernel_ms(lambda: fa.launch_bwd_dq(q, k, v, o, do, lse, hd**-0.5)),
            "flash_bwd_dkdv": kernel_ms(
                lambda: fa.launch_bwd_dkdv(q, k, v, do, lse, delta, hd**-0.5)),
        }
        print(json.dumps({
            "card": card, "grid": [h, w], "batch": BATCH, "params": state.flat.numel,
            "attention_shape": [bh, t, hd], "device_ms_median": phase_ms,
            "host_enqueue_ms_median": float(np.median(enqueue)), "kernel_ms": kernels,
        }), flush=True)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(state, batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        # device kernels only: an aten op also reports its kernels' time
        device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(dev_us(e) for e in device_events) / 1e3
        top = sorted(device_events, key=dev_us, reverse=True)[:12]
        print(json.dumps({
            "profile": f"{PROFILED_STEPS} train steps", "grid": [h, w], "card": card,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "kernel_launches_per_step": sum(e.count for e in device_events) / PROFILED_STEPS,
            "top_device_ms_per_step": {e.key[:80]: dev_us(e) / 1e3 / PROFILED_STEPS for e in top},
            "top_counts": {e.key[:80]: e.count for e in top},
        }), flush=True)
        del model, state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

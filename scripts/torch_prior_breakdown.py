#!/usr/bin/env python3
"""Where the time of one prior training step goes in the PyTorch port, on a CUDA card.

Builds the transformer prior the JAX package measured (dim 128, 4 layers
of 2 heads of 64, 512 codes, 10 classes), or with ``--arch pixelcnn`` the
CLI's default GatedPixelCNN (dim 64, 15 layers), and its train state on
the card, float32 with TF32 off, a batch of 32 seeded random code grids at
the CLI's training grid (20 x 7) and at the flagship grid (20 x 28), and
for each:

  * times the phases of a step with CUDA events (median of REPEATS steps
    after a warm-up): forward with the loss, backward, the optimizer
    (global norm, per-step scalars and the fused kernel), the whole step;
  * times the host's enqueue of one step (no synchronization): when it is
    as long as the device's step, the host bounds the step;
  * times the three attention kernels alone at the step's shape (the
    transformer);
  * traces PROFILED_STEPS steps with ``torch.profiler`` and prints the
    kernels that take the most device time, the launches per step and the
    device's busy share of the steps' wall time.

For the PixelCNN it then traces its row-cached sampler (``fast_generate``)
over SAMPLER_ROWS rows of the served 20 x 21 grid at n = 1 and 4: wall
ms per sampled code, CUDA kernels per code, the busy share and the top
kernels.

``--moe-experts N`` routes the transformer's MLPs through N experts
(``models/moe.py``, capacity factor 1.25; the loss adds the load-balance
term). The traced steps then also split the routed MLP's device time:
forward routing (router, softmax, argmax, queue positions), the expert
products (two batched GEMMs and the gelu), and dispatch and combine (the
slot scatter, the gather times the gate, the load-balance term), each
labelled by wrapping ``SwitchMoE``'s methods in ``record_function``; the
backward by autograd node (``BmmBackward0`` and ``GeluBackward0`` are the
experts', the index and multiply nodes dispatch and combine, the softmax
the router's); attention by kernel name. Then the KV-cached sampler
(``generate``) is traced over the same rows at n = 1 and 4, with the
routed step's share.

``--bf16`` builds either family in bf16 (``cli.prior --bf16``: float32
parameters cast per call, the attention kernels on bf16 inputs); the
records carry the dtype.

Run from the repository root: ``python3 scripts/torch_prior_breakdown.py
[--arch transformer|pixelcnn] [--moe-experts N] [--bf16]``. Prints one JSON line
per measurement; fails without a CUDA device.
"""

from __future__ import annotations

import argparse
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
PIXELCNN_DIM, PIXELCNN_LAYERS = 64, 15
GRIDS = [(20, 7), (20, 28)]
SAMPLER_ROWS, SAMPLER_COLS = 2, 21


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--arch", choices=["transformer", "pixelcnn"], default="transformer")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="route the transformer's MLPs through this many experts")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    args = parser.parse_args(argv)
    arch, experts = args.arch, args.moe_experts if args.arch == "transformer" else 0
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import resolve_device
    from neural_sound_generation_tpu_torch.models import GatedPixelCNN, TransformerPrior
    from neural_sound_generation_tpu_torch.models.moe import SwitchMoE
    from neural_sound_generation_tpu_torch.models.pixelcnn import fast_generate
    from neural_sound_generation_tpu_torch.models.transformer_prior import generate
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
    dtype = torch.bfloat16 if args.bf16 else torch.float32

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
        return e.device_time_total

    def build():
        seed = torch.Generator().manual_seed(0)
        if arch == "pixelcnn":
            return GatedPixelCNN(CODES, PIXELCNN_DIM, PIXELCNN_LAYERS, CLASSES, dtype=dtype,
                                 generator=seed)
        return TransformerPrior(CODES, DIM, LAYERS, HEADS, CLASSES, n_experts=experts,
                                dtype=dtype, generator=seed)

    def loss(model, batch):
        if experts:
            logits, aux = model(batch["codes"], batch["labels"], return_moe_aux=True)
            return prior_nll(logits, batch["codes"], aux)[0]
        return prior_nll(model(batch["codes"], batch["labels"]), batch["codes"])[0]

    if experts:
        for name in ("forward", "dispatch", "_experts", "step"):
            setattr(SwitchMoE, name, labelled(torch, getattr(SwitchMoE, name), f"moe::{name}"))

    def top_kernels(prof, count: int) -> dict:
        """Device busy ms and the top kernels of a trace, per ``count``."""
        # device kernels only: an aten op also reports its kernels' time, and
        # a labelled range its span on the device's timeline
        device_events = [e for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and not e.key.startswith("moe::")]
        top = sorted(device_events, key=dev_us, reverse=True)[:12]
        return {"device_busy_ms": sum(dev_us(e) for e in device_events) / 1e3,
                "kernel_launches": sum(e.count for e in device_events) / count,
                "top_device_ms": {e.key[:80]: dev_us(e) / 1e3 / count for e in top},
                "top_counts": {e.key[:80]: e.count for e in top}}

    for h, w in GRIDS:
        model = build().to(device)
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
            total = loss(model, batch)
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

        record = {"card": card, "arch": arch, "experts": experts, "dtype": str(dtype),
                  "grid": [h, w], "batch": BATCH,
                  "params": state.flat.numel, "device_ms_median": phase_ms,
                  "host_enqueue_ms_median": float(np.median(enqueue))}
        if arch == "transformer":
            bh, t, hd = BATCH * HEADS, h * w, DIM // HEADS
            q, k, v, do = (torch.randn(bh, t, hd, generator=gen, device=device).to(dtype)
                           for _ in range(4))
            o, lse = fa.launch_fwd(q, k, v, hd**-0.5)
            dq, delta = fa.launch_bwd_dq(q, k, v, o, do, lse, hd**-0.5)
            record["attention_shape"] = [bh, t, hd]
            record["kernel_ms"] = {
                "flash_fwd": kernel_ms(lambda: fa.launch_fwd(q, k, v, hd**-0.5)),
                "flash_bwd_dq": kernel_ms(
                    lambda: fa.launch_bwd_dq(q, k, v, o, do, lse, hd**-0.5)),
                "flash_bwd_dkdv": kernel_ms(
                    lambda: fa.launch_bwd_dkdv(q, k, v, do, lse, delta, hd**-0.5)),
            }
        print(json.dumps(record), flush=True)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILED_STEPS):
                step(state, batch)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        trace = top_kernels(prof, PROFILED_STEPS)
        out = {
            "profile": f"{PROFILED_STEPS} train steps", "arch": arch, "experts": experts,
            "dtype": str(dtype), "grid": [h, w], "card": card, "wall_ms": wall_ms,
            "device_busy_ms": trace["device_busy_ms"],
            "device_busy_share": trace["device_busy_ms"] / wall_ms,
            "kernel_launches_per_step": trace["kernel_launches"],
            "top_device_ms_per_step": trace["top_device_ms"], "top_counts": trace["top_counts"],
        }
        if arch == "transformer":
            out["split_device_ms_per_step"] = split_step(prof, PROFILED_STEPS, dev_us)
        print(json.dumps(out), flush=True)
        del model, state, step
        torch.cuda.empty_cache()
    if arch == "transformer":
        model = build().to(device).eval()
        codes = SAMPLER_ROWS * SAMPLER_COLS
        for n in (1, 4):
            labels = torch.zeros(n, dtype=torch.int32, device=device)

            def sample():
                generate(model, labels, torch.Generator(device=device).manual_seed(0),
                         shape=(SAMPLER_ROWS, SAMPLER_COLS), batch_size=n)

            sample()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sample()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                sample()
                torch.cuda.synchronize()
            trace = top_kernels(prof, codes)
            step_ms = sum(dev_us(e) for e in prof.events()
                          if e.device_type == DeviceType.CPU and e.name == "moe::step")
            print(json.dumps({
                "profile": "generate", "experts": experts, "dtype": str(dtype),
                "grid": [SAMPLER_ROWS, SAMPLER_COLS],
                "n": n, "card": card, "wall_ms_per_code": wall_ms / codes,
                "device_busy_ms_per_code": trace["device_busy_ms"] / codes,
                "device_busy_share": trace["device_busy_ms"] / wall_ms,
                "kernel_launches_per_code": trace["kernel_launches"],
                "moe_step_device_ms_per_code": step_ms / 1e3 / codes,
                "top_device_ms_per_code": trace["top_device_ms"],
            }), flush=True)
    if arch == "pixelcnn":
        model = build().to(device).eval()
        codes = SAMPLER_ROWS * SAMPLER_COLS
        for n in (1, 4):
            labels = torch.zeros(n, dtype=torch.int32, device=device)

            def sample():
                fast_generate(model, labels, torch.Generator(device=device).manual_seed(0),
                              shape=(SAMPLER_ROWS, SAMPLER_COLS), batch_size=n)

            sample()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sample()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                sample()
                torch.cuda.synchronize()
            trace = top_kernels(prof, codes)
            print(json.dumps({
                "profile": "fast_generate", "dtype": str(dtype),
                "grid": [SAMPLER_ROWS, SAMPLER_COLS], "n": n,
                "card": card, "wall_ms_per_code": wall_ms / codes,
                "device_busy_ms_per_code": trace["device_busy_ms"] / codes,
                "device_busy_share": trace["device_busy_ms"] / wall_ms,
                "kernel_launches_per_code": trace["kernel_launches"],
                "top_device_ms_per_code": trace["top_device_ms"],
            }), flush=True)
    return 0


def labelled(torch, fn, name: str):
    """``fn`` run inside a profiler range called ``name``."""
    def run(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return run


#: backward autograd nodes and what of the step they belong to; the routed
#: MLP alone creates the batched products, the gelu (the dense MLP's gelu
#: is absent there), the index, index-copy, softmax and multiply nodes
BACKWARD_PARTS = {"BmmBackward0": "experts", "GeluBackward0": "experts",
                  "IndexBackward0": "dispatch_combine", "IndexCopyBackward0": "dispatch_combine",
                  "MulBackward0": "dispatch_combine", "SoftmaxBackward0": "route"}


def split_step(prof, steps: int, dev_us) -> dict:
    """Device ms per step by part: attention by kernel name (forward and
    both backward kernels), the routed MLP's forward from its labelled
    ranges (``moe::dispatch`` routes, ``moe::_experts`` runs the experts,
    the rest of ``moe::forward`` dispatches and combines), its backward by
    autograd node (BACKWARD_PARTS), and each backward node's total."""
    from torch.autograd import DeviceType

    ranges, nodes, attention = {}, {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if "flash_" in e.name:
                attention += dev_us(e)
        elif e.name.startswith("moe::"):
            ranges[e.name] = ranges.get(e.name, 0.0) + dev_us(e)
        elif e.name.startswith("autograd::engine::evaluate_function: "):
            node = e.name.split(": ", 1)[1]
            nodes[node] = nodes.get(node, 0.0) + dev_us(e)
    ms = lambda us: us / 1e3 / steps  # noqa: E731
    out = {"attention": ms(attention),
           "backward_by_node": {k: ms(v) for k, v in sorted(nodes.items(), key=lambda kv: -kv[1])}}
    if ranges:
        fwd = ranges.get("moe::forward", 0.0)
        route, experts = ranges.get("moe::dispatch", 0.0), ranges.get("moe::_experts", 0.0)
        back = {part: ms(sum(v for k, v in nodes.items() if BACKWARD_PARTS.get(k) == part))
                for part in ("route", "experts", "dispatch_combine")}
        out["moe_forward"] = {"route": ms(route), "experts": ms(experts),
                              "dispatch_combine": ms(fwd - route - experts), "total": ms(fwd)}
        out["moe_backward"] = back
    return out


if __name__ == "__main__":
    sys.exit(main())

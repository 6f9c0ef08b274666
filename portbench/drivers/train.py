"""Closed-loop training: the port's ``Trainer.train_epoch`` stepping as fast
as it can over a pool of seeded batches for the measured window.

Set-up builds one trainer (model, flat train state, fused optimizer with
its EMA shadow) with the benchmark's seeded weights, drives it through
``check_steps`` steps on distinct batches through the window's own call
(``train_epoch``) and feed (the Trainer's device prefetch of host batches),
keeps what the check compares (each step's loss, Adam's first moment after
step 1, the parameters and their EMA shadow after the last check step),
warms up, and hands the same trainer to the window. The window keeps each
step's loss; a step whose loss is not finite has failed. After the window
the program is freed and the plain reference repeats the check steps from
the same weights and batches.

``fault`` plants a fault in the program for the checks of the comparison
(``frozen``: the optimizer leaves the state unchanged; ``ema_frozen``: it
updates the parameters but leaves their EMA shadow as it was;
``half_batch``: the program is fed the first half of each check batch;
``window_nan``: the parameters turn NaN as the window opens, after every
check step); ``control`` replaces the program's readings by the
reference's own in the named lower precision. ``seconds`` 0 skips the
window.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench.harness import load_module, say
from portbench.probes import Probes
from portbench.reference.common import Precision, compare_training, make_weights, train_reference
from portbench.trace import device_trace


def _device_batch(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _flips(codes: torch.Tensor, ref_codes: torch.Tensor) -> int:
    """Rows whose code differs from the reference's; a row the program left
    out counts as differing."""
    a, b = codes.reshape(-1).long(), ref_codes.reshape(-1).long()
    n = min(len(a), len(b))
    return int((a[:n] != b[:n]).sum()) + abs(len(a) - len(b))


def _half(batch: dict) -> dict:
    return {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}


def run(cell, seed: int, seconds: float, trace: bool, device, clock, fault=None, control=None):
    from neural_sound_generation_tpu_torch.device import resolve_device
    from neural_sound_generation_tpu_torch.ops.cuda import build

    device = resolve_device(device)
    cuda = device.type == "cuda"
    config, traffic = cell.config, cell.traffic
    fam = load_module("families", config["family"])
    clock.part("imports")

    weights = make_weights(fam.param_table(config),
                           torch.Generator(device=device).manual_seed(seed), device)
    clock.part("weights")
    pool = fam.make_pool(config, int(traffic["pool_batches"]), seed)
    clock.part("inputs")
    trainer, state = fam.build_program(config, traffic, weights, device)
    clock.part("program")
    opt = config["optimizer"]
    if state.ema_params is None or state.ema_warmup or state.ema_decay != opt["ema_decay"]:
        raise ValueError(f"the program's EMA is not the configuration's: decay "
                         f"{opt['ema_decay']} from the first step")

    probes = Probes()
    probes.install_kernels()
    probes.span(trainer, "_train_step", "train_step",
                keep=lambda out: out[1]["loss"].detach().clone())
    if fault == "frozen":
        state.apply_gradients = lambda: torch.zeros((), device=device)
    elif fault == "ema_frozen":
        state.apply_gradients = _ema_left_as_it_was(state)
    elif fault not in (None, "half_batch", "window_nan"):
        raise ValueError(f"unknown fault {fault!r}")
    generator = torch.Generator(device=device).manual_seed(seed)

    probes.keep_indices = True
    n_check = int(traffic["check_steps"])
    losses, first_m = [], None
    for k in range(n_check):
        batch = _half(pool[k]) if fault == "half_batch" else pool[k]
        means = trainer.train_epoch([batch], generator, epoch=0)
        losses.append(means["loss"])
        if k == 0:
            first_m = {n: t.clone() for n, t in state.flat.named(state.opt_state.m).items()}
    after = {n: t.detach().clone() for n, t in state.flat.named(state.flat.flat).items()}
    ema = {n: t.detach().clone() for n, t in state.flat.named(state.ema_params).items()}
    clock.part("check_steps")
    built = sum(info["seconds"] for info in build.build_info.values())
    clock.parts["kernel_build"] = built
    clock.parts["check_steps"] -= built
    warm = int(traffic["warmup_steps"])
    trainer.train_epoch(pool[n_check:n_check + warm], generator, epoch=0)
    if cuda:
        torch.cuda.synchronize(device)
    clock.part("warmup")

    out = {"attempted": 0, "failed": 0, "e2e": {}, "readings": {}, "setup_parts": clock.parts}
    if fault == "window_nan":
        with torch.no_grad():
            state.flat.flat.fill_(float("nan"))
    if seconds > 0:
        out.update(_window(cell, fam, trainer, pool, generator, probes, seconds, trace, device,
                           clock))
    probes.uninstall()
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the program is freed before the reference runs on the same device
    del trainer, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    loss_fn = fam.reference_loss(config)
    batches = [_device_batch(pool[k], device) for k in range(n_check)]
    ref_losses, ref_grad, ref_after, ref_ema = train_reference(loss_fn, weights, batches, opt,
                                                               Precision("f32"))
    if control is not None:
        losses, grad, after, ema = train_reference(loss_fn, weights, batches, opt,
                                                   Precision(control))
    else:
        grad = {n: m / (1.0 - opt["b1"]) for n, m in first_m.items()}

    def change(x):
        return {n: x[n] - weights[n] for n in weights}

    numbers = compare_training(losses, grad, change(after), change(ema),
                               ref_losses, ref_grad, change(ref_after), change(ref_ema))
    numbers["program_losses"], numbers["reference_losses"] = losses, ref_losses
    if hasattr(fam, "reference_codes"):
        ref_codes = fam.reference_codes(weights, batches[0], Precision("f32"))
        codes = (fam.reference_codes(weights, batches[0], Precision(control))
                 if control is not None else probes.first_indices)
        if codes is not None:
            numbers["first_step_code_flips"] = _flips(codes, ref_codes)
    out["numbers"] = numbers
    out["reference_s"] = time.perf_counter() - t_ref
    return out


def _ema_left_as_it_was(state):
    """``state.apply_gradients`` with the EMA shadow put back as it was."""
    apply = state.apply_gradients

    def apply_gradients():
        before = state.ema_params.clone()
        gnorm = apply()
        state.ema_params.copy_(before)
        return gnorm

    return apply_gradients


def _window(cell, fam, trainer, pool, generator, probes, seconds, trace, device, clock):
    """The measured window: train steps over the pool until ``seconds`` have
    passed; the rate counts every step and all the time to the last one's
    end on the device."""
    cuda = device.type == "cuda"

    def feed(deadline):
        i = 0
        while time.perf_counter() < deadline:
            yield pool[i % len(pool)]
            i += 1

    probes.clear()
    probes.recording = True
    with device_trace(trace) as box:
        t_start = time.perf_counter()
        setup_s = clock.setup_s(t_start)
        means = trainer.train_epoch(feed(t_start + seconds), generator, epoch=1)
        if cuda:
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
    probes.recording = False
    window = t_end - t_start
    steps = len(probes.spans.get("train_step", []))
    loss = means.get("loss", float("nan"))
    kept = probes.kept.get("train_step", [])
    failed = int((~torch.isfinite(torch.stack(kept))).sum()) if kept else 0
    if not math.isfinite(loss):
        failed = max(failed, 1)
    host = sorted(probes.spans.get("train_step", [0.0]))
    say(f"window: {steps} steps in {window:.3f} s, mean loss {loss:.6f}, {failed} failed, "
        f"host ms a step p10 {1e3 * host[len(host) // 10]:.2f} p50 {1e3 * host[len(host) // 2]:.2f} "
        f"p90 {1e3 * host[9 * len(host) // 10]:.2f}")
    readings = {
        "kind": "train", "steps": steps, "window_s": window,
        "step_host_s": probes.spans.get("train_step", []),
        "vq_calls": list(probes.vq_calls), "adam_calls": list(probes.adam_calls),
        "step_flops": fam.step_flops(cell.config), "precision": cell.traffic["precision"],
        "timeline": box[0] if box else None,
    }
    return {
        "attempted": steps, "failed": failed,
        "e2e": {"setup_s": setup_s,
                "train_audio_rate": steps * fam.audio_seconds_per_step(cell.config) / window},
        "readings": readings,
    }

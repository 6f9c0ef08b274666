#!/usr/bin/env python3
"""The training step's own spans on a CUDA card, in a benchmark cell's
program: what the tracer reads there and what it costs.

For each seed, builds the program of a training cell of ``BENCHMARK.json``
as ``portbench`` builds it (the cell's configuration and traffic, the
seeded weights and pool, the check and warm-up steps through
``Trainer.train_epoch``), then runs three closed-loop windows of
``--seconds`` over the pool, as the benchmark's window does:

  * ``off`` and ``on``: the tracer of ``utils/profiling`` off and on, no
    profiler (their order alternates from seed to seed); each gives
    ``train_audio_rate``, so the pairs give the tracer's cost;
  * ``traced``: the tracer on inside ``portbench``'s device-only trace,
    read by ``portbench/spans.py``: the forward, backward and optimizer
    device milliseconds a step, the feed's host milliseconds a step, the
    loop's idle share, the card's idle milliseconds put down to the
    innermost host span, and the shared clock's check (the k-th
    ``fused_adam`` operation starts after the k-th ``train.optimizer``
    span began, and each batch's copy after the ``train.feed`` span that
    enqueued it), the longest idle gaps with the host's place at each;
    beside them the benchmark's own ``device_ms_per_step`` and
    ``device_idle_pct`` of the same window, and whether the feed's
    host-to-device copies ran beside any kernel.

Run from the repository root:
``python3 scripts/torch_train_spans.py --workload vqvae_mel.train_f32
--seeds 11 12 --seconds 10 [--out spans.jsonl]``. Prints one
JSON line a seed (and appends it to ``--out``); fails without a CUDA
device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import spans as S  # noqa: E402
from portbench.harness import Cell, load_module, set_cache_dirs  # noqa: E402


def _feed(pool, deadline, fed):
    i = 0
    while time.perf_counter() < deadline:
        yield pool[i % len(pool)]
        i += 1
        fed[0] = i


def _window(trainer, pool, generator, seconds, tracer, traced, device):
    import torch

    from neural_sound_generation_tpu_torch.utils import profiling
    from portbench.trace import device_trace

    fed = [0]
    drained = None
    with device_trace(traced) as box:
        if tracer:
            profiling.enable(device)
        t_start = time.perf_counter()
        means = trainer.train_epoch(_feed(pool, t_start + seconds, fed), generator, epoch=1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_end = time.perf_counter()
        if tracer:
            profiling.disable()
    if tracer:
        drained = profiling.drain()
    return {"steps": fed[0], "window_s": t_end - t_start, "loss": means.get("loss"),
            "timeline": box[0] if box else None, "drained": drained}


def _copies_beside_kernels(timeline) -> dict:
    """Host-to-device copies, and how many of them ran while a kernel ran."""
    kernels = [(s, e) for name, s, e in timeline.ops if "Memcpy" not in name
               and "Memset" not in name]
    copies = [(s, e) for name, s, e in timeline.ops if "Memcpy HtoD" in name
              or "Memcpy_HtoD" in name]
    beside, j = 0, 0
    for s, e in copies:
        while j < len(kernels) and kernels[j][1] <= s:
            j += 1
        beside += any(ks < e and ke > s for ks, ke in kernels[j:j + 64])
    return {"copies": len(copies), "beside_a_kernel": beside}


def _gaps(r: dict, top: int = 10) -> list:
    """The window's longest idle gaps on the card: the operations either
    side, the innermost host span open as each gap begins and ends, and how
    many steps the host had begun beyond the card's (the ``fused_adam``
    operations run so far): a host ahead of the card did not cause the gap."""
    tl, lo_ns = r["timeline"], r["span_window_ns"][0]
    lo, hi = lo_ns * 1e-9, r["span_window_ns"][1] * 1e-9
    pieces = S.innermost_pieces(S.named(r), lo, hi)
    steps = sorted(s[1] * 1e-9 for s in S.named(r, S.STEP))
    adams = [s for name, s, _ in tl.ops if "fused_adam" in name]

    def host_at(t):
        return next((p[2] for p in pieces if p[0] <= t < p[1]), S.NONE)

    gaps, end, prev = [], None, None
    for name, s, e in tl.ops:
        if end is not None and s > end:
            gaps.append((s - end, end, s, prev, name))
        if end is None or e > end:
            end, prev = e, name
    out = []
    for sec, a, b, before, after in sorted(gaps, reverse=True)[:top]:
        lead = sum(t <= a for t in steps) - sum(t <= a for t in adams)
        out.append({"ms": 1e3 * sec, "at_ms": 1e3 * (a - lo), "before": before[:48],
                    "after": after[:48], "host_at_start": host_at(a), "host_at_end": host_at(b),
                    "host_steps_ahead": lead})
    return out


def _feed_copy_causality(r: dict, copies_per_batch: int) -> dict:
    """The shared clock checked where the card waits: each host-to-device
    copy against the ``train.feed`` span that enqueued it (the prefetch puts
    two batches in the first fetch, then one a fetch), the margin being the
    copy's start less the span's start. After a pull has drained the queue
    the copy starts as soon as it is enqueued, so the smallest margin is the
    clocks' disagreement bound."""
    feeds = S.named(r, "train.feed")
    copies = sorted(s for name, s, _ in r["timeline"].ops if "Memcpy HtoD" in name)
    margins = []
    for c, start in enumerate(copies):
        k = max(0, c // copies_per_batch - 1)
        if k < len(feeds):
            margins.append(1e3 * (start - feeds[k][1] * 1e-9))
    if not margins:
        return {}
    return {"pairs": len(margins), "smallest_margin_ms": min(margins),
            "violations": sum(m < 0 for m in margins),
            "margins_under_1ms": sum(0 <= m < 1 for m in margins)}


def run_seed(cell, seed: int, seconds: float, order: tuple, device) -> dict:
    import torch

    from neural_sound_generation_tpu_torch.device import resolve_device
    from portbench.reference.common import make_weights
    from portbench.trace import Timeline

    device = resolve_device(device)  # float32 with TF32 off, as the benchmark runs
    config, traffic = cell.config, cell.traffic
    fam = load_module("families", config["family"])
    weights = make_weights(fam.param_table(config),
                           torch.Generator(device=device).manual_seed(seed), device)
    pool = fam.make_pool(config, int(traffic["pool_batches"]), seed)
    trainer, state = fam.build_program(config, traffic, weights, device)
    generator = torch.Generator(device=device).manual_seed(seed)
    n_check, warm = int(traffic["check_steps"]), int(traffic["warmup_steps"])
    for k in range(n_check):
        trainer.train_epoch([pool[k]], generator, epoch=0)
    trainer.train_epoch(pool[n_check:n_check + warm], generator, epoch=0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    audio = fam.audio_seconds_per_step(config)
    out = {"cell": cell.name, "seed": seed, "order": list(order),
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    for kind in order:
        w = _window(trainer, pool, generator, seconds, kind == "on", False, device)
        out[f"rate_{kind}"] = w["steps"] * audio / w["window_s"]
        out[f"steps_{kind}"] = w["steps"]

    w = _window(trainer, pool, generator, seconds, True, True, device)
    tl = w["timeline"]
    annotations = [o for o in tl.ops if o[0].startswith("train.")]
    if annotations:  # the profiler's device-side copies of the spans' ranges
        tl = Timeline([o for o in tl.ops if not o[0].startswith("train.")])
    r = {"kind": "train", "steps": w["steps"], "window_s": w["window_s"], "timeline": tl,
         "spans": [tuple(s) for s in w["drained"]["spans"]],
         "span_window_ns": w["drained"]["window_ns"]}
    phases = {name: S.phase_ms_per_step(r, name) for name in S.PHASES}
    device_ms = 1e3 * tl.kernel_seconds() / w["steps"]
    out.update({
        "rate_traced": w["steps"] * audio / w["window_s"], "steps_traced": w["steps"],
        "loss_traced": w["loss"],
        "device_annotation_ops": len(annotations),
        "forward_ms_per_step": phases["train.forward"],
        "backward_ms_per_step": phases["train.backward"],
        "optimizer_ms_per_step": phases["train.optimizer"],
        "phases_sum_ms": sum(phases.values()) if None not in phases.values() else None,
        "step_span_device_ms": S.phase_ms_per_step(r, S.STEP),
        "device_ms_per_step": device_ms,
        "device_idle_pct": 100.0 * (1.0 - tl.busy_s() / w["window_s"]),
        "feed_ms_per_step": S.feed_ms_per_step(r),
        "loop_idle_pct": S.loop_idle_pct(r),
        "span_counts": {n: len(S.named(r, n)) for n in
                        (S.STEP, *S.PHASES, "train.feed", "train.pull")},
        "idle_ms_by_span": S.idle_ms_by_span(r),
        "causality": S.optimizer_causality(r),
        "copies": _copies_beside_kernels(tl),
        "feed_causality": _feed_copy_causality(r, len(pool[0])),
        "gaps": _gaps(r),
        "pull_host_ms": [1e-6 * (s[2] - s[1]) for s in S.named(r, "train.pull")][:20],
    })
    if out["phases_sum_ms"]:
        out["phases_over_device_ms"] = out["phases_sum_ms"] / device_ms
    del trainer, state, w, r, tl
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the training step's spans in a benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    cell = Cell(args.workload)
    rows = []
    for i, seed in enumerate(args.seeds):
        order = ("off", "on") if i % 2 == 0 else ("on", "off")
        row = run_seed(cell, seed, args.seconds, order, torch.device("cuda"))
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        idle = row["idle_ms_by_span"] or {}
        print(f"{cell.name} seed {seed}: idle ms in the window by innermost span: "
              + ", ".join(f"{k} {v:.3f}" for k, v in idle.items()), file=sys.stderr, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a", encoding="utf-8") as f:
                f.write(line + "\n")
    cost = [r["rate_on"] / r["rate_off"] - 1.0 for r in rows]
    print(json.dumps({"cell": cell.name, "tracer_cost_median": statistics.median(cost),
                      "tracer_cost": cost,
                      "rate_off_median": statistics.median(r["rate_off"] for r in rows),
                      "rate_on_median": statistics.median(r["rate_on"] for r in rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

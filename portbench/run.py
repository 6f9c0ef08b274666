#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a device trace of the
same window. Set-up's parts, the window's summary and, last, each number
that decides ``correct`` beside its limit go to standard error; the last
line of standard output is one JSON object. Exits 2 without printing a
result when the card is missing, when the cell asks for more cards than
there are, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import (  # noqa: E402
    Cell, Clock, finite, forbidden_modules, load_module, set_cache_dirs, say)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="run one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_info(device, count: int, memory_peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(memory_peak)}


def metric_values(cell: Cell, out: dict, trace: bool) -> dict:
    """The cell's end-to-end metrics (``trace`` 0) or per-layer metrics
    (``trace`` 1) as the result line names them. A per-layer reader that
    finds nothing returns None and its metric is left out."""
    metrics = {}
    if not trace:
        for m in cell.end_to_end():
            value = out["e2e"].get(m["name"])
            if not finite(value):
                raise RuntimeError(f"end-to-end metric {m['name']} was not measured")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        return metrics
    for m in cell.per_layer():
        value = load_module("metrics", m["name"]).read(out["readings"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def judge(cell: Cell, out: dict) -> tuple[bool, dict]:
    """Each number that the cell's limits file names against its limit, and
    the window's failed steps against none; ``correct`` when every one is
    finite and within its limit."""
    checks = {name: {"value": out["numbers"].get(name), "limit": limit}
              for name, limit in cell.limits.items()}
    checks["window_failed"] = {"value": out["failed"], "limit": 0}
    ok = bool(cell.limits) and all(
        finite(c["value"]) and finite(c["limit"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks


def main(argv=None) -> int:
    clock = Clock()
    args = parse_args(argv)
    set_cache_dirs()
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"FAIL: {cell.name} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    driver = load_module("drivers", cell.traffic["driver"])
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", clock)
    loaded = forbidden_modules()
    if loaded:
        say(f"FAIL: the run loaded {', '.join(loaded)}")
        return 2
    for part, sec in out["setup_parts"].items():
        say(f"setup {part}: {sec:.3f} s")
    metrics = metric_values(cell, out, bool(args.trace))
    correct, checks = judge(cell, out)
    device = device_info("cuda", cell.chips, out["memory_peak_bytes"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    timeline = out["readings"].get("timeline")
    if args.trace and timeline is not None:
        from portbench.trace import breakdown

        device["busy_s"] = timeline.busy_s()
        device["window_s"] = out["readings"]["window_s"]
        result["breakdown"] = breakdown(timeline)
    say(f"reference: {out['reference_s']:.3f} s; numbers: "
        + json.dumps({k: v for k, v in out["numbers"].items() if k not in checks}))
    for name, c in checks.items():
        say(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

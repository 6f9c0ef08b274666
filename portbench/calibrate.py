#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--fault half_batch --fault frozen --fault-seeds ...]

In one process, for each seed: the program's numbers (the cell's set-up and
check steps, a window only where ``--seconds`` asks for one, then the
reference), the control's (the reference
in the traffic's lower precision in the program's place) and each planted
fault's. Prints one JSON line a reading and, last, the largest program
reading and the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import Cell, Clock, load_module, set_cache_dirs  # noqa: E402


def readings(cell: Cell, seed: int, seconds: float, device, fault=None, control=None) -> dict:
    """Every number the cell's driver (``drivers/``) compares, and what it
    says beside them."""
    driver = load_module("drivers", cell.traffic["driver"])
    out = driver.run(cell, seed, seconds, False, device, Clock(), fault=fault, control=control)
    numbers = {k: v for k, v in out["numbers"].items() if isinstance(v, float)}
    return numbers | {"detail": {k: v for k, v in out["numbers"].items() if k not in numbers}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="the window (0: none)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    set_cache_dirs()
    cell = Cell(args.workload)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    summary = {}
    runs = ([("program", s, None, None) for s in seeds(args.seeds)]
            + [("control", s, None, cell.traffic["control"]) for s in seeds(args.control_seeds)]
            + [(f"fault:{f}", s, f, None) for f in args.fault for s in seeds(args.fault_seeds)])
    for kind, seed, fault, control in runs:
        r = readings(cell, seed, args.seconds, args.device, fault, control)
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed, **r}), flush=True)
        for name, value in r.items():
            if name == "detail":
                continue
            pick = max if kind == "program" else min
            key = f"{kind}.{name}"
            summary[key] = value if key not in summary else pick(summary[key], value)
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

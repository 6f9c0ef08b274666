"""The harness's plumbing: the cell's files found by name, the set-up clock,
the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration's file (``configs/<name>.json``) names the family adapter
(``families/<family>.py``) that builds the port's program and the plain
reference; the traffic file (``traffic/<name>.json``) names the driver
(``drivers/<driver>.py``) that offers the load; ``limits/<cell>.json``
holds the limits of the numbers that decide ``correct``; each per-layer
metric is read by ``metrics/<metric>.py``. Adding a cell or a metric adds
files and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no run may load: JAX and the JAX package
#: (whose name the port's begins with, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "neural_sound_generation_tpu")


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's own records."""
    with open("/proc/self/stat", encoding="ascii") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime", encoding="ascii") as f:
        uptime = float(f.read().split()[0])
    return max(0.0, uptime - started)


def set_cache_dirs() -> None:
    """Every compiler cache a run may fill, in a fixed directory inside the
    checkout (so that only a cell's first run in a checkout builds). Set
    before torch is imported."""
    base = ROOT / "build" / "portbench-cache"
    for key, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(key, str(base / sub))


class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, name: str, spec: dict | None = None, workload: dict | None = None):
        """The workload ``name`` of ``BENCHMARK.json``, or the given
        ``workload`` entry (a cell that the file does not list yet)."""
        spec = spec if spec is not None else read_json(ROOT / "BENCHMARK.json")
        found = [workload] if workload else [w for w in spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.spec, self.workload = spec, found[0]
        self.name = name
        self.config = read_json(HERE / "configs" / f"{self.workload['config']}.json")
        self.traffic = read_json(HERE / "traffic" / f"{self.workload['traffic']}.json")
        limits_path = HERE / "limits" / f"{name}.json"
        self.limits = read_json(limits_path)["limits"] if limits_path.is_file() else {}
        self.chips = int(self.workload["chips"])

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


class Clock:
    """The set-up clock: process start to the first timed step, in parts."""

    def __init__(self):
        self.age0 = process_age_s()
        self.t0 = time.perf_counter()
        self.last = self.t0
        self.parts: dict[str, float] = {}

    def part(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + now - self.last
        self.last = now

    def setup_s(self, window_start: float) -> float:
        return self.age0 + (window_start - self.t0)


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)

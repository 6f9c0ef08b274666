"""Builds the port's CUDA sources into shared libraries and loads them.

Each source under ``neural_sound_generation_tpu_torch/csrc/`` has a plain C
interface. It is compiled at first use by ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``) and loaded with ``ctypes``. The library's file name carries a
digest of its sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parents[3]
CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# one lock per library name: two libraries build concurrently, a second
# load of the same one waits for the first
_locks_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
#: name -> {"seconds": build time (0.0 when the library was already built),
#: "log": nvcc's output, including ptxas' register and shared-memory report}
build_info: dict[str, dict] = {}


def find_nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str, sources: list[Path], rebuild: bool = False) -> ctypes.CDLL:
    """Build (once per source digest) and load ``lib<name>.so``.

    ``rebuild`` compiles even when a library of the same sources is already
    on disk (the first load in a process only). Raises when CUDA is
    unavailable or the build fails: there is no fallback to a plain
    version here. Different libraries may be loaded from several threads
    at once; their ``nvcc`` runs overlap.
    """
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"CUDA kernel {name!r} needs a CUDA device and none is available"
            )
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            digest.update(Path(src).read_bytes())
        path = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        seconds, log = 0.0, ""
        if rebuild or not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name!r}:\n{log}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
        build_info[name] = {"seconds": seconds, "log": log, "path": str(path)}
        return lib

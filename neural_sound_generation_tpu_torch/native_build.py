"""g++ builds of the port's native C++ runtimes: ``motion/native/motion.cpp``
(``motion.capture``) and ``data/native/loader.cpp`` (``data.native_loader``).

A library is compiled at first use by the ``g++`` on ``PATH`` with the flags
of the runtimes' Makefiles into ``build/native/`` at the root of the checkout
(listed in ``.gitignore``). ``$CXX`` is not read: a compiler that links
libstdc++ statically puts a second copy of it beside the one torch has
loaded, and a library's file streams then crash the process. The file name
carries a digest of the compiler, the flags and the source, so an edited
source is rebuilt and a stale library is never loaded; it is written aside
and renamed into place, so a concurrent process never loads a half-written
file. Nothing is built when a module is imported.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
# the Makefiles' CXXFLAGS, and -shared from their link lines
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")


def find_gxx(what: str) -> str:
    """The ``g++`` on ``PATH``; ``what`` names the runtime in the error."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {what} is built with it")
    return gxx


def library_path(source: Path, stem: str, link: tuple = (), what: str = "") -> Path:
    """Where the library ``stem`` of ``source``, the compiler and the flags
    lives."""
    digest = hashlib.sha256(" ".join((find_gxx(what or stem), *CXX_FLAGS, *link)).encode())
    digest.update(source.read_bytes())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path, path: Path, link: tuple = (), what: str = "") -> None:
    """Compile ``source`` into ``path``, written aside and renamed into
    place."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_gxx(what or path.name), *CXX_FLAGS, "-o", str(tmp), str(source), *link]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)

#!/usr/bin/env python3
"""Builds and checks the causal-attention kernels (``csrc/flash_attention.cu``)
on one CUDA card, alone, and compares variants of the source.

For each variant (the source itself, ``base``, and any variant made by text
replacement from a JSON file ``{"tag": [[old, new], ...], ...}``), in
parallel: an ``nvcc`` build whose mbarrier waits trap after about 2^28 spins
(so that a hung kernel ends the run), then ptxas' register and spill report
and ``cuobjdump -sass``'s HGMMA count per kernel. Then, for each shape, in a
process of its own (a fault does not poison the next shape): each kernel's
``launch_plan``, ``chip_smoke.compare_attention`` (the kernels against the
plain pair, twice for determinism, times back to back and device-only,
SDPA's) and one ``ROW`` line of JSON. The base runs every shape of
``chip_smoke.ATTN_SHAPES`` and ``EXTRA_SHAPES``; variants run ``--variant-shapes``.

Run from the root of the repository::

    python3 scripts/torch_attention_check.py [--variants variants.json]
        [--shapes a,b] [--variant-shapes a,b] [--log path]

Everything printed also goes to ``--log``. A variant's numbers that break the
kernel's arithmetic on purpose (to time a part of it) are marked BAD.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "neural_sound_generation_tpu_torch", "csrc", "flash_attention.cu")
WORK = os.path.join(ROOT, "build", "attention_check")
# beyond chip_smoke.ATTN_SHAPES: small grids, D past 64 and 32 (f32 and
# bf16, rows TMA cannot stage), and bf16 at D = 128
EXTRA_SHAPES = [("tiny_T37_D32", 4, 37, 32, False), ("tiny_T70_bf16", 4, 70, 64, True),
                ("odd_D65", 8, 200, 65, False), ("odd_D33_bf16", 8, 130, 33, True),
                ("D128_bf16", 8, 300, 128, True)]
SHAPE_SECONDS = 150
WATCHDOG_SECONDS = 800


def all_shapes():
    import chip_smoke

    return list(chip_smoke.ATTN_SHAPES) + EXTRA_SHAPES


def watchdog(seconds: int) -> None:
    def run():
        time.sleep(seconds)
        print(f"WATCHDOG after {seconds}s", flush=True)
        os._exit(3)

    threading.Thread(target=run, daemon=True).start()


def variant_source(tag: str, replace: list) -> str:
    """The source with bounded mbarrier waits and the variant's replacements."""
    src = open(SOURCE).read()
    out = src.replace("  uint32_t done = 0;\n  do {", "  uint32_t done = 0, spins = 0;\n  do {")
    out = out.replace("  } while (!done);\n}",
                      "    if (!done && ++spins > (1u << 28)) __trap();\n  } while (!done);\n}")
    if out == src:
        raise SystemExit("the mbarrier wait loop was not found")
    for old, new in replace:
        if old not in out:
            raise SystemExit(f"variant {tag}: {old!r} not in the source")
        out = out.replace(old, new)
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, f"fa_{tag}.cu")
    with open(path, "w") as f:
        f.write(out)
    return path


def hgmma_counts(so: str) -> dict:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = re.sub(r"^.*?(flash_\w+?_kernelI\w+?Li\d+E).*$", r"\1", m.group(1))
            counts[fn] = 0
        elif fn and "HGMMA" in line:
            counts[fn] += 1
    return counts


def child(tag: str, shape_name: str) -> None:
    """One shape against one variant's library (already built)."""
    watchdog(SHAPE_SECONDS)
    import torch

    import chip_smoke
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops.cuda import build
    from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa

    set_full_float32()
    lib = build.load_library(f"fa_{tag}", [os.path.join(WORK, f"fa_{tag}.cu")], False)
    build._libs["flash_attention"] = lib
    fa._lib = None
    fa.load()
    shape = next(s for s in all_shapes() if s[0] == shape_name)
    name, bh, t, d, bf16 = shape
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    row = chip_smoke.compare_attention(torch, fa, shape, gen)
    limit = chip_smoke.ATTN_BF16_REL if bf16 else chip_smoke.ATTN_F32_REL
    ok = max(row["rel_err"].values()) <= limit and row["run_to_run_identical"]
    print("ROW", json.dumps({"variant": tag, **row}), flush=True)
    print("OK" if ok else "BAD", tag, name, flush=True)
    os._exit(0)


class Tee:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.file = open(path, "w")
        self.out = sys.stdout

    def write(self, text: str) -> None:
        self.file.write(text)
        self.file.flush()
        self.out.write(text)

    def flush(self) -> None:
        self.out.flush()


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "child":
        child(sys.argv[2], sys.argv[3])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", help="JSON file of text-replacement variants")
    ap.add_argument("--shapes", help="comma-separated shape names for the base")
    ap.add_argument("--variant-shapes", default="train_T140,flagship_T560,flagship_T560_bf16")
    ap.add_argument("--log", default=os.path.join(WORK, "log.txt"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke
    from neural_sound_generation_tpu_torch.ops.cuda import build

    sys.stdout = Tee(args.log)
    watchdog(WATCHDOG_SECONDS)
    print(chip_smoke.card_line(), flush=True)
    variants = {"base": []}
    if args.variants:
        with open(args.variants) as f:
            variants.update(json.load(f))
    paths = {tag: variant_source(tag, rep) for tag, rep in variants.items()}
    errors: dict = {}

    def build_one(tag):
        try:
            build.load_library(f"fa_{tag}", [paths[tag]], True)
        except (RuntimeError, OSError) as e:
            errors[tag] = str(e)

    threads = [threading.Thread(target=build_one, args=(tag,)) for tag in paths]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for tag in paths:
        if tag in errors:
            print("BUILD FAILED", tag, errors[tag][-6000:], flush=True)
            continue
        info = build.build_info[f"fa_{tag}"]
        print("BUILD", tag, f"{info['seconds']:.1f}s", flush=True)
        for line in info["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill", "C75")):
                print("  ", line.strip(), flush=True)
        print("HGMMA", tag, json.dumps(hgmma_counts(info["path"])), flush=True)
    base_shapes = (args.shapes.split(",") if args.shapes else [s[0] for s in all_shapes()])
    for tag in paths:
        if tag in errors:
            continue
        for name in base_shapes if tag == "base" else args.variant_shapes.split(","):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "child", tag, name],
                                  capture_output=True, text=True, timeout=SHAPE_SECONDS + 30)
            print(f"[{tag} {name} rc={proc.returncode} {time.perf_counter() - t0:.1f}s]",
                  flush=True)
            for line in proc.stdout.splitlines():
                if line.split(" ")[0] in ("ROW", "OK", "BAD", "WATCHDOG"):
                    print(line, flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

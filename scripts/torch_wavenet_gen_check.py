#!/usr/bin/env python3
"""Builds and checks the whole-loop WaveNet kernel (``csrc/wavenet_gen.cu``,
kernel 5) on one CUDA card, alone, and times variants of it for attribution.

Variants, each built by ``nvcc`` in parallel with mbarrier waits that trap
after about 2^28 spins (so that a hung kernel ends the run):

* ``base``: the source itself;
* ``exchange_only``: the products skipped (kProducts = false): the
  cluster's exchanges, gate, ring and head alone, the chain's own floor
  (timing only, its numbers are marked BAD by design);
* ``no_helpers``: the taps and condz computed by the chain warp itself
  (kHelpers = false), the off-chain role disabled;
* ``one_block``: the kernel's first design, one 512-thread block, when its
  source has been put at ``build/wavenet_gen_one_block.cu`` (``git show
  ebae962:neural_sound_generation_tpu_torch/csrc/wavenet_gen.cu >
  build/wavenet_gen_one_block.cu``), timed through its own C interface
  (timing only: it sums in another order);
* any variant made by text replacement from a JSON file ``{"tag": [[old,
  new], ...]}`` (``--variants``).

Then, for each variant and shape (``chip_smoke.WN_SHAPES`` and the API
path's ``api_T22050``), in a process of its own (a fault does not poison the
next): ``chip_smoke.compare_wavenet`` and its limits (``check_wavenet_row``)
for the variants that keep the arithmetic, device-only times (behind
``torch.cuda._sleep``) of both template variants for all, and one ``ROW``
line of JSON with the launch plan. Run from the root of the repository::

    python3 scripts/torch_wavenet_gen_check.py [--variants v.json]
        [--tags base,exchange_only] [--shapes production_T4096,tests_T64]
        [--log log.txt]

Everything printed also goes to ``--log``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "neural_sound_generation_tpu_torch", "csrc", "wavenet_gen.cu")
WORK = os.path.join(ROOT, "build", "wavenet_gen_check")
ONE_BLOCK_SOURCE = os.path.join(ROOT, "build", "wavenet_gen_one_block.cu")
BUILTIN = {
    "exchange_only": [["constexpr bool kProducts = true;", "constexpr bool kProducts = false;"]],
    "no_helpers": [["constexpr bool kHelpers = true;", "constexpr bool kHelpers = false;"]],
}


def timing_only(tag: str) -> bool:
    """Variants that skip products or sum in another order: times only."""
    return tag == "one_block" or "exchange_only" in tag


API_SHAPE = "api_T22050"
SHAPE_SECONDS = 300
WATCHDOG_SECONDS = 1500


def shapes() -> list:
    import chip_smoke

    return list(chip_smoke.WN_SHAPES) + [(API_SHAPE, chip_smoke.WN_PROD,
                                          chip_smoke.WN_API_SAMPLES)]


def watchdog(seconds: int) -> None:
    def run():
        time.sleep(seconds)
        print(f"WATCHDOG after {seconds}s", flush=True)
        os._exit(3)

    threading.Thread(target=run, daemon=True).start()


def variant_source(tag: str, replace: list) -> str:
    """The source with bounded mbarrier waits and the variant's replacements."""
    src = open(ONE_BLOCK_SOURCE if tag == "one_block" else SOURCE).read()
    out = src
    if tag != "one_block":
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
    path = os.path.join(WORK, f"wn_{tag}.cu")
    with open(path, "w") as f:
        f.write(out)
    return path


def one_block_launcher(lib, torch, wavenet_gen, packed, c_up, gum, unif, x_in, t, teacher: bool):
    """A call of the first design through its C interface: one 512-thread block,
    the ring (L, RD, R) bf16, dynamic shared memory by its own formula."""
    d = packed.dims
    lib.wavenet_gen_launch.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    lib.wavenet_gen_smem_bytes.argtypes = [ctypes.c_int] * 9
    smem = lib.wavenet_gen_smem_bytes(d["L"], d["K"], d["R"], d["G"], d["S"], d["C"], d["OUTP"],
                                      512, 8)
    dil = torch.tensor(packed.dilations, dtype=torch.int32, device="cuda")
    c_bf = c_up[:t].to(torch.bfloat16).contiguous()

    def call():
        ring = torch.zeros(d["L"], d["RD"], d["R"], dtype=torch.bfloat16, device="cuda")
        out = torch.empty(t * (d["OUT"] if teacher else 1), device="cuda")
        args = [x.data_ptr() for x in packed.tensors()] + [
            c_bf.data_ptr(), dil.data_ptr(), 0 if teacher else gum.data_ptr(),
            0 if teacher else unif.data_ptr(), x_in.data_ptr() if teacher else 0,
            ring.data_ptr(), out.data_ptr(), t, d["L"], d["K"], d["R"], d["G"], d["S"], d["C"],
            d["OUT"], d["OUTP"], d["RD"], 512, smem, int(teacher),
            torch.cuda.current_stream().cuda_stream]
        err = lib.wavenet_gen_launch(*args)
        if err:
            raise RuntimeError(f"one-block kernel launch failed ({err})")
        return out

    return call


def child(tag: str, shape_name: str) -> None:
    """One shape against one variant's library (already built)."""
    watchdog(SHAPE_SECONDS)
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.models import wavenet as wn
    from neural_sound_generation_tpu_torch.ops.cuda import build, wavenet_gen

    set_full_float32()
    lib = build.load_library(f"wn_{tag}", [os.path.join(WORK, f"wn_{tag}.cu")], False)
    shape = next(s for s in shapes() if s[0] == shape_name)
    name, cfg, t = shape
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    iters = 2 if t > 5000 else 3 if t > 1000 else 10
    if not timing_only(tag) and shape_name != API_SHAPE:
        build._libs["wavenet_gen"] = lib
        wavenet_gen._lib = None
        wavenet_gen.load()
        row = chip_smoke.compare_wavenet(torch, wn, wavenet_gen, shape, gen)
        try:
            chip_smoke.check_wavenet_row(row)
            ok = True
        except chip_smoke.SmokeFailure as e:
            print("FAILED", tag, name, e, flush=True)
            ok = False
        print("ROW", json.dumps({"variant": tag, **row}), flush=True)
        print("OK" if ok else "BAD", tag, name, flush=True)
        os._exit(0)
    model = chip_smoke.seeded_wavenet(torch, wn, cfg)
    hop = 1
    for s in cfg["upsample_scales"]:
        hop *= s
    c = torch.randn(1, -(-t // hop), cfg["cin_channels"], generator=gen, device="cuda")
    with torch.no_grad():
        c_up = wn._upsample_cond(model, c)[0]
    packed = wavenet_gen.pack_weights(model)
    gum, unif = (a[:, 0].contiguous() for a in wn.draw_noise(model, gen, t, 1))
    if tag == "one_block":
        x_in = torch.zeros(t, device="cuda")
        calls = {k: one_block_launcher(lib, torch, wavenet_gen, packed, c_up, gum, unif, x_in, t,
                                 k == "wavenet_gen_teacher") for k in wavenet_gen.KERNELS}
        plan = None
    else:
        build._libs["wavenet_gen"] = lib
        wavenet_gen._lib = None
        wavenet_gen.load()
        samples = wavenet_gen.wavenet_generate(packed, c_up, gum, unif, t)
        x_in = F.pad(samples[:-1], (1, 0)).contiguous()
        calls = {"wavenet_gen_sample":
                 lambda: wavenet_gen.wavenet_generate(packed, c_up, gum, unif, t),
                 "wavenet_gen_teacher":
                 lambda: wavenet_gen.wavenet_teacher_logits(packed, c_up, x_in)}
        plan = wavenet_gen.launch_plan(packed)
    device_ms = {k: chip_smoke.device_time_ms(torch, fn, iters)[0] for k, fn in calls.items()}
    row = {"variant": tag, "shape_name": name, "t": t, "timing_only": timing_only(tag),
           "device_ms": device_ms,
           "device_us_per_step": {k: 1e3 * v / t for k, v in device_ms.items()},
           "plan": plan}
    if not timing_only(tag):  # the API-length row of a variant that keeps the arithmetic
        again = calls["wavenet_gen_sample"]()
        plain = wavenet_gen.wavenet_teacher_logits_plain(packed, c_up, x_in)
        row.update(chip_smoke.sample_consistency(torch, wn, plain, gum, unif, samples))
        row["run_to_run_identical"] = bool(torch.equal(samples, again))
    print("ROW", json.dumps(row), flush=True)
    ok = not timing_only(tag) and row.get("run_to_run_identical", False)
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
    ap.add_argument("--tags", help="comma-separated variants to run (default: all)")
    ap.add_argument("--shapes", help="comma-separated shape names (default: all)")
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
    variants = {"base": [], **BUILTIN}
    if os.path.exists(ONE_BLOCK_SOURCE):
        variants["one_block"] = []
    if args.variants:
        with open(args.variants) as f:
            variants.update(json.load(f))
    if args.tags:
        variants = {k: v for k, v in variants.items() if k in args.tags.split(",")}
    paths = {tag: variant_source(tag, rep) for tag, rep in variants.items()}
    errors: dict = {}

    def build_one(tag):
        try:
            build.load_library(f"wn_{tag}", [paths[tag]], True)
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
        info = build.build_info[f"wn_{tag}"]
        print("BUILD", tag, f"{info['seconds']:.1f}s", flush=True)
        for line in info["log"].splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill", "C75", "arning")):
                print("  ", line.strip(), flush=True)
    names = args.shapes.split(",") if args.shapes else [s[0] for s in shapes()]
    for tag in paths:
        if tag in errors:
            continue
        for name in names:
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "child", tag, name],
                                  capture_output=True, text=True, timeout=SHAPE_SECONDS + 30)
            print(f"[{tag} {name} rc={proc.returncode} {time.perf_counter() - t0:.1f}s]",
                  flush=True)
            for line in proc.stdout.splitlines():
                if line.split(" ")[0] in ("ROW", "OK", "BAD", "FAILED", "WATCHDOG"):
                    print(line, flush=True)
            if proc.returncode != 0:
                print(proc.stderr[-3000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

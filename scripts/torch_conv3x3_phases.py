#!/usr/bin/env python3
"""Where a step of the 3x3 bf16 convolution kernel spends its cycles, on a
CUDA card.

Builds a copy of ``csrc/conv3x3.cu`` with ``clock64`` read around each
phase of the mainloop's step (waits for the step's data and the barrier,
issuing a later step's loads, the A fragments and both blocks' chains,
each block's wait and adds), summed over the first lane of warps 0 and 1
of every CTA into a device array that an extra C entry reads. Warp 0's
lane 0 issues the TMA loads; warp 1 issues only its own ``cp.async``
copies. Runs both routes at the A/B shape (64, 20, 7, 256) and at
(4, 9, 11, 512), and prints per route and warp the mean cycles a step
spends in each phase, and the device-only time of the instrumented and
of the plain build, which is what the instrumentation costs.

The copy is made by inserting text at fixed places of the source; the
script stops with the place it could not find when the mainloop changes.
Run from the repository root: ``python3 scripts/torch_conv3x3_phases.py``.
Prints one JSON line per route and shape; exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = [(64, 20, 7, 256), (4, 9, 11, 512)]
CALLS = 20
PHASES = ["wait_and_barrier", "issue_loads", "ldmatrix_and_chains", "wait_block0",
          "add_block0", "wait_block1", "add_block1"]

# (place in the source, text that replaces it)
INSERTS = [
    ("#include <mutex>\n", "#include <mutex>\n__device__ unsigned long long g_phase[18];\n"),
    ("  for (int step = 0; step < g.steps; ++step) {\n"
     "    const int stage = step % kStages;\n"
     "    cp_async_wait<kAhead - 1>();",
     "  long long ph[8] = {};\n"
     "  const long long t_start = clock64();\n"
     "  for (int step = 0; step < g.steps; ++step) {\n"
     "    const int stage = step % kStages;\n"
     "    const long long t0 = clock64();\n"
     "    cp_async_wait<kAhead - 1>();"),
    ("    __syncthreads();  // everyone's copies landed; step - 1's products are done\n",
     "    __syncthreads();  // everyone's copies landed; step - 1's products are done\n"
     "    const long long t1 = clock64();\n"),
    ("    else cp_async_commit();\n\n    // this lane's row",
     "    else cp_async_commit();\n    const long long t2 = clock64();\n\n    // this lane's row"),
    ("    wgmma_commit();\n    wgmma_wait<1>();  // block 0 is done\n"
     "    add_partial<0>(run, part0);\n    wgmma_wait<0>();\n    keep(a);\n"
     "    add_partial<32>(run, part1);\n  }\n",
     "    wgmma_commit();\n    const long long t3 = clock64();\n"
     "    wgmma_wait<1>();  // block 0 is done\n    const long long t4 = clock64();\n"
     "    add_partial<0>(run, part0);\n    const long long t5 = clock64();\n"
     "    wgmma_wait<0>();\n    const long long t6 = clock64();\n    keep(a);\n"
     "    add_partial<32>(run, part1);\n    const long long t7 = clock64();\n"
     "    ph[0] += t1 - t0; ph[1] += t2 - t1; ph[2] += t3 - t2; ph[3] += t4 - t3;\n"
     "    ph[4] += t5 - t4; ph[5] += t6 - t5; ph[6] += t7 - t6;\n  }\n"
     "  ph[7] = clock64() - t_start;\n"
     "  if (tid == 0 || tid == 32) {\n"
     "    unsigned long long* out_ph = g_phase + (tid == 32 ? 9 : 0);\n"
     "    for (int i = 0; i < 8; ++i) atomicAdd(out_ph + i, (unsigned long long)ph[i]);\n"
     "    atomicAdd(out_ph + 8, 1ull);\n  }\n"),
    ("const char* conv3x3_error_string(int code) {",
     "int conv3x3_phases(unsigned long long* host, int reset) {\n"
     "  unsigned long long zero[18] = {};\n"
     "  if (reset) return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n"
     "  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(zero));\n}\n\n"
     "const char* conv3x3_error_string(int code) {"),
]


def instrumented_source(src: str) -> str:
    for place, text in INSERTS:
        if src.count(place) != 1:
            raise RuntimeError(f"the mainloop changed: no single place {place[:60]!r}")
        src = src.replace(place, text)
    return src


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: the phase profile needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from neural_sound_generation_tpu_torch.ops.cuda import build, conv3x3

    card = card_line()
    print(card, flush=True)
    path = build.BUILD_DIR / "conv3x3_phases.cu"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(instrumented_source(conv3x3.SOURCE.read_text()))
    plain_lib = conv3x3.load()
    lib = build.load_library("conv3x3_phases", [path])
    lib.conv3x3_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]

    def use(library):  # bind `library` as the wrapper's kernels
        build._libs["conv3x3"] = library
        conv3x3._lib = None
        conv3x3.load()

    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, h, w, c in SHAPES:
        x = torch.randn(b, h, w, c, generator=gen, device="cuda").to(torch.bfloat16)
        wt = (0.02 * torch.randn(3, 3, c, c, generator=gen, device="cuda")).to(torch.bfloat16)
        steps = 9 * ((c + 63) // 64)
        for name in conv3x3.KERNELS:
            fn = getattr(conv3x3, name)
            times = {}
            for label, library in (("plain", plain_lib), ("instrumented", lib)):
                use(library)
                times[label] = chip_smoke.device_time_ms(torch, lambda: fn(x, wt), 200)[0]
            use(lib)
            fn(x, wt)
            torch.cuda.synchronize()
            lib.conv3x3_phases(None, 1)
            for _ in range(CALLS):
                fn(x, wt)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 18)()
            lib.conv3x3_phases(ctypes.addressof(buf), 0)
            row = {"kernel": name, "shape": [b, h, w, c], "card": card,
                   "device_ms": times, "steps_per_cta": steps}
            for warp, off in (("warp0", 0), ("warp1", 9)):
                ctas = buf[off + 8]
                row[warp] = {p: buf[off + i] / ctas / steps for i, p in enumerate(PHASES)}
                row[warp]["step_total"] = buf[off + 7] / ctas / steps
            print(json.dumps(row), flush=True)
    use(plain_lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())

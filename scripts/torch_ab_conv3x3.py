#!/usr/bin/env python3
"""A/B of the port's two hand-written 3x3 bf16 convolution kernels against
cuDNN at the flagship's hot shape, on a CUDA card.

The port's counterpart of ``scripts/ab_conv3x3.py``: the ResBlock's 3x3
SAME convolution at (64, 20, 7, 256) -> 256 in bf16 with float32
accumulation (batch 64 of 80 x 28 mel crops after two stride-2 convs),
forward only. ``x`` and ``w`` are seeded with numpy ``default_rng(0)`` as
the JAX script seeds them.

1. Parity: both kernels (``ops/cuda/conv3x3.py``: ``conv3x3_taps`` and
   ``conv3x3_im2col``) against the plain version ``conv3x3_plain``, each
   output within ULP_LIMIT bf16 ulp (``conv3x3.bf16_ulp_error``: the ulp
   of the plain output, floored at 2**-8 of the largest) and at least
   BIT_EQUAL_MIN of them bit-equal, and against cuDNN (reported, not gated: cuDNN sums in its own
   order and may round partial sums).
2. Four legs, each ITERS chained iterations of the bounded recurrence
   ``c = bf16(conv(c) * 0.05 + x * 0.1)``: cuDNN (``F.conv2d`` on
   channels-last bf16, the yardstick, not the port), taps, im2col, cuDNN.
   Each leg prints microseconds per iteration (the convolution and the
   recurrence's three elementwise launches), TFLOP/s and the percentage of
   the H100's dense bf16 peak (989 TFLOP/s), with the card's name and
   power limit.

Run from the repository root: ``python3 scripts/torch_ab_conv3x3.py``
(``--iters N``). Prints one JSON line per measurement and a summary line;
exits non-zero without a CUDA device or when a kernel fails its parity.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

B, H, W, C = 64, 20, 7, 256
ITERS = 400
PEAK_BF16_TFLOPS = 989.0
ULP_LIMIT, BIT_EQUAL_MIN = 1, 0.999


GFLOP = 2 * B * H * W * C * C * 9 / 1e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def cudnn_conv(torch, w):
    """cuDNN's bf16 convolution on channels-last data: x (B, H, W, C) NHWC
    is the channels-last NCHW tensor ``x.permute(0, 3, 1, 2)``; the output
    comes back as an NHWC view."""
    import torch.nn.functional as F

    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def conv(x):
        return F.conv2d(x.permute(0, 3, 1, 2), w_oihw, padding=1).permute(0, 2, 3, 1)

    return conv


def parity(torch, conv3x3, x, w, library) -> dict:
    """Both kernels against the plain version and against the library call."""
    want = conv3x3.conv3x3_plain(x, w)
    lib = library(x)
    out = {"cudnn_vs_plain_max_abs_err": float((lib.float() - want.float()).abs().max())}
    for name in conv3x3.KERNELS:
        got = getattr(conv3x3, name)(x, w)
        torch.cuda.synchronize()
        ulps = conv3x3.bf16_ulp_error(got, want)
        out[name] = {
            "max_ulp": float(ulps.max()), "bit_equal_frac": float((ulps == 0).float().mean()),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "vs_cudnn_max_abs_err": float((got.float() - lib.float()).abs().max()),
        }
    return out


def leg_ms(torch, conv, x, iters: int) -> float:
    """ms of ``iters`` chained iterations, after one warm run of the same."""

    def run():
        c = x
        for _ in range(iters):
            c = (conv(c) * 0.05 + x * 0.1).to(torch.bfloat16)
        return c

    float(run().float().sum())  # warm and drain
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    c = run()
    end.record()
    torch.cuda.synchronize()
    float(c.float().sum())
    return start.elapsed_time(end)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: the A/B needs a CUDA device")
    from neural_sound_generation_tpu_torch.ops.cuda import conv3x3

    card = card_line()
    print(card, flush=True)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, C, C)) * 0.02).astype(np.float32))
    x = x.to(torch.bfloat16).cuda()
    w = w.to(torch.bfloat16).cuda()
    library = cudnn_conv(torch, w)

    row = parity(torch, conv3x3, x, w, library)
    print(json.dumps({"parity": row, "shape": [B, H, W, C]}), flush=True)
    if not all(row[k]["max_ulp"] <= ULP_LIMIT and row[k]["bit_equal_frac"] >= BIT_EQUAL_MIN
               for k in conv3x3.KERNELS):
        raise RuntimeError(f"conv3x3 parity: {row}")

    legs = []
    for name, conv in (("cudnn", library),
                       ("taps", lambda a: conv3x3.conv3x3_taps(a, w)),
                       ("im2col", lambda a: conv3x3.conv3x3_im2col(a, w)),
                       ("cudnn", library)):
        us = 1e3 * leg_ms(torch, conv, x, args.iters) / args.iters
        tflops = GFLOP / us * 1e-3
        legs.append((name, us))
        print(json.dumps({"leg": name, "us_per_conv": us, "achieved_tflops": tflops,
                          "pct_of_h100_bf16_peak": 100 * tflops / PEAK_BF16_TFLOPS,
                          "iters": args.iters, "card": card}), flush=True)
    cudnn_us = min(legs[0][1], legs[3][1])
    best = min(legs[1][1], legs[2][1])
    summary = {"cudnn_us": cudnn_us, "cudnn_us_legs": [legs[0][1], legs[3][1]],
               "taps_us": legs[1][1], "im2col_us": legs[2][1],
               "best_kernel_vs_cudnn_pct": 100 * (cudnn_us / best - 1),
               "iters": args.iters, "card": card}
    print(json.dumps({"summary": summary}), flush=True)
    return {"parity": row, "summary": summary}


if __name__ == "__main__":
    try:
        main(sys.argv[1:])
    except RuntimeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)

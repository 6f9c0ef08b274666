#!/usr/bin/env python3
"""A/B of the PyTorch port's training steps between checkouts, on one CUDA card.

Each leg is one checkout of the repository (the working tree, or a parent
unpacked with ``git archive`` into a directory ``.gitignore`` lists) and
runs in a process of its own, in the order given, so that
``ROOT_A ROOT_B ROOT_B ROOT_A`` compares two versions in turns on one card.
A leg writes a synthetic corpus with its own ``chip_smoke.write_corpus``,
then with its own ``chip_smoke.rvq_steps_per_s`` times train steps/s at the
flagship's full width (batch 64 of 80 x 28 mel crops, dim 256, 512 codes,
EMA codebooks with restarts) in bf16 with 4 residual stages and in float32
with 1 and 4, and times one nearest-code search at the training step's
N = 8960, K = 512, D = 256: the host's enqueue per call, and the wall time
per call of 200 calls ending in a synchronize.

Run from the repository root: ``python3 scripts/torch_ab_train_steps.py
ROOT [ROOT ...]``. Prints one JSON line per leg; fails without a CUDA
device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

SEARCHES = 200


def leg(root: str) -> dict:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from neural_sound_generation_tpu_torch.cli import main as cli_main
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel

    if not torch.cuda.is_available():
        raise SystemExit("a CUDA device is required")
    set_full_float32()
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.join(root, "build"))
    corpus = os.path.join(tmp, "corpus")
    cs.write_corpus(torch, dsp, Config().audio, corpus)
    args = cli_main.parse_args([
        "--model", "vqvae", "--dataset", "ljspeech", "--datadir", corpus,
        "--dim", "256", "--z-dim", "512", "--batch-size", "64",
        "--max-batches-per-epoch", "8", "--codebook-init", "data", "--device", "cuda",
        "--ckpt-dir", os.path.join(tmp, "models"), "--sampledir", os.path.join(tmp, "results"),
        "--num-quantizers", "4", "--ema-codebook", "--restart-dead-threshold", "1.0",
        "--epochs", "1"])
    cfg = cli_main.build_config(args)
    batch = next(iter(cli_main.audio_loaders(args, cfg)[0]))
    out = {"root": root, "card": cs.card_line()}
    for name, dtype, q in (("bf16_q4", torch.bfloat16, 4), ("f32_q1", torch.float32, 1),
                           ("f32_q4", torch.float32, 4)):
        out[f"{name}_steps_per_s"] = cs.rvq_steps_per_s(torch, cli_main, cfg, batch, dtype, q)

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn(8960, 256, generator=gen, device="cuda")
    cb = torch.randn(512, 256, generator=gen, device="cuda")
    for _ in range(3):
        vq_kernel.nearest_codebook_indices(x, cb)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SEARCHES):
        vq_kernel.nearest_codebook_indices(x, cb)
    out["vq_host_us_per_call"] = 1e6 * (time.perf_counter() - t0) / SEARCHES
    torch.cuda.synchronize()
    out["vq_wall_us_per_call"] = 1e6 * (time.perf_counter() - t0) / SEARCHES
    return out


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--leg":
        print(json.dumps(leg(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--leg", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

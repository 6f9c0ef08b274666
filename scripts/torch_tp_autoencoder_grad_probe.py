#!/usr/bin/env python3
"""The first-step gradient of smoke phase 20's autoencoders over the model
axis, tensor by tensor, against the card's and the CPU's one-rank steps.

Writes the smoke's chirp corpus and its mu-law copy, then launches
``chip_smoke.p20_jobs``' hier, raw wave and mulaw RVQ 2 jobs (phase 11's
full widths and flags, 2 steps each) under ``torchrun`` on this card at
W 1 twice, W 2 (data 1 x model 2) and, for the raw wave model, W 4 (data 2
x model 2), through ``chip_smoke.launch_tp``; then recomputes each W 1
first step on the CPU in float32 from its recorded state, batch and codes
(``chip_smoke.p20_cpu_grad``). For every job, relative to the W 1
gradient's norm: the gap of the second W 1 run (the card's run-to-run
spread), of W 2, of W 4 and of the CPU step; each gap also without the
convolution biases that a norm follows (their true gradient is 0); the
tensors whose gradient moved most, with their norms. One JSON line a job,
and all of them to ``--out``.

Run from the repository root: ``python3
scripts/torch_tp_autoencoder_grad_probe.py [--top 6] [--out FILE]``
(about 160 s on an H100); fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

JOBS = ("hier", "wave_raw", "wave_mulaw")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--top", type=int, default=6)
    p.add_argument("--out", default=None)
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.ops.cuda import fused_adam, vq_kernel
    from neural_sound_generation_tpu_torch.training.sharding import _CONVS, _norm_after

    print(cs.card_line(), flush=True)
    set_full_float32()
    for m in (vq_kernel, fused_adam):
        m.load()
    root = os.path.join(REPO, "build", "tp_grad_probe")
    base = os.path.join(root, "tp_ae")
    os.makedirs(base, exist_ok=True)
    corpus = os.path.join(root, "corpus")
    cs.write_corpus(torch, dsp, Config().audio, corpus)
    preset = os.path.join(base, "mulaw_quantize.json")
    with open(preset, "w", encoding="utf-8") as f:
        json.dump({"input_type": "mulaw-quantize", "quantize_channels": 256}, f)
    data = {"corpus": corpus, "preset": preset,
            "mulaw": cs.mulaw_corpus(torch, dsp, corpus, os.path.join(base, "corpus_mulaw"), 256),
            "mnist": ""}

    def jobs(world: int) -> list:
        return [j for j in cs.p20_jobs(root, data, world) if j["name"] in JOBS]

    runs = {"w1": cs.launch_tp(torch, root, jobs(1), 1, "tp_ae", "wave_raw", 1),
            "w1_again": cs.launch_tp(torch, root, jobs(1), 1, "tp_ae_again", "wave_raw", 1),
            "w2": cs.launch_tp(torch, root, jobs(2), 2, "tp_ae", "wave_raw", 1),
            "w4": cs.launch_tp(torch, root, jobs(4), 4, "tp_ae", "wave_raw", 1)}
    argv = {j["name"]: j["argv"] for j in jobs(1)}
    models = cs.p20_models(torch)
    lines = []
    for job in JOBS:
        model = models[job]
        noise = {f"{name}.bias" for name, mod in model.named_modules()
                 if isinstance(mod, _CONVS) and _norm_after(model, name) is not None}
        one = runs["w1"]["ranks"][0][job]
        g1 = one["first_grad"]
        keys = sorted(g1)
        norm = float(torch.cat([g1[k].reshape(-1) for k in keys]).norm())
        others = {w: runs[w]["ranks"][0][job]["first_grad"]
                  for w in ("w1_again", "w2", "w4") if job in runs[w]["ranks"][0]}
        others["cpu"] = cs.p20_cpu_grad(torch, one, argv[job])
        line = {"job": job, "norm": norm, "noise_biases": len(noise)}
        for w, g in others.items():
            gap = {k: float((g[k] - g1[k]).norm()) for k in keys}
            line[w] = {
                "rel": sum(v * v for v in gap.values()) ** 0.5 / norm,
                "rel_without_noise_biases": sum(
                    v * v for k, v in gap.items() if k not in noise) ** 0.5 / norm,
                "top": [(k, v, float(g1[k].norm()))
                        for k, v in sorted(gap.items(), key=lambda kv: -kv[1])[:args.top]]}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

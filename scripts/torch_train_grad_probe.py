#!/usr/bin/env python3
"""Card-vs-CPU gradient of the flat VQ-VAE's train step (``chip_smoke.py``
phase 5), over several trainings.

Each trial trains phase 5's model on one CUDA card (``cli.main --model
vqvae`` at dim 256, 512 codes, batch 64 of 80 x 28 crops, ``--codebook-init
data``, two epochs of ``BATCHES_PER_EPOCH`` steps on the smoke's chirp
corpus) from its own ``--seed``, then runs one float32 train step from the
checkpoint, as phase 5's card-vs-CPU check does, on the card, on the CPU
at its default thread count and on the CPU on one thread; each step also
recomputes, in float64, every convolution's weight and bias gradient from
the float32 input and output gradient that convolution saw
(``torch_hier_grad_probe.exact_conv_grads``). One JSON line a trial gives
the card's ``grad_norm`` gap from the CPU's (phase 5's measure, relative,
and its limit's 1e-5), the CPU's own order spread (its one-thread step's
gap), the code flips, and for each step its flat gradient's distance from
its own float64 reference and from the CPU's, over the reference's norm,
with the first convolution's apart. With ``--out`` the lines also go to
that file.

Run from the repository root: ``python3 scripts/torch_train_grad_probe.py
[--seeds 1 2 3] [--out FILE]``; fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: name -> (device, CPU threads or None); the CPU at its default last
VARIANTS = {"card": ("card", None), "cpu_one_thread": ("cpu", 1), "cpu": ("cpu", None)}
FIRST_CONV = "encoder.Conv_0"


def trial(torch, cs, probe, cli_main, checkpoint, cfg, ckpt: str, batch) -> dict:
    from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
    from neural_sound_generation_tpu_torch.ops.vq import vq
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    grads, norms, refs, codes = {}, {}, {}, {}
    for tag, (where, threads) in VARIANTS.items():
        device = cs.DEVICE if where == "card" else "cpu"
        model = cli_main.make_model(cfg).to(device)
        state = create_train_state(model, cfg.train)
        checkpoint.restore(ckpt, state)
        x = torch.from_numpy(batch["x"]).to(device)
        with probe.variant(torch, None, threads), torch.no_grad(), batch_stats_discarded(model):
            model.train()
            codes[tag] = vq(model._encode_latents(x), model.codebook).cpu()
        exact = {}
        with probe.variant(torch, None, threads), probe.exact_conv_grads(torch, model, exact):
            _, m = make_train_step(model, cfg)(state, {"x": x})
        norms[tag] = float(m["grad_norm"])
        grads[tag] = state.flat.grad.detach().cpu().double().clone()
        refs[tag] = probe.reference(torch, state.flat, grads[tag], exact)
        flat = state.flat
    ref_norm = float(refs["cpu"].norm())

    def first(v):
        return flat.named(v)[f"{FIRST_CONV}.weight"]

    row = {"grad_norm": norms["cpu"],
           "gap": abs(norms["card"] - norms["cpu"]) / norms["cpu"],
           "spread": abs(norms["cpu_one_thread"] - norms["cpu"]) / norms["cpu"],
           "code_flips": int((codes["card"] != codes["cpu"]).sum())}
    for tag in VARIANTS:
        g, r = grads[tag], refs[tag]
        row[tag] = {
            "grad_vs_own_reference": float((g - r).norm()) / ref_norm,
            "grad_vs_cpu": float((g - grads["cpu"]).norm()) / ref_norm,
            "first_conv_vs_own_reference": float((first(g) - first(r)).norm())
            / float(first(r).norm()),
            "first_conv_vs_cpu": float((first(g) - first(grads["cpu"])).norm())
            / float(first(refs["cpu"]).norm())}
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--out", help="a file to write the JSON lines to as well")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch

    import chip_smoke as cs
    import torch_hier_grad_probe as probe
    from neural_sound_generation_tpu_torch.cli import main as cli_main
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.training import checkpoint

    if cs.DEVICE == "cuda" and not torch.cuda.is_available():
        print("FAIL: a CUDA device is required", file=sys.stderr)
        return 1
    set_full_float32()
    if cs.DEVICE == "cuda":
        print(cs.card_line(), flush=True)
    root = os.path.join(ROOT, "build", "train_grad_probe")
    shutil.rmtree(root, ignore_errors=True)
    corpus = os.path.join(root, "corpus")
    cs.write_corpus(torch, dsp, Config().audio, corpus)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        open(args.out, "w").close()
    try:
        for seed in args.seeds:
            out = os.path.join(root, f"seed{seed}")
            argv = ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", corpus,
                    "--dim", str(cs.TRAIN_DIM), "--z-dim", str(cs.TRAIN_CODES),
                    "--batch-size", str(cs.TRAIN_BATCH), "--max-batches-per-epoch",
                    str(cs.BATCHES_PER_EPOCH), "--codebook-init", "data", "--device",
                    cs.DEVICE, "--ckpt-dir", os.path.join(out, "models"),
                    "--sampledir", os.path.join(out, "results")]
            with contextlib.redirect_stdout(io.StringIO()):
                cli_main.main(argv + ["--epochs", "2", "--seed", str(seed)])
            parsed = cli_main.parse_args(argv + ["--epochs", "1"])
            cfg = cli_main.build_config(parsed)
            batch = next(iter(cli_main.audio_loaders(parsed, cfg)[0]))
            ckpt = os.path.join(out, "models", "vqvae",
                                f"checkpoint_ljspeech_{cs.TRAIN_DIM}_{cs.TRAIN_CODES}")
            line = json.dumps({"seed": seed, **trial(torch, cs, probe, cli_main, checkpoint,
                                                      cfg, ckpt, batch)})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

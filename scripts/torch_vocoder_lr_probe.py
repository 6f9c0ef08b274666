#!/usr/bin/env python3
"""How the CLI's default vocoder learns over its first steps, on a CUDA card.

Writes ``chip_smoke.py``'s chirp corpus, takes the batches ``cli.vocoder
train`` would see over its first epochs (batch 2 of 7168-sample crops, 8
batches an epoch, the loader's order for epochs 0, 1, ...), and for each
setting trains the full-width MoL vocoder from the CLI's seeded weights
(``--seed`` 0), printing the loss on the first batch (held fixed) every 4
steps and every step's training loss. Settings: constant learning rates
1e-3 (the CLI's default), 3e-4 and 1e-4 in float32, 1e-4 under ``--bf16``,
and 1e-3 with the gradient clipped at 1.0.

Run from the repository root: ``python3 scripts/torch_vocoder_lr_probe.py
[--epochs 4]``. Prints the card, then one JSON line per setting; fails
without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SETTINGS = [(1e-3, False, -1.0), (3e-4, False, -1.0), (1e-4, False, -1.0), (1e-4, True, -1.0),
            (1e-3, False, 1.0)]  # (lr, bf16, clip)
BATCH, BATCHES_PER_EPOCH, EVERY = 2, 8, 4


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the vocoder's first steps at several lrs")
    p.add_argument("--epochs", type=int, default=4)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from neural_sound_generation_tpu_torch.cli import vocoder as cli_vocoder
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.data.pipeline import get_audio_data_loaders
    from neural_sound_generation_tpu_torch.device import resolve_device
    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.training import trainer
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    device = resolve_device("cuda")
    print(chip_smoke.card_line(), flush=True)
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                        "lr_probe")
    corpus = os.path.join(root, "corpus")
    base = Config()
    try:
        chip_smoke.write_corpus(torch, dsp, base.audio, corpus)
        loader = get_audio_data_loaders(corpus, None, BATCH, base, batch_mode="raw")["train"]
        batches = []
        for epoch in range(args.epochs):
            loader.set_epoch(epoch)
            for i, raw in enumerate(loader):
                if i >= BATCHES_PER_EPOCH:
                    break
                y, c = cli_vocoder._batch_to_wavenet(raw, base)
                batches.append({"y": y, "c": c, "input_lengths": np.asarray(raw["input_lengths"])})
        batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in batches]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    held = batches[0]
    for lr, bf16, clip in SETTINGS:
        cfg = dataclasses.replace(base, train=dataclasses.replace(
            base.train, initial_learning_rate=lr, clip_thresh=clip))
        model = cli_vocoder.build_model(cfg, chip_smoke.vocoder_widths(bf16=bf16),
                                        generator=torch.Generator().manual_seed(0)).to(device)
        state = create_train_state(model, cfg.train)
        step = trainer.make_train_step(model, cfg)

        def held_loss():
            with torch.no_grad():
                return float(trainer._wavenet_loss(model, cfg, held)[1])

        trajectory, losses = [(0, held_loss())], []
        for i, batch in enumerate(batches):
            _, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if (i + 1) % EVERY == 0:
                trajectory.append((i + 1, held_loss()))
        print(json.dumps({"lr": lr, "bf16": bf16, "clip": clip, "held_loss": trajectory,
                          "step_losses": losses}), flush=True)
        del model, state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Card-vs-CPU code flips of the residual-VQ train step, over several trainings.

Each trial trains ``chip_smoke.py``'s residual-VQ model on one CUDA card
(``chip_smoke.rvq_argv``: dim 256, 512 codes, 4 stages, EMA codebooks with
restarts, --bf16, ``RVQ_EPOCHS`` epochs on the smoke's chirp corpus) from
its own ``--seed``, then runs ``chip_smoke.rvq_card_vs_cpu``'s float32 step
and prints its record: the flips by stage, ``rvq_flip_causes`` (first
flips and cascades, flips that are no near-tie, distinct flipped vectors
and the largest group of rows one decision flipped), the identical rows of
the CPU's z_e, and the loss terms with the part the flips explain.

Then constructed ties on the last trial's checkpoint: each of the
``--tie-groups`` largest groups of bit-identical z_e rows is put, one at a
time, exactly between its two nearest stage-0 codes (the second moved
along the line from the row until both distances are equal in float64),
and the card's residual-VQ assignment of its own z_e is held against the
CPU's, as the smoke's rule holds them.

Run from the repository root: ``python3 scripts/torch_rvq_flip_causes.py
[--seeds 1 2 3 4 5 6] [--tie-groups 8]``. One JSON line per trial and per
constructed tie;
fails without a CUDA device.
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
CARD = "cuda"  # a rehearsal on the CPU at small sizes may set it


def latents(torch, cli_main, checkpoint, cfg, ckpt: str, x, device: str):
    """(z_e, codebooks) of the checkpoint's model in train mode on ``device``."""
    from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    model = cli_main.make_model(cfg).to(device)
    state = create_train_state(model, cfg.train, ema_codebook=True)
    checkpoint.restore(ckpt, state)
    with torch.no_grad(), batch_stats_discarded(model):
        model.train()
        z = model._encode_latents(torch.from_numpy(x).to(device))
    return z, model.codebook.detach()


def constructed_ties(torch, cs, cli_main, checkpoint, cfg, ckpt: str, x, groups: int) -> list:
    """Each of the ``groups`` largest groups of identical CPU z_e rows put,
    one at a time, on the bisector of its two nearest stage-0 codes; card
    vs CPU assignments and their causes."""
    from neural_sound_generation_tpu_torch.ops.vq import residual_vq

    z_card, cb = latents(torch, cli_main, checkpoint, cfg, ckpt, x, CARD)
    z_cpu, _ = latents(torch, cli_main, checkpoint, cfg, ckpt, x, "cpu")
    values, inverse, counts = torch.unique(z_cpu.reshape(-1, z_cpu.shape[-1]), dim=0,
                                           return_inverse=True, return_counts=True)
    card_rows = z_card.reshape(-1, z_card.shape[-1]).cpu()
    cb64 = cb.cpu().double()
    out = []
    for top in counts.argsort(descending=True)[:groups].tolist():
        r = values[top].double()
        i, j = ((r - cb64[0]) ** 2).sum(1).argsort()[:2].tolist()
        scale = (r - cb64[0, i]).norm() / (r - cb64[0, j]).norm()
        tied = cb.cpu().clone()
        tied[0, j] = (r + (cb64[0, j] - r) * scale).float()
        codes_cpu = residual_vq(z_cpu, tied)[2].long()
        codes_card = residual_vq(z_card, tied.to(CARD))[2].long().cpu()
        group = inverse == top
        out.append({
            "case": "constructed_tie", "group_rows": int(counts[top]),
            "group_identical_on_card": bool((card_rows[group] == card_rows[group][0]).all()),
            "codes": [i, j], "cpu_picks": codes_cpu[0][group].unique().tolist(),
            "card_picks": codes_card[0][group].unique().tolist(),
            "code_flips_by_stage": (codes_card != codes_cpu).sum(dim=1).tolist(),
            **cs.rvq_flip_causes(torch, z_cpu, z_card.cpu(), tied.double(), codes_cpu,
                                 codes_card)})
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    p.add_argument("--tie-groups", type=int, default=8)
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from neural_sound_generation_tpu_torch.cli import main as cli_main
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.training import checkpoint, trainer

    if not torch.cuda.is_available():
        print("FAIL: a CUDA device is required", file=sys.stderr)
        return 1
    set_full_float32()
    print(cs.card_line(), flush=True)
    root = os.path.join(ROOT, "build", "rvq_flip_causes")
    shutil.rmtree(root, ignore_errors=True)
    corpus = os.path.join(root, "corpus")
    cs.write_corpus(torch, dsp, Config().audio, corpus)
    try:
        for seed in args.seeds:
            out = os.path.join(root, f"seed{seed}")
            argv = cs.rvq_argv(out, corpus)
            with contextlib.redirect_stdout(io.StringIO()):
                cli_main.main(argv + ["--epochs", str(cs.RVQ_EPOCHS), "--bf16",
                                      "--seed", str(seed)])
            parsed = cli_main.parse_args(argv + ["--epochs", "1"])
            cfg = cli_main.build_config(parsed)
            batch = next(iter(cli_main.audio_loaders(parsed, cfg)[0]))
            ckpt = os.path.join(out, "models", "vqvae",
                                f"checkpoint_ljspeech_{cs.TRAIN_DIM}_{cs.TRAIN_CODES}")
            row = cs.rvq_card_vs_cpu(torch, cli_main, checkpoint, trainer, cfg, ckpt, batch,
                                     torch.float32)
            print(json.dumps({"case": "trained", "seed": seed, **row}), flush=True)
        for row in constructed_ties(torch, cs, cli_main, checkpoint, cfg, ckpt, batch["x"],
                                    args.tie_groups):
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

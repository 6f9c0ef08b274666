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

``--limits`` reads instead what the smoke's limits are set from: for each
seed and each family of ``--families``, a trained state and the smoke's
own card-vs-CPU step and its check on it (``flat``: the state phase 5
checks, trained by its own arguments, ``chip_smoke.phase5_argv``: two
epochs at ``--multi-steps 4``, then a third with ``--resume``; phase 5's
``--multi-steps 1`` run writes another checkpoint, which no check reads;
then ``flat_card_vs_cpu`` and ``check_flat_step``; ``wave_raw``: phase 11's raw
WaveVQVAE, ``cli.main --model wavevqvae`` with EMA codebooks, restarts and
data init for ``OTHER_EPOCHS`` epochs, then ``rvq_card_vs_cpu`` and
``check_ema_step``). One JSON line a state gives the relative grad_norm
gap, the code flips, the CPU's own one-thread spread, and whether the
smoke's check passed, with its message when it did not.

Run from the repository root: ``python3 scripts/torch_train_grad_probe.py
[--seeds 1 2 3] [--limits [--families flat wave_raw]] [--out FILE]``;
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


def cpu_grad_norm(torch, cli_main, checkpoint, cfg, ckpt: str, batch, threads: int,
                  ema_codebook: bool) -> float:
    """The grad_norm of one f32 train step on the CPU at ``threads``
    threads (under EMA codebooks the norm is taken after the codebook's
    gradient is zeroed, before any restart is drawn)."""
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    saved = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        model = cli_main.make_model(cfg)
        state = create_train_state(model, cfg.train, ema_codebook=ema_codebook)
        checkpoint.restore(ckpt, state)
        _, m = make_train_step(model, cfg)(state, {"x": torch.from_numpy(batch["x"])},
                                          torch.Generator().manual_seed(0))
        return float(m["grad_norm"])
    finally:
        torch.set_num_threads(saved)


def limits_trial(torch, cs, cli_main, checkpoint, family: str, corpus: str, out: str,
                 seed: int) -> dict:
    """One trained state of ``family`` and the smoke's card-vs-CPU step and
    check on it."""
    from neural_sound_generation_tpu_torch.training import trainer

    if family == "flat":
        with contextlib.redirect_stdout(io.StringIO()):
            for epochs, extra in ((2, ()), (3, ("--resume",))):
                cli_main.main(cs.phase5_argv(out, corpus, "multi4", epochs, 4, *extra,
                                             "--seed", str(seed)))
        parsed = cli_main.parse_args(cs.phase5_argv(out, corpus, "multi4", 3, 1))
        ckpt = cs.phase5_ckpt(out, "multi4")
    else:
        argv = cs.other_argv("wavevqvae", out, corpus) + [
            "--num-downsample", str(cs.WAVE_DOWNSAMPLE), "--ema-codebook",
            "--restart-dead-threshold", "1.0", "--codebook-init", "data"]
        with contextlib.redirect_stdout(io.StringIO()):
            cli_main.main(argv + ["--epochs", str(cs.OTHER_EPOCHS), "--seed", str(seed)])
        parsed = cli_main.parse_args(argv + ["--epochs", "1"])
        ckpt = os.path.join(out, "models", "wavevqvae",
                            f"checkpoint_ljspeech_{cs.TRAIN_DIM}_{cs.TRAIN_CODES}")
    cfg = cli_main.build_config(parsed)
    batch = next(iter(cli_main.audio_loaders(parsed, cfg)[0]))
    if family == "flat":
        rec, _ = cs.flat_card_vs_cpu(torch, cli_main, checkpoint, cfg, ckpt, batch)
        flips = rec["code_flips"]

        def held():
            cs.check_flat_step(rec)
    else:
        rec = cs.rvq_card_vs_cpu(torch, cli_main, checkpoint, trainer, cfg, ckpt, batch,
                                 torch.float32, encode=lambda m, x: m.encode_latents(x))
        flips = sum(rec["code_flips_by_stage"])

        def held():
            cs.check_ema_step(rec, "wavevqvae raw", cs.WAVE_NO_FLIP_GRAD_REL)
    try:
        held()
        failure = None
    except cs.SmokeFailure as e:
        failure = str(e)[:400]
    cpu_norm = cpu_grad_norm(torch, cli_main, checkpoint, cfg, ckpt, batch,
                             torch.get_num_threads(), family != "flat")
    one = cpu_grad_norm(torch, cli_main, checkpoint, cfg, ckpt, batch, 1, family != "flat")
    return {"gap": rec["metrics_rel_err"]["grad_norm"], "code_flips": flips,
            "spread": abs(one - cpu_norm) / cpu_norm, "grad_norm": rec["grad_norm"],
            "passed": failure is None, "failure": failure}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--limits", action="store_true",
                   help="the smoke's own step and check on each family's trained states")
    p.add_argument("--families", nargs="+", default=["flat", "wave_raw"],
                   choices=["flat", "wave_raw"])
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
    def write(line: str) -> None:
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    try:
        for seed in args.seeds:
            out = os.path.join(root, f"seed{seed}")
            if args.limits:
                for family in args.families:
                    row = limits_trial(torch, cs, cli_main, checkpoint, family, corpus,
                                       os.path.join(out, family), seed)
                    write(json.dumps({"seed": seed, "family": family, **row}))
                shutil.rmtree(out, ignore_errors=True)
                continue
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
            write(json.dumps({"seed": seed, **trial(torch, cs, probe, cli_main, checkpoint,
                                                     cfg, ckpt, batch)}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Top-code usage of the two-level VQ-VAE in the JAX package and in the port,
trained the same way: ``cli.main --model hiervqvae --codebook-init data``
on one synthetic chirp corpus (``chip_smoke.write_corpus``), the same seed,
widths and steps, then ``cli.evaluate`` of each package on the same rows,
with the EMA shadow and with the live parameters. Both packages draw their
initial weights and data-init rows from their own generators, so the two
runs are compared as distributions, not bit for bit.

Run on the CPU: ``python tests/hier_top_codes.py [--dim 64] [--z-dim 128]
[--batch 16] [--batches 8] [--epochs 2] [--utterances 200] [--seeds 1 2 3]``
(about a minute a seed at those widths); one JSON line a seed and package.
``tests/test_torch_hier_prior.py`` runs it at small widths.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_code_usage(root: str, dim: int, z_dim: int, batch: int, batches: int, epochs: int,
                   utterances: int, seed: int) -> dict:
    """{"jax": {...}, "port": {...}}: each package's eval metrics
    (``perplexity_top``, ``perplexity``, losses) with the EMA shadow
    (``ema``) and with the live parameters (``live``)."""
    import torch

    sys.path.insert(0, REPO)
    import chip_smoke
    from neural_sound_generation_tpu.cli import evaluate as jevaluate
    from neural_sound_generation_tpu.cli import main as jmain
    from neural_sound_generation_tpu_torch.cli import evaluate as tevaluate
    from neural_sound_generation_tpu_torch.cli import main as tmain
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.ops import dsp

    corpus = os.path.join(root, "corpus")
    saved = chip_smoke.DEVICE, chip_smoke.CORPUS_UTTERANCES
    chip_smoke.DEVICE, chip_smoke.CORPUS_UTTERANCES = "cpu", utterances
    try:
        chip_smoke.write_corpus(torch, dsp, Config().audio, corpus)
    finally:
        chip_smoke.DEVICE, chip_smoke.CORPUS_UTTERANCES = saved
    widths = ["--model", "hiervqvae", "--datadir", corpus, "--dim", str(dim), "--z-dim",
              str(z_dim)]
    out = {}
    for name, train, evaluate, device in (("jax", jmain, jevaluate, []),
                                          ("port", tmain, tevaluate, ["--device", "cpu"])):
        models = os.path.join(root, name, "models")
        with contextlib.redirect_stdout(io.StringIO()):
            train.main([*widths, "--dataset", "ljspeech", "--batch-size", str(batch),
                        "--max-batches-per-epoch", str(batches), "--epochs", str(epochs),
                        "--log-interval", "0", "--codebook-init", "data", "--seed", str(seed),
                        "--ckpt-dir", models, "--sampledir", os.path.join(root, name, "res"),
                        *device])
        ckpt = os.path.join(models, "hiervqvae", f"checkpoint_ljspeech_{dim}_{z_dim}")
        out[name] = {}
        for tag, flags in (("ema", []), ("live", ["--no-ema"])):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                evaluate.main([*widths, "--ckpt-dir", ckpt, "--batch-size", str(batch),
                               "--max-batches", "4", *flags, *device])
            line = [s for s in text.getvalue().splitlines() if s.startswith("{")][-1]
            out[name][tag] = json.loads(line)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--z-dim", type=int, default=128)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--batches", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--utterances", type=int, default=200)
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    for seed in args.seeds:
        with tempfile.TemporaryDirectory() as root:
            usage = top_code_usage(root, args.dim, args.z_dim, args.batch, args.batches,
                                   args.epochs, args.utterances, seed)
        for name, by_tag in usage.items():
            print(json.dumps({"seed": seed, "package": name, "dim": args.dim,
                              "z_dim": args.z_dim, "steps": args.batches * args.epochs,
                              **{f"{tag}_{k}": round(m[k], 6) for tag, m in by_tag.items()
                                 for k in ("perplexity_top", "perplexity", "loss_recons")}}))


if __name__ == "__main__":
    main()

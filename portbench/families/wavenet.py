"""The WaveNet vocoder family: the port's ``cli.vocoder train`` path, and
the plain reference beside it.

The program is built as ``cli.vocoder``'s training command builds it
(``parse_args``, ``build_model``, ``create_train_state``, ``Trainer``) from
the configuration's widths and the traffic's flags; the benchmark's seeded
weights replace the CLI's before the train state flattens them. Batches are
the CLI's: float32 targets (B, T, 1), mels (B, T', mels), the lengths.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench import counters
from portbench.families.vqvae import load_weights
from portbench.reference import wavenet as ref


def param_table(config: dict):
    return ref.param_table(config["layers"], config["residual_channels"], config["gate_channels"],
                           config["skip_out_channels"], config["cin_channels"],
                           config["out_channels"], tuple(config["upsample_scales"]))


def build_program(config: dict, traffic: dict, weights: dict, device):
    """(trainer, train state) of ``cli.vocoder train`` on ``device``."""
    from neural_sound_generation_tpu_torch.cli import vocoder as cli
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import Trainer

    args = cli.parse_args(["train", "--datadir", ".", "--batch-size", str(config["batch"]),
                           "--layers", str(config["layers"]), "--stacks", str(config["stacks"]),
                           "--residual-channels", str(config["residual_channels"]),
                           *traffic.get("cli", []), "--device", str(device)])
    cfg = Config()
    model = cli.build_model(cfg, args, generator=torch.Generator().manual_seed(args.seed)).to(device)
    load_weights(model, weights)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=args.batch_size, ema_warmup=args.ema_warmup))
    state = create_train_state(model, cfg.train)
    trainer = Trainer(model, cfg, state, log_fn=None, multi_steps=args.multi_steps)
    return trainer, state


def batch_size(config: dict) -> int:
    return int(config["batch"])


def make_pool(config: dict, n: int, seed: int) -> list[dict]:
    """``n`` batches of voiced-speech-like crops in [-1, 1] (a gliding
    fundamental with decaying harmonics, an amplitude envelope and noise)
    with mel-like conditioning in [0, 1]; every row differs."""
    rng = np.random.default_rng(seed)
    b, t, frames = batch_size(config), config["crop_samples"], config["frames"]
    sr, mels = config["sample_rate"], config["cin_channels"]
    time_s = np.arange(t) / sr
    pool = []
    for _ in range(n):
        y = np.zeros((b, t), np.float64)
        for i in range(b):
            f0 = rng.uniform(90, 260) * (1 + rng.uniform(-0.15, 0.15) * time_s / time_s[-1])
            phase = 2 * np.pi * np.cumsum(f0) / sr
            for h in range(1, 6):
                y[i] += rng.uniform(0.2, 1.0) / h * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
            env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 6) * time_s + rng.uniform(0, 6))
            y[i] = y[i] * env + 0.02 * rng.standard_normal(t)
            y[i] *= rng.uniform(0.3, 0.95) / np.abs(y[i]).max()
        c = np.clip(0.5 + 0.2 * rng.standard_normal((b, frames, mels)), 0.0, 1.0)
        pool.append({"y": y.astype(np.float32)[..., None], "c": c.astype(np.float32),
                     "input_lengths": np.full((b,), t, np.int64)})
    return pool


def reference_loss(config: dict):
    return ref.make_loss(config["layers"], config["stacks"], config["quantize_channels"],
                         config["log_scale_min"])


def audio_seconds_per_step(config: dict) -> float:
    return batch_size(config) * config["crop_samples"] / config["sample_rate"]


def step_flops(config: dict) -> int:
    return counters.wavenet_step_flops(
        batch_size(config), config["crop_samples"], config["frames"], config["layers"],
        config["residual_channels"], config["gate_channels"], config["skip_out_channels"],
        config["cin_channels"], config["out_channels"])

"""The mel VQ-VAE family: the port's ``cli.main --model vqvae`` training
path, and the plain reference beside it.

The program is built by the CLI's own builders (``parse_args``,
``build_config``, ``make_model``, ``create_train_state``, ``Trainer``) from
the configuration's widths and the traffic's flags; the benchmark's seeded
weights replace the CLI's before the train state flattens them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import counters
from portbench.harness import say
from portbench.reference import vqvae as ref


def param_table(config: dict):
    return ref.param_table(config["dim"], config["codes"], config.get("input_dim", 1))


def build_program(config: dict, traffic: dict, weights: dict, device):
    """(trainer, train state) of ``cli.main`` on ``device`` with ``weights``."""
    from neural_sound_generation_tpu_torch.cli import main as cli
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import Trainer

    args = cli.parse_args(["--model", "vqvae", "--dataset", "ljspeech", "--dim", str(config["dim"]),
                           "--z-dim", str(config["codes"]), "--batch-size", str(config["batch"]),
                           *traffic.get("cli", []), "--device", str(device)])
    cfg = cli.build_config(args)
    model = cli.make_model(cfg, 0, norm=args.norm, generator=torch.Generator().manual_seed(args.seed),
                           dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    load_weights(model, weights)
    state = create_train_state(model, cfg.train, ema_codebook=cfg.model.ema_codebook)
    trainer = Trainer(model, cfg, state, log_fn=say, metrics_path=None,
                      multi_steps=args.multi_steps)
    return trainer, state


def load_weights(model, weights: dict) -> None:
    """Copy the benchmark's weights into the model's parameters by name;
    the two sets of names must be the same."""
    names = dict(model.named_parameters())
    if set(names) != set(weights):
        raise ValueError(f"parameter names differ: program only {sorted(set(names) - set(weights))},"
                         f" reference only {sorted(set(weights) - set(names))}")
    with torch.no_grad():
        for name, p in names.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(p.shape)}, reference "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])


def batch_size(config: dict) -> int:
    return int(config["batch"])


def make_pool(config: dict, n: int, seed: int) -> list[dict]:
    """``n`` batches of mel crops in [0, 1] (normalised log-mels): a sloping
    envelope, a few formant-like ridges moving in time, and noise; every
    row differs."""
    rng = np.random.default_rng(seed)
    b, m, f = batch_size(config), config["num_mels"], config["frames"]
    mel = np.arange(m, dtype=np.float32)[None, :, None] / m
    t = np.arange(f, dtype=np.float32)[None, None, :] / f
    pool = []
    for _ in range(n):
        tilt = rng.uniform(0.3, 0.8, (b, 1, 1)).astype(np.float32)
        x = 0.9 - tilt * mel
        for _ in range(3):
            centre = rng.uniform(0.05, 0.7, (b, 1, 1)) + rng.uniform(-0.1, 0.1, (b, 1, 1)) * t
            x = x + 0.25 * np.exp(-((mel - centre) / 0.04) ** 2)
        x = x + 0.08 * rng.standard_normal((b, m, f))
        pool.append({"x": np.clip(x, 0.0, 1.0).astype(np.float32)[..., None]})
    return pool


def reference_loss(config: dict):
    beta = float(config.get("beta", 1.0))

    def loss(params, batch):
        return ref.loss(params, batch, beta)

    return loss


def reference_codes(weights: dict, batch: dict, prec) -> torch.Tensor:
    """The codes the reference's first training step picks for ``batch``."""
    with prec.active(), torch.no_grad():
        z_e = ref.encode(weights, batch["x"])
        return ref.nearest(z_e.reshape(-1, weights["codebook"].shape[1]), weights["codebook"])


def audio_seconds_per_step(config: dict) -> float:
    return batch_size(config) * config["frames"] * config["hop"] / config["sample_rate"]


def step_flops(config: dict) -> int:
    return counters.vqvae_step_flops(batch_size(config), config["num_mels"], config["frames"],
                                     config["dim"], config["codes"])

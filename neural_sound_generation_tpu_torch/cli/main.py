"""Training CLI: the mel VQ-VAE on the audio datasets.

Counterpart of ``neural_sound_generation_tpu/cli/main.py`` with its flag
surface (the reference's ``--batch-size --lr-rate --dataset --datadir
--sampledir --epochs --seed --log-interval --model --beta --dim --z-dim``
plus ``--preset --resume --multi-steps --ema-codebook
--restart-dead-threshold --codebook-init --ema-warmup --bf16-moments --norm
--speaker-id --max-batches-per-epoch --num-quantizers --bf16``) and its
behaviour: per-epoch train and test, a reconstruction ``.npy`` and
Griffin-Lim ``.wav`` per epoch, ``metrics.jsonl``, a checkpoint every
epoch, every ``checkpoint_interval`` steps and on Ctrl-C, and ``--resume``
that replays the data order of the interrupted epoch.

``--num-quantizers Q`` trains residual VQ with a (Q, K, D) codebook;
``--bf16`` runs the convolutions in bfloat16 (parameters, VQ, loss and
optimizer stay float32, and the checkpoint is float32). Flags of later
slices refuse with the slice named: ``--model vae|hiervqvae|wavevqvae``,
MNIST/CIFAR10 and ``--mesh-*`` beyond one device. ``--device`` defaults to
the CUDA card.

Run: ``python -m neural_sound_generation_tpu_torch.cli.main --model vqvae
--dataset ljspeech --datadir <corpus> --dim 256 [--device cuda]``
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import Config, load_preset
from neural_sound_generation_tpu_torch.data.pipeline import get_audio_data_loaders
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.ops.vq import data_codebook_init
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import Trainer

AUDIO_DATASETS = ("ljspeech", "cmu_arctic", "jsut", "librivox")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the mel VQ-VAE")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr-rate", type=float, default=1e-3)
    p.add_argument("--dataset", type=str, default="MNIST",
                   choices=["MNIST", "CIFAR10", *AUDIO_DATASETS])
    p.add_argument("--datadir", type=str, default="./data/")
    p.add_argument("--sampledir", type=str, default="./results/")
    p.add_argument("--epochs", type=int, default=3000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=10)
    p.add_argument("--model", type=str, default="vae",
                   choices=["vae", "vqvae", "wavevqvae", "hiervqvae"])
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--dim", type=int, default=1, help="hidden layer width")
    p.add_argument("--z-dim", type=int, default=512)
    p.add_argument("--preset", type=str, default=None)
    p.add_argument("--ckpt-dir", type=str, default="./models")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--speaker-id", type=int, default=None)
    p.add_argument("--max-batches-per-epoch", type=int, default=None)
    p.add_argument("--norm", choices=["batch", "group"], default="batch")
    p.add_argument("--multi-steps", type=int, default=1,
                   help="optimization steps per super-batch")
    p.add_argument("--ema-codebook", action="store_true",
                   help="EMA codebook updates instead of gradient descent")
    p.add_argument("--restart-dead-threshold", type=float, default=0.0,
                   help="re-seed codes whose EMA cluster size drops below "
                        "this (requires --ema-codebook)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute for the conv stacks; parameters, VQ, "
                        "losses and optimizer stay float32")
    p.add_argument("--num-downsample", type=int, default=6,
                   help="wavevqvae stride-2 encoder layers (recorded in the "
                        "checkpoint metadata)")
    p.add_argument("--codebook-init", choices=["uniform", "data"], default="uniform",
                   help="'data' seeds the codebook from train-mode encoder "
                        "outputs of a train batch instead of U(+-1/K)")
    p.add_argument("--num-quantizers", type=int, default=1,
                   help="residual VQ stages (1 = single codebook)")
    p.add_argument("--ema-warmup", action="store_true",
                   help="ramp the parameter-EMA decay as min(decay, "
                        "(1+t)/(10+t)) (TrainConfig.ema_warmup)")
    p.add_argument("--bf16-moments", action="store_true",
                   help="store the fused optimizer's Adam moments in "
                        "bfloat16; the update math stays float32")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def refuse_later_slices(args) -> None:
    """Flags whose code paths the port does not have yet."""
    if args.model != "vqvae":
        raise SystemExit(
            f"--model {args.model}: the port trains the flat mel vqvae; "
            f"vae, hiervqvae and wavevqvae come with the other-autoencoders slice"
        )
    if args.dataset not in AUDIO_DATASETS:
        raise SystemExit(
            f"--dataset {args.dataset}: the image datasets come with the "
            f"other-autoencoders slice"
        )
    if getattr(args, "num_quantizers", 1) < 1:
        raise SystemExit(f"--num-quantizers {args.num_quantizers}: must be at least 1")
    if (args.mesh_data or 1) > 1 or args.mesh_model > 1:
        raise SystemExit("--mesh-*: more than one device comes with the parallel slice")


def build_config(args) -> Config:
    cfg = Config()
    if args.preset:
        cfg = load_preset(args.preset, cfg)
    cfg = cfg.parse_json(
        {"batch_size": args.batch_size, "initial_learning_rate": args.lr_rate}
    )
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            cfg.model,
            model=args.model,
            input_dim=3 if args.dataset == "CIFAR10" else 1,
            dim=args.dim,
            z_dim=args.z_dim,
            beta=args.beta,
            ema_codebook=getattr(args, "ema_codebook", False),
            restart_dead_threshold=getattr(args, "restart_dead_threshold", 0.0),
            num_quantizers=getattr(args, "num_quantizers", 1),
            num_downsample=getattr(args, "num_downsample", 6),
        ),
        train=dataclasses.replace(
            cfg.train,
            seed=args.seed,
            log_interval=args.log_interval,
            nepochs=args.epochs,
            bf16_moments=getattr(args, "bf16_moments", False),
            ema_warmup=getattr(args, "ema_warmup", False),
        ),
    )


def checkpoint_dir(args) -> str:
    # ./models/{model}/checkpoint_{dataset}_{dim}_{z_dim} (main.py:61-66 layout)
    return os.path.join(
        args.ckpt_dir, args.model, f"checkpoint_{args.dataset}_{args.dim}_{args.z_dim}"
    )


def checkpoint_metadata(cfg: Config) -> dict:
    """What every restore surface checks against the checkpoint."""
    return {
        "arch": cfg.model.model,
        "num_quantizers": cfg.model.num_quantizers,
        "num_downsample": cfg.model.num_downsample,
    }


def make_model(cfg: Config, n_speakers: int = 0, norm: str = "batch",
               generator: torch.Generator | None = None,
               dtype: torch.dtype | None = None) -> VQVAE:
    """The flat mel VQ-VAE of ``cfg.model`` (its ``num_quantizers`` residual
    stages) with compute ``dtype`` (float32 by default, bfloat16 under
    ``--bf16``)."""
    mc = cfg.model
    if mc.model != "vqvae":
        raise NotImplementedError(f"--model {mc.model}: not in the port yet")
    gin = cfg.arch.gin_channels if n_speakers > 0 else -1
    return VQVAE(
        input_dim=mc.input_dim, dim=mc.dim, z_dim=mc.z_dim,
        n_speakers=n_speakers if gin > 0 else 0, gin_channels=gin,
        norm=norm, generator=generator, num_quantizers=mc.num_quantizers,
        dtype=dtype or torch.float32,
    )


def audio_loaders(args, cfg: Config, test_shuffle: bool = True):
    loaders = get_audio_data_loaders(
        args.datadir, args.speaker_id, args.batch_size, cfg,
        test_shuffle=test_shuffle, batch_mode="mel", latent_stride=4,
    )
    return loaders["train"], loaders["test"]


def dump_reconstruction(args, cfg: Config, recon: torch.Tensor, epoch: int) -> None:
    """Per-epoch artifacts (main.py:137-220): the reconstruction batch as
    ``.npy`` and a Griffin-Lim ``.wav`` of its last element, with the
    initial phase drawn from a generator seeded with the epoch."""
    sample_dir = os.path.join(args.sampledir, args.dataset)
    os.makedirs(sample_dir, exist_ok=True)
    recon_np = recon.detach().cpu().numpy()
    if recon_np.ndim == 4:
        recon_np = recon_np[..., 0]
    tag = f"{args.model}_data_{args.dataset}_dim_{args.dim}_z_dim_{args.z_dim}_epoch_{epoch}"
    np.save(os.path.join(sample_dir, f"reconstruction_{tag}.npy"), recon_np)
    mel = recon[-1, ..., 0] if recon.ndim == 4 else recon[-1]
    gen = torch.Generator(device=mel.device).manual_seed(epoch)
    with torch.no_grad():
        wav = dsp.inv_mel_spectrogram(mel.detach(), cfg.audio, generator=gen)
    dsp.save_wav(
        wav.cpu().numpy(),
        os.path.join(
            sample_dir,
            f"audio_recon_{tag}_fftsize_{cfg.audio.fft_size}"
            f"_hopsize_{cfg.audio.effective_hop_size}.wav",
        ),
        cfg.audio.sample_rate,
    )


@torch.no_grad()
def apply_data_codebook_init(model: VQVAE, x: torch.Tensor, generator: torch.Generator) -> None:
    """--codebook-init data: replace the codebook with rows drawn from the
    encoder outputs of a train batch, in train mode (batch statistics, as
    training quantizes them) with the running statistics left as they
    were; a residual-VQ (Q, K, D) codebook is seeded stage by stage from the
    residuals. Runs before ``create_train_state`` so the EMA shadows copy
    the seeded rows."""
    model.train()
    with batch_stats_discarded(model):
        z_e = model._encode_latents(x)
    model.codebook.copy_(data_codebook_init(z_e, tuple(model.codebook.shape), generator))
    print(f"codebook seeded from encoder outputs ({tuple(model.codebook.shape)})")


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """Epoch ``e``'s draws depend on (seed, e) alone, so a resumed run
    draws what an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + epoch)


def main(argv=None):
    args = parse_args(argv)
    refuse_later_slices(args)
    device = resolve_device(args.device)
    cfg = build_config(args)

    train_loader, test_loader = audio_loaders(args, cfg)
    sample_batch = next(iter(test_loader))
    n_speakers = cfg.arch.n_speakers if "g" in sample_batch else 0
    model = make_model(
        cfg, n_speakers, norm=args.norm, generator=torch.Generator().manual_seed(args.seed),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    ).to(device)
    if args.codebook_init == "data":
        # a TRAIN batch: a test-seeded codebook would leak held-out data
        warm = next(iter(train_loader))
        apply_data_codebook_init(
            model, torch.from_numpy(warm["x"]).to(device), epoch_generator(args.seed, 0, device)
        )
    state = create_train_state(model, cfg.train, ema_codebook=cfg.model.ema_codebook)

    ckpt_dir = checkpoint_dir(args)
    meta = checkpoint_metadata(cfg)
    start_epoch = 1
    if args.resume and checkpoint.latest_step(ckpt_dir) is not None:
        try:
            checkpoint.check_extra(ckpt_dir, **meta)
            state, extra = checkpoint.restore(ckpt_dir, state)
        except ValueError as e:
            raise SystemExit(str(e)) from e
        start_epoch = int((extra or {}).get("epoch", 0)) + 1
        print(f"Resumed from step {int(state.step)}, epoch {start_epoch}")

    metrics_path = os.path.join(args.sampledir, args.dataset, "metrics.jsonl")
    os.makedirs(os.path.dirname(metrics_path), exist_ok=True)
    trainer = Trainer(model, cfg, state, metrics_path=metrics_path,
                      multi_steps=args.multi_steps)
    print(model)

    last_epoch = start_epoch - 1

    def save(epoch, block=False):
        # per-epoch saves overlap the next epoch (the loop pays the copy to
        # the host); the final save blocks so exit never races a write
        checkpoint.save(ckpt_dir, trainer.state, step=int(trainer.state.step),
                        extra={"epoch": epoch, **meta}, block=block)

    def limit(it):
        if args.max_batches_per_epoch is None:
            return it
        return itertools.islice(it, args.max_batches_per_epoch)

    def interval_ckpt(epoch):
        # the stored epoch is the last COMPLETED one: --resume replays the
        # interrupted epoch with its pinned data order
        def cb(state, step):
            checkpoint.save(ckpt_dir, state, step=int(step),
                            extra={"epoch": epoch - 1, **meta}, block=False)
        return cb

    try:
        for epoch in range(start_epoch, args.epochs + 1):
            # data order is f(seed, epoch): a resumed run sees the batches
            # an uninterrupted run's epoch-N pass would
            train_loader.set_epoch(epoch - 1)
            trainer.train_epoch(limit(iter(train_loader)),
                                epoch_generator(args.seed, epoch, device),
                                epoch=epoch, checkpoint_cb=interval_ckpt(epoch))
            _, recon = trainer.eval_epoch(limit(iter(test_loader)))
            if recon is not None:
                print("Evaluating samples")
                dump_reconstruction(args, cfg, recon, epoch)
            last_epoch = epoch
            save(epoch)
    except KeyboardInterrupt:
        print("Interrupted!")
    finally:
        save(last_epoch, block=True)


if __name__ == "__main__":
    main(sys.argv[1:])

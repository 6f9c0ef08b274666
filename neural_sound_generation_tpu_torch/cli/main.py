"""Training CLI: the VAE and the VQ-VAE families on images and audio.

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

``--model`` picks the family: ``vae`` (the conv VAE, ELBO with MSE),
``vqvae`` (the flat mel VQ-VAE), ``hiervqvae`` (two levels over 8-aligned
mel crops) or ``wavevqvae`` (the raw-waveform model over crops of
2**num_downsample-aligned samples, ``--num-downsample``; the preset's
``input_type`` picks raw, mulaw or mulaw-quantize). ``--dataset`` is one of
the audio corpora or MNIST/CIFAR10 (``data/images.py`` reads the local
idx and pickle files; CIFAR10 makes the input 3 channels).
``--num-quantizers Q`` trains residual VQ with a (Q, K, D) codebook (the
flat and the wave model); ``--bf16`` runs the convolutions of the mel
families in bfloat16 (parameters, VQ, loss and optimizer stay float32, and
the checkpoint is float32). ``--codebook-init data`` seeds the codebook(s)
from train-mode encoder outputs of a train batch; the hierarchy seeds its
top codebook, then its bottom one from a second pass under the seeded top.
``--device`` defaults to the CUDA card.

Data parallelism: under ``torchrun`` (one process per card) the run lays
the mesh's ``data`` axis over the ranks (``--mesh-data N`` must name their
number; without it any world of more than one rank takes them all). Every
rank runs the same seeded loader over the global ``--batch-size`` and
keeps its rows, so a W-rank run computes the one-rank run's steps; rank 0
writes the checkpoints, metrics and samples.

Tensor parallelism (every ``--model``): ``--mesh-model M`` lays a (W / M,
M) mesh over the W ranks (``--mesh-data D`` must then make D x M = W).
Every rank builds the whole model from the seed (and the data-seeded
codebooks), keeps its slices of the leaves JAX's ``_TP_RULES`` shard
(``training.sharding``: the codebooks' rows and the encoder's and
decoder's output channels; the hierarchy's ``decoder`` and two codebooks
only; nothing of the VAE, which each model rank computes whole) and trains
them with kernel 1 on its codebook shards and kernel 3 on its own flat
buffer; the steps are the one-rank steps. Checkpoints hold the whole
tree, so ``--resume`` works at any M and a checkpoint serves without a
mesh.

Run: ``python -m neural_sound_generation_tpu_torch.cli.main --model vqvae
--dataset ljspeech --datadir <corpus> --dim 256 [--device cuda]``, or over
eight cards ``torchrun --standalone --nproc_per_node 8 -m
neural_sound_generation_tpu_torch.cli.main --mesh-data 8 ...``, or 4 x 2
``torchrun --standalone --nproc_per_node 8 -m
neural_sound_generation_tpu_torch.cli.main --model wavevqvae --mesh-data 4
--mesh-model 2 ...`` (``--device cpu`` runs the ranks on the CPU over gloo).
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
from neural_sound_generation_tpu_torch.data.images import (
    image_batches,
    load_cifar10,
    load_mnist,
)
from neural_sound_generation_tpu_torch.models import VAE, VQVAE, HierVQVAE, WaveVQVAE
from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.ops.cuda import fused_adam, vq_kernel
from neural_sound_generation_tpu_torch.ops.vq import data_codebook_init
from neural_sound_generation_tpu_torch.parallel import (
    mesh_from_args,
    primary_print,
    process_group,
    shard_batch,
)
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.sharding import shard_train_state
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import Trainer

AUDIO_DATASETS = ("ljspeech", "cmu_arctic", "jsut", "librivox")
IMAGE_DATASETS = ("MNIST", "CIFAR10")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a VAE or a VQ-VAE")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr-rate", type=float, default=1e-3)
    p.add_argument("--dataset", type=str, default="MNIST",
                   choices=[*IMAGE_DATASETS, *AUDIO_DATASETS])
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
    """Flags the port refuses before it starts: a stage count below one."""
    if getattr(args, "num_quantizers", 1) < 1:
        raise SystemExit(f"--num-quantizers {args.num_quantizers}: must be at least 1")


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
               dtype: torch.dtype | None = None):
    """The ``cfg.model.model`` family at ``cfg.model``'s widths, weights
    from ``generator``. ``dtype`` (float32 by default, bfloat16 under
    ``--bf16``) is the compute dtype of the mel VQ families; the VAE and the
    wave model run float32, as in the JAX package. The hierarchy takes no
    speakers."""
    mc = cfg.model
    dtype = dtype or torch.float32
    if mc.model == "vae":
        return VAE(input_dim=mc.input_dim, dim=mc.dim, z_dim=mc.z_dim, generator=generator)
    if mc.model == "hiervqvae":
        return HierVQVAE(input_dim=mc.input_dim, dim=mc.dim, z_dim=mc.z_dim, norm=norm,
                         generator=generator, dtype=dtype)
    gin = cfg.arch.gin_channels if n_speakers > 0 else -1
    if mc.model == "wavevqvae":
        return WaveVQVAE(
            dim=mc.dim, z_dim=mc.z_dim, num_downsample=mc.num_downsample,
            input_type=cfg.audio.input_type, quantize_channels=cfg.audio.quantize_channels,
            n_speakers=n_speakers if gin > 0 else 0, gin_channels=gin,
            num_quantizers=mc.num_quantizers, generator=generator,
        )
    return VQVAE(
        input_dim=mc.input_dim, dim=mc.dim, z_dim=mc.z_dim,
        n_speakers=n_speakers if gin > 0 else 0, gin_channels=gin,
        norm=norm, generator=generator, num_quantizers=mc.num_quantizers, dtype=dtype,
    )


def audio_loaders(args, cfg: Config, test_shuffle: bool = True):
    """Train and test loaders over an audio corpus: waveform crops for
    wavevqvae, mel crops otherwise, cropped to a multiple of 8 frames for
    the hierarchy (its top grid has stride 8) and of 4 for the rest."""
    loaders = get_audio_data_loaders(
        args.datadir, args.speaker_id, args.batch_size, cfg,
        test_shuffle=test_shuffle,
        batch_mode="wave" if args.model == "wavevqvae" else "mel",
        latent_stride=8 if args.model == "hiervqvae" else 4,
    )
    return loaders["train"], loaders["test"]


def image_loaders(args):
    """``(train_iter(epoch), test_iter())`` over MNIST or CIFAR-10 read from
    ``--datadir``: batches ``{"x": (B, H, W, C) in [-1, 1], "label"}``,
    the train order a function of the epoch, the test order fixed."""
    load = load_mnist if args.dataset == "MNIST" else load_cifar10
    train_x, train_y = load(args.datadir, train=True)
    test_x, test_y = load(args.datadir, train=False)

    def train_iter(epoch):
        return image_batches(train_x, train_y, args.batch_size, seed=epoch)

    def test_iter():
        return image_batches(test_x, test_y, args.batch_size, seed=0, shuffle=False)

    return train_iter, test_iter


def _wave_artifact(cfg: Config, recon: torch.Tensor) -> np.ndarray:
    """The last reconstruction of a wave batch as a waveform: the argmax of
    mulaw-quantize logits decoded, or the scalar output (inverse mu-law
    under mulaw). The branch follows the configured head, not the shape."""
    a = cfg.audio
    if a.is_mulaw_quantize:
        return dsp.inv_mulaw_quantize(recon[-1].argmax(-1), a.quantize_channels).cpu().numpy()
    wav = recon[-1].reshape(-1)
    if a.is_mulaw:
        wav = dsp.inv_mulaw(wav, a.quantize_channels)
    return wav.cpu().numpy()


def dump_reconstruction(args, cfg: Config, recon: torch.Tensor, epoch: int) -> None:
    """Per-epoch artifacts (main.py:137-220): the reconstruction batch as
    ``.npy``; for wavevqvae the last element as a ``.wav``; for the mel
    models on an audio corpus a Griffin-Lim ``.wav`` of the last element,
    with the initial phase drawn from a generator seeded with the epoch.
    Image datasets get the ``.npy`` alone."""
    sample_dir = os.path.join(args.sampledir, args.dataset)
    os.makedirs(sample_dir, exist_ok=True)
    recon = recon.detach()
    recon_np = recon.cpu().numpy()
    if recon_np.ndim == 4:
        recon_np = recon_np[..., 0]
    tag = f"{args.model}_data_{args.dataset}_dim_{args.dim}_z_dim_{args.z_dim}_epoch_{epoch}"
    np.save(os.path.join(sample_dir, f"reconstruction_{tag}.npy"), recon_np)
    if args.model == "wavevqvae":
        dsp.save_wav(_wave_artifact(cfg, recon), os.path.join(sample_dir, f"audio_recon_{tag}.wav"),
                     cfg.audio.sample_rate)
        return
    if args.dataset not in AUDIO_DATASETS:
        return
    mel = recon[-1, ..., 0] if recon.ndim == 4 else recon[-1]
    gen = torch.Generator(device=mel.device).manual_seed(epoch)
    with torch.no_grad():
        wav = dsp.inv_mel_spectrogram(mel, cfg.audio, generator=gen)
    dsp.save_wav(
        wav.cpu().numpy(),
        os.path.join(
            sample_dir,
            f"audio_recon_{tag}_fftsize_{cfg.audio.fft_size}"
            f"_hopsize_{cfg.audio.effective_hop_size}.wav",
        ),
        cfg.audio.sample_rate,
    )


def _seed_codebook(param: torch.nn.Parameter, z_e: torch.Tensor, generator, name: str) -> None:
    param.copy_(data_codebook_init(z_e, tuple(param.shape), generator))
    print(f"{name} seeded from encoder outputs ({tuple(param.shape)})")


@torch.no_grad()
def apply_data_codebook_init(model, x: torch.Tensor, generator: torch.Generator) -> None:
    """--codebook-init data: replace the codebook(s) with rows drawn from
    the encoder outputs of a train batch, in train mode (batch statistics,
    as training quantizes them) with the running statistics left as they
    were; a residual-VQ (Q, K, D) codebook is seeded stage by stage from the
    residuals. The hierarchy takes two passes: its bottom z_e depends on
    the decoded top codes, so the top codebook is seeded from the first
    pass's z_e_top and the bottom one from a second pass's z_e_bottom,
    under the seeded top (each pass runs both levels' searches). Runs
    before ``create_train_state`` so the EMA shadows copy the seeded rows."""
    model.train()
    if isinstance(model, HierVQVAE):
        with batch_stats_discarded(model):
            z_e_top = model.levels(x)[0][1]
        _seed_codebook(model.codebook_top, z_e_top, generator, "codebook_top")
        with batch_stats_discarded(model):
            z_e_bottom = model.levels(x)[1][1]
        _seed_codebook(model.codebook_bottom, z_e_bottom, generator, "codebook_bottom")
        return
    if isinstance(model, WaveVQVAE):
        with batch_stats_discarded(model):
            z_e = model.encode_latents(x)
    elif isinstance(model, VQVAE):
        with batch_stats_discarded(model):
            z_e = model._encode_latents(x)
    else:
        raise SystemExit("--codebook-init data supports the vqvae/wavevqvae/hiervqvae families")
    _seed_codebook(model.codebook, z_e, generator, "codebook")


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    """Epoch ``e``'s draws depend on (seed, e) alone, so a resumed run
    draws what an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + epoch)


def main(argv=None):
    args = parse_args(argv)
    refuse_later_slices(args)
    with process_group(args.device):
        train(args)


def train(args) -> None:
    """The training run of ``main`` inside its process group."""
    mesh = mesh_from_args(args.mesh_data, args.mesh_model, args.batch_size)
    device = resolve_device(args.device)
    say = primary_print(mesh)
    if mesh is not None:
        mesh.build_first(device, vq_kernel, fused_adam)
    cfg = build_config(args)

    audio_mode = args.dataset in AUDIO_DATASETS
    if audio_mode:
        train_loader, test_loader = audio_loaders(args, cfg)
        sample_batch = next(iter(test_loader))
        n_speakers = cfg.arch.n_speakers if "g" in sample_batch else 0
    else:
        train_iter, test_iter = image_loaders(args)
        n_speakers = 0
    model = make_model(
        cfg, n_speakers, norm=args.norm, generator=torch.Generator().manual_seed(args.seed),
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
    ).to(device)
    if args.codebook_init == "data":
        # a TRAIN batch: a test-seeded codebook would leak held-out data.
        # The whole global batch on every rank, no collective: every rank
        # seeds what the one-rank run seeds (the JAX CLI seeds from the
        # unsharded batch too)
        warm = next(iter(train_loader)) if audio_mode else next(train_iter(0))
        apply_data_codebook_init(
            model, torch.from_numpy(warm["x"]).to(device), epoch_generator(args.seed, 0, device)
        )
    state = create_train_state(model, cfg.train, ema_codebook=cfg.model.ema_codebook)
    if mesh is not None and mesh.tensor_parallel:
        # this rank's slices of the whole state every rank built alike
        state = shard_train_state(state, mesh)

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
        say(f"Resumed from step {int(state.step)}, epoch {start_epoch}")
    if mesh is not None:
        mesh.replicate(state)

    metrics_path = os.path.join(args.sampledir, args.dataset, "metrics.jsonl")
    os.makedirs(os.path.dirname(metrics_path), exist_ok=True)
    trainer = Trainer(model, cfg, state, metrics_path=metrics_path,
                      multi_steps=args.multi_steps, mesh=mesh)
    say(model)

    last_epoch = start_epoch - 1

    def save(epoch, block=False):
        # per-epoch saves overlap the next epoch (the loop pays the copy to
        # the host); the final save blocks so exit never races a write
        checkpoint.save(ckpt_dir, trainer.state, step=int(trainer.state.step),
                        extra={"epoch": epoch, **meta}, block=block)

    def limit(it):
        # this rank's rows of each global batch
        if args.max_batches_per_epoch is not None:
            it = itertools.islice(it, args.max_batches_per_epoch)
        return (shard_batch(b, mesh) for b in it)

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
            if audio_mode:
                train_loader.set_epoch(epoch - 1)
                batches, test_batches = iter(train_loader), iter(test_loader)
            else:
                batches, test_batches = train_iter(epoch), test_iter()
            trainer.train_epoch(limit(batches), epoch_generator(args.seed, epoch, device),
                                epoch=epoch, checkpoint_cb=interval_ckpt(epoch))
            _, recon = trainer.eval_epoch(limit(test_batches))
            if recon is not None and (mesh is None or mesh.is_primary):
                say("Evaluating samples")
                dump_reconstruction(args, cfg, recon, epoch)
            last_epoch = epoch
            save(epoch)
    except KeyboardInterrupt:
        say("Interrupted!")
    finally:
        save(last_epoch, block=True)


if __name__ == "__main__":
    main(sys.argv[1:])

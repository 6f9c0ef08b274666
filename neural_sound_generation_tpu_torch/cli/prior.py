"""Prior training and sampling CLI.

Counterpart of ``neural_sound_generation_tpu/cli/prior.py`` for ``--arch
transformer``, with its flags and defaults. ``train`` encodes a
preprocessed corpus into code grids with a trained VQ-VAE (a ``cli.main``
checkpoint; the nearest-code kernel on the card) and fits the
class-conditioned ``TransformerPrior`` by cross-entropy through the
``Trainer`` (the flash-attention kernels forward and backward, the fused
Adam kernel). ``sample`` draws code grids with the KV-cached sampler and
decodes them to audio through the VQ-VAE and Griffin-Lim.

Checkpoints follow the JAX CLI's layout: ``--ckpt-dir`` holds the sampling
artifact (parameters only), ``<ckpt-dir>_ema`` the averaged model and
``<ckpt-dir>_train`` the full train state that ``--resume`` continues. Each
records ``arch``, ``prior_dim``, ``prior_layers``, ``prior_heads``,
``z_dim`` and ``n_classes``, and ``sample`` and ``serve --prior-ckpt``
refuse a checkpoint that disagrees: the qkv weights have the same shape for
any head count, so a wrong ``--prior-heads`` would otherwise restore and
sample wrongly.

Flags of later slices raise ``NotImplementedError``: ``--arch pixelcnn``,
``--hier``, ``--moe-experts``, ``--bf16``, ``--mesh-pipe`` and more than one
device. The flags that only those paths read (``--pp-microbatches``,
``--hier-level``, ``--bottom-*``) come with them.

Run: ``python -m neural_sound_generation_tpu_torch.cli.prior train
--arch transformer --datadir <corpus> --vqvae-ckpt <cli.main checkpoint>
[--device cuda]``
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import Config, load_preset
from neural_sound_generation_tpu_torch.data.pipeline import get_audio_data_loaders
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.inference import sample_prior_audio
from neural_sound_generation_tpu_torch.models import VQVAE, TransformerPrior
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import Trainer

#: the encoder's downsampling of both mel axes
LATENT_STRIDE = 4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train/sample the prior")
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train")
    tr.add_argument("--datadir", required=True, help="preprocessed corpus dir")
    tr.add_argument("--vqvae-ckpt", required=True, help="cli.main checkpoint directory")
    tr.add_argument("--ckpt-dir", default="./models/prior")
    tr.add_argument("--preset", default=None, help="hparams preset JSON")
    tr.add_argument("--dim", type=int, default=256, help="vqvae hidden width")
    tr.add_argument("--z-dim", type=int, default=512, help="codebook size")
    tr.add_argument("--arch", choices=["pixelcnn", "transformer"], default="pixelcnn",
                    help="prior family (the port has the transformer)")
    tr.add_argument("--prior-dim", type=int, default=64)
    tr.add_argument("--prior-layers", type=int, default=15)
    tr.add_argument("--prior-heads", type=int, default=None,
                    help="attention heads; default sizes heads to 64 channels each")
    tr.add_argument("--bf16", action="store_true", help="bfloat16 compute (a later slice)")
    tr.add_argument("--moe-experts", type=int, default=0,
                    help="switch-MoE feed-forwards (a later slice)")
    tr.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint: the *_train sibling's "
                         "full state, else the artifact's parameters and EMA")
    tr.add_argument("--n-classes", type=int, default=10)
    tr.add_argument("--batch-size", type=int, default=32)
    tr.add_argument("--epochs", type=int, default=10)
    tr.add_argument("--lr", type=float, default=3e-4)
    tr.add_argument("--max-batches-per-epoch", type=int, default=None)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--mesh-data", type=int, default=None)
    tr.add_argument("--mesh-model", type=int, default=1)
    tr.add_argument("--mesh-pipe", type=int, default=1,
                    help="pipeline-parallel stages (a later slice)")
    tr.add_argument("--multi-steps", type=int, default=1,
                    help="optimization steps per super-batch")
    tr.add_argument("--ema-warmup", action="store_true",
                    help="ramp the EMA decay min(decay, (1+t)/(10+t))")
    tr.add_argument("--hier", action="store_true",
                    help="two-level hiervqvae checkpoint (a later slice)")
    tr.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, cuda:N or cpu)")

    sa = sub.add_parser("sample")
    sa.add_argument("--vqvae-ckpt", required=True)
    sa.add_argument("--prior-ckpt", required=True)
    sa.add_argument("--output-dir", default="./results/prior")
    sa.add_argument("--preset", default=None)
    sa.add_argument("--dim", type=int, default=256)
    sa.add_argument("--z-dim", type=int, default=512)
    sa.add_argument("--arch", choices=["pixelcnn", "transformer"], default="pixelcnn")
    sa.add_argument("--prior-dim", type=int, default=64)
    sa.add_argument("--prior-layers", type=int, default=15)
    sa.add_argument("--prior-heads", type=int, default=None)
    sa.add_argument("--bf16", action="store_true")
    sa.add_argument("--moe-experts", type=int, default=0)
    sa.add_argument("--n-classes", type=int, default=10)
    sa.add_argument("--code-shape", type=int, nargs=2, default=[20, 28])
    sa.add_argument("--num-samples", type=int, default=4)
    sa.add_argument("--label", type=int, default=0)
    sa.add_argument("--seed", type=int, default=0)
    sa.add_argument("--hier", action="store_true",
                    help="sample the two-level chain (a later slice)")
    sa.add_argument("--device", default="cuda",
                    help="torch device to sample on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def refuse_later_slices(args) -> None:
    """Flags whose code paths the port does not have yet."""
    if args.arch != "transformer":
        raise NotImplementedError(
            "--arch pixelcnn: the GatedPixelCNN prior comes with the PixelCNN slice of the port")
    if args.hier:
        raise NotImplementedError("--hier: the hierarchical chain comes with a later slice")
    if args.moe_experts > 0:
        raise NotImplementedError("--moe-experts: switch-MoE priors come with the MoE slice")
    if args.bf16:
        raise NotImplementedError("--bf16: the prior's bfloat16 model comes with the bf16 slice")
    if getattr(args, "mesh_pipe", 1) > 1:
        raise NotImplementedError("--mesh-pipe: pipeline parallelism comes with the parallel slice")
    if (getattr(args, "mesh_data", None) or 1) > 1 or getattr(args, "mesh_model", 1) > 1:
        raise NotImplementedError("--mesh-*: more than one device comes with the parallel slice")


@dataclasses.dataclass(frozen=True)
class PriorSpec:
    """What a prior checkpoint was built with; ``metadata()`` is what its
    ``_extra.json`` records and every restore checks."""

    arch: str
    z_dim: int
    prior_dim: int
    prior_layers: int
    prior_heads: int
    n_classes: int

    @classmethod
    def from_args(cls, args) -> "PriorSpec":
        heads = args.prior_heads or max(1, args.prior_dim // 64)
        return cls(args.arch, args.z_dim, args.prior_dim, args.prior_layers, heads,
                   args.n_classes)

    def metadata(self) -> dict:
        return dataclasses.asdict(self)

    def build(self, seed: int = 0) -> TransformerPrior:
        if self.arch != "transformer":
            raise NotImplementedError(
                f"--arch {self.arch}: the port has the transformer prior; the GatedPixelCNN "
                f"comes with the PixelCNN slice")
        return TransformerPrior(
            input_dim=self.z_dim, dim=self.prior_dim, n_layers=self.prior_layers,
            n_heads=self.prior_heads, n_classes=self.n_classes,
            generator=torch.Generator().manual_seed(seed),
        )


def load_prior(ckpt_dir: str, spec: PriorSpec, device) -> TransformerPrior:
    """The prior of a checkpoint (an artifact, its ``_ema`` sibling or a
    train state), in eval mode on ``device``; refuses one recorded with
    another spec."""
    prior = spec.build()
    try:
        checkpoint.check_extra(ckpt_dir, **spec.metadata())
        checkpoint.restore_params(ckpt_dir, prior)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    return prior.to(device).eval()


def long_t_warning(arch: str, codes_shape, threshold: int = 1024):
    """A steer (or None) for transformer priors over long code grids: the
    JAX package measured causal attention at T = 2240 an order of
    magnitude slower than the PixelCNN on its TPU; on the card it is not
    measured. Long grids still train."""
    h, w = int(codes_shape[1]), int(codes_shape[2])
    if arch != "transformer" or h * w < threshold:
        return None
    return (
        f"WARNING: transformer prior over a {h}x{w} code grid (T={h * w}): causal "
        f"attention cost grows as T^2; the reference measured --arch pixelcnn an order "
        f"of magnitude faster at bottom-level grids"
    )


def _prior_cfg(args) -> Config:
    cfg = Config()
    if args.preset:
        cfg = load_preset(args.preset, cfg)
    return cfg


def load_vqvae(args, cfg: Config, device) -> VQVAE:
    """The ``--vqvae-ckpt`` model (live parameters and running statistics)
    in eval mode on ``device``; speaker-conditioned when the preset says so."""
    from neural_sound_generation_tpu_torch.cli.serve import restore_weights

    gin = cfg.arch.gin_channels
    n_speakers = cfg.arch.n_speakers if gin > 0 else 0
    model = VQVAE(1, args.dim, args.z_dim, n_speakers=n_speakers,
                  gin_channels=gin if n_speakers else -1)
    restore_weights(model, cfg, args.vqvae_ckpt, ema=False)
    return model.to(device).eval()


def cmd_train(args) -> None:
    refuse_later_slices(args)
    device = resolve_device(args.device)
    cfg = _prior_cfg(args)
    loaders = get_audio_data_loaders(args.datadir, None, args.batch_size, cfg,
                                     latent_stride=LATENT_STRIDE)
    vqvae = load_vqvae(args, cfg, device)
    spec = PriorSpec.from_args(args)
    meta = spec.metadata()
    prior = spec.build(args.seed).to(device)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, initial_learning_rate=args.lr, batch_size=args.batch_size,
        ema_warmup=args.ema_warmup))
    state = create_train_state(prior, cfg.train)

    start_epoch = 1
    train_dir = args.ckpt_dir.rstrip("/") + "_train"
    if args.resume:
        try:
            if checkpoint.latest_step(train_dir) is not None:
                # params, Adam moments, step and EMA all continue
                checkpoint.check_extra(train_dir, **meta)
                state, extra = checkpoint.restore(train_dir, state)
                start_epoch = int((extra or {}).get("epoch", 0)) + 1
                print(f"resumed train state from step {int(state.step)}, epoch {start_epoch}")
            elif checkpoint.latest_step(args.ckpt_dir) is not None:
                # an artifact alone: params and the EMA sibling resume, the
                # step lands in the state, Adam's moments restart
                at = checkpoint.latest_step(args.ckpt_dir)
                checkpoint.check_extra(args.ckpt_dir, **meta)
                extra = checkpoint.restore_params(args.ckpt_dir, prior)
                state.step.fill_(at)
                checkpoint.restore_ema_sibling(args.ckpt_dir, state)
                start_epoch = int((extra or {}).get("epoch", 0)) + 1
                print(f"resumed params from step {at}, epoch {start_epoch} (no *_train "
                      f"sibling: Adam moments restart)")
        except ValueError as e:
            raise SystemExit(str(e)) from e

    trainer = Trainer(prior, cfg, state, log_fn=None, multi_steps=args.multi_steps)
    warned = []

    def epoch_batches():
        for i, batch in enumerate(loaders["train"]):
            if args.max_batches_per_epoch and i >= args.max_batches_per_epoch:
                break
            with torch.no_grad():
                codes = vqvae.encode(torch.from_numpy(batch["x"]).to(device))
            if not warned:
                warned.append(True)
                warning = long_t_warning(args.arch, codes.shape)
                if warning:
                    print(warning)
            labels = np.asarray(batch.get("g", np.zeros(codes.shape[0])), np.int32)
            yield {"codes": codes, "labels": torch.from_numpy(labels).to(device)}

    def save_ckpt(state, step, completed_epoch):
        # completed_epoch is the last FINISHED epoch: an interval save inside
        # epoch N stores N-1, so --resume replays epoch N with its data order
        extra = {"epoch": completed_epoch, **meta}
        checkpoint.save_params(args.ckpt_dir, state.model, step, extra)
        checkpoint.save_ema_sibling(args.ckpt_dir, state, step, extra)
        checkpoint.save(train_dir, state, step, extra, block=False)

    for epoch in range(start_epoch, args.epochs + 1):
        # the data order is f(seed, epoch): --resume replays what an
        # uninterrupted run's epoch N would see
        loaders["train"].set_epoch(epoch - 1)
        means = trainer.train_epoch(
            epoch_batches(), epoch=epoch,
            checkpoint_cb=lambda s, st, e=epoch: save_ckpt(s, st, completed_epoch=e - 1),
        )
        nll = means.get("loss", float("nan"))
        print(f"prior epoch {epoch}: nll/code {nll:.4f} (ppl {np.exp(nll):.1f} of {args.z_dim})")
        save_ckpt(trainer.state, int(trainer.state.step), completed_epoch=epoch)
    checkpoint.wait_for_pending()
    print(f"prior saved to {args.ckpt_dir}")
    if trainer.state.ema_params is not None:
        print(f"averaged-model (EMA) artifact saved to {args.ckpt_dir.rstrip('/')}_ema")


def cmd_sample(args) -> None:
    refuse_later_slices(args)
    device = resolve_device(args.device)
    cfg = _prior_cfg(args)
    h, w = args.code_shape
    vqvae = load_vqvae(args, cfg, device)
    prior = load_prior(args.prior_ckpt, PriorSpec.from_args(args), device)
    labels = torch.full((args.num_samples,), args.label, dtype=torch.int32, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    # a speaker-conditioned decoder takes the class label as the speaker id
    g = labels if vqvae.speakered else None
    _, wavs = sample_prior_audio(vqvae, prior, labels, (h, w), cfg.audio, generator, g=g)
    os.makedirs(args.output_dir, exist_ok=True)
    wavs = wavs.cpu().numpy()
    for i in range(args.num_samples):
        path = os.path.join(args.output_dir, f"prior_sample_{i:03d}.wav")
        dsp.save_wav(wavs[i], path, cfg.audio.sample_rate)
    print(f"wrote {args.num_samples} samples to {args.output_dir}")


def main(argv=None):
    args = parse_args(argv)
    {"train": cmd_train, "sample": cmd_sample}[args.cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])

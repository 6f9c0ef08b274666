"""Prior training and sampling CLI.

Counterpart of ``neural_sound_generation_tpu/cli/prior.py``, with its
flags and defaults. ``train`` encodes a preprocessed corpus into code grids
with a trained VQ-VAE (a ``cli.main`` checkpoint; the nearest-code kernel
on the card) and fits a class-conditioned prior by cross-entropy through
the ``Trainer`` (the fused Adam kernel): the ``GatedPixelCNN`` (``--arch
pixelcnn``, the default; cuDNN's masked convolutions) or the
``TransformerPrior`` (the flash-attention kernels forward and backward),
whose MLPs ``--moe-experts N`` makes switch-routed mixtures of N experts
(capacity factor 1.25, the JAX CLI's; the loss adds 0.01 times the
load-balance term, which the epoch line prints).
``sample`` draws code grids (the PixelCNN's row-cached sampler, the
transformer's KV-cached one) and decodes them to audio through the VQ-VAE
and Griffin-Lim.

``--hier`` trains on a two-level ``HierVQVAE`` checkpoint (``cli.main
--model hiervqvae``; crops at stride 8, both levels searched per batch):
``--hier-level top`` fits an unconditioned prior over the top grid,
``--hier-level bottom`` a spatially conditioned one over the bottom grid,
whose conditioning map is the top codes' codebook vectors upsampled x2
(``inference.hier_cond_map``). ``sample --hier`` runs the chain: the top
prior (``--prior-ckpt``, ``--arch``/``--prior-*``), the bottom one
(``--bottom-ckpt``, ``--bottom-*`` overriding the top's flags) on a grid
twice ``--code-shape``, the decoder, Griffin-Lim.

Checkpoints follow the JAX CLI's layout: ``--ckpt-dir`` holds the sampling
artifact (parameters only), ``<ckpt-dir>_ema`` the averaged model and
``<ckpt-dir>_train`` the full train state that ``--resume`` continues. Each
records ``arch``, ``prior_dim``, ``prior_layers``, ``prior_heads`` and
``n_experts`` (both 0 for the PixelCNN), ``z_dim``, ``n_classes``,
``spatial_cond`` and ``cond_dim``, and ``sample`` and ``serve --prior-ckpt`` refuse a
checkpoint that disagrees: the qkv weights have the same shape for any
head count, so a wrong ``--prior-heads`` would otherwise restore and
sample wrongly, and a bottom prior is refused where a top is expected.

``--bf16`` computes either family in bfloat16 (``train``, ``sample`` and
both levels of ``sample --hier``): the parameters, the optimizer, the loss
and the checkpoints stay float32, so the compute dtype is not recorded and
a checkpoint trained with or without ``--bf16`` samples either way, as in
the JAX CLI. The transformer's attention kernels run in bf16 on the card.

``train`` runs data-parallel under ``torchrun`` (``--mesh-data N``, the
policy of ``cli.main``): every rank reads the same seeded batches, encodes
its rows of each and trains on them, and rank 0 writes the checkpoints.
``--mesh-model M`` trains either prior (either dtype, either ``--hier``
level) over a (W / M, M) mesh: the ranks of a model group hold the same
rows and a slice each of the layers (``training.sharding``: for the
transformer Megatron's layout, the experts split over the ranks; for the
PixelCNN its convolutions and embeddings, each gate split block-wise so
that a rank gates its own channels), placed after any ``--resume``
restore; the checkpoints stay whole, gathered for rank 0, so ``sample``,
``serve --prior-ckpt`` and ``--resume`` at any M read them. ``--mesh-pipe
S`` (``--arch transformer``; ``--prior-layers`` divisible by S) trains
GPipe over a (W / S, S) mesh, ``--pp-microbatches M`` (default S)
microbatches a step (``parallel.pipeline``, the lifecycle of
``cli._pp``): each rank holds its stage's blocks and their moments, the
routed prior's load-balance term is collected across stages, and the
checkpoints are dense (``<ckpt-dir>_pp_train`` holds the state that
``--resume`` continues at any pipe width; without it the artifact and its
EMA sibling). ``--mesh-model`` with ``--mesh-pipe`` refuses: JAX's pipe
path lays no model axis.

Run: ``python -m neural_sound_generation_tpu_torch.cli.prior train
--datadir <corpus> --vqvae-ckpt <cli.main checkpoint> [--arch transformer
[--moe-experts N]] [--bf16] [--hier --hier-level top|bottom] [--device cuda]``
(``torchrun --nproc_per_node 2 -m ... train --mesh-model 2 ...`` for one
data rank of two model ranks; ``torchrun --nproc_per_node 4 -m ... train
--arch transformer --mesh-pipe 2 ...`` for two data rows of two stages)
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
from neural_sound_generation_tpu_torch.inference import (
    hier_cond_map,
    sample_hier_audio,
    sample_prior_audio,
)
from neural_sound_generation_tpu_torch.models import (
    VQVAE,
    GatedPixelCNN,
    HierVQVAE,
    TransformerPrior,
)
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.ops.cuda import flash_attention, fused_adam, vq_kernel
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

#: the encoder's downsampling of both mel axes (the hierarchy's top grid:
#: twice this)
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
                    help="prior family: the GatedPixelCNN or the causal-attention "
                         "TransformerPrior")
    tr.add_argument("--prior-dim", type=int, default=64)
    tr.add_argument("--prior-layers", type=int, default=15)
    tr.add_argument("--prior-heads", type=int, default=None,
                    help="attention heads; default sizes heads to 64 channels each")
    tr.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (parameters, optimizer and checkpoints stay "
                         "float32)")
    tr.add_argument("--moe-experts", type=int, default=0,
                    help="transformer arch only: switch-MoE feed-forwards with this many "
                         "experts (0 = dense)")
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
                    help="pipeline-parallel stages (GPipe; --arch transformer)")
    tr.add_argument("--pp-microbatches", type=int, default=None,
                    help="pipeline microbatches a step (default: --mesh-pipe)")
    tr.add_argument("--multi-steps", type=int, default=1,
                    help="optimization steps per super-batch")
    tr.add_argument("--ema-warmup", action="store_true",
                    help="ramp the EMA decay min(decay, (1+t)/(10+t))")
    tr.add_argument("--hier", action="store_true",
                    help="--vqvae-ckpt is a two-level hiervqvae checkpoint")
    tr.add_argument("--hier-level", choices=["top", "bottom"], default="top",
                    help="which level's prior to train (bottom is spatially conditioned "
                         "on the top codes)")
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
    sa.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute of the prior (both levels under --hier)")
    sa.add_argument("--moe-experts", type=int, default=0,
                    help="experts of a routed transformer prior (cli.prior train "
                         "--moe-experts); the --hier bottom level takes it too")
    sa.add_argument("--n-classes", type=int, default=10)
    sa.add_argument("--code-shape", type=int, nargs=2, default=[20, 28])
    sa.add_argument("--num-samples", type=int, default=4)
    sa.add_argument("--label", type=int, default=0)
    sa.add_argument("--seed", type=int, default=0)
    sa.add_argument("--hier", action="store_true",
                    help="sample the two-level chain; --prior-ckpt is the top prior, "
                         "--bottom-ckpt the conditional bottom, --code-shape the top grid")
    sa.add_argument("--bottom-ckpt", default=None)
    sa.add_argument("--bottom-arch", choices=["pixelcnn", "transformer"], default=None,
                    help="bottom prior family (default: --arch)")
    sa.add_argument("--bottom-dim", type=int, default=None,
                    help="bottom prior width (default: --prior-dim)")
    sa.add_argument("--bottom-layers", type=int, default=None,
                    help="bottom prior depth (default: --prior-layers)")
    sa.add_argument("--bottom-heads", type=int, default=None,
                    help="bottom attention heads (default: --prior-heads)")
    sa.add_argument("--device", default="cuda",
                    help="torch device to sample on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def check_pipe_flags(args) -> None:
    """JAX's refusals of the pipe path (``_train_pp``), before anything is
    read: the PixelCNN's layers are not a uniform stack, the layers must
    stage evenly; and ``--mesh-model`` with ``--mesh-pipe``."""
    from neural_sound_generation_tpu_torch.cli._pp import refuse_model_and_pipe

    refuse_model_and_pipe(args)
    n_pipe = getattr(args, "mesh_pipe", 1)
    if n_pipe <= 1:
        return
    if args.arch != "transformer":
        raise SystemExit("--mesh-pipe stages the transformer prior's uniform block stack; use "
                         "--arch transformer (the pixelcnn layers are not a uniform stack)")
    if args.prior_layers % n_pipe:
        raise SystemExit(f"--prior-layers {args.prior_layers} does not stage evenly over "
                         f"--mesh-pipe {n_pipe}")


@dataclasses.dataclass(frozen=True)
class PriorSpec:
    """What a prior checkpoint was built with; ``metadata()`` is what its
    ``_extra.json`` records and every restore checks. Build one with
    ``create``, which records no head count and no experts for the
    PixelCNN."""

    arch: str
    z_dim: int
    prior_dim: int
    prior_layers: int
    prior_heads: int
    n_classes: int
    spatial_cond: bool = False
    cond_dim: int = 0
    n_experts: int = 0

    @classmethod
    def create(cls, arch: str, z_dim: int, prior_dim: int, prior_layers: int,
               prior_heads: int | None, n_classes: int, cond_dim: int = 0,
               n_experts: int = 0) -> "PriorSpec":
        """``cond_dim`` > 0: a spatially conditioned (bottom-level) prior.
        ``prior_heads`` None sizes the transformer's heads to 64 channels;
        ``n_experts`` > 0 routes its MLPs (the transformer's alone, as the
        JAX ``_build_prior`` passes it)."""
        transformer = arch == "transformer"
        heads = (prior_heads or max(1, prior_dim // 64)) if transformer else 0
        return cls(arch, z_dim, prior_dim, prior_layers, heads, n_classes, cond_dim > 0,
                   cond_dim, n_experts if transformer else 0)

    @classmethod
    def from_args(cls, args, cond_dim: int = 0) -> "PriorSpec":
        return cls.create(args.arch, args.z_dim, args.prior_dim, args.prior_layers,
                          args.prior_heads, args.n_classes, cond_dim, args.moe_experts)

    def metadata(self) -> dict:
        return dataclasses.asdict(self)

    def build(self, seed: int = 0,
              dtype: torch.dtype = torch.float32) -> TransformerPrior | GatedPixelCNN:
        """The model, its weights drawn from ``seed``, computing in
        ``dtype``; the dtype is not part of the spec (float32 parameters
        either way)."""
        gen = torch.Generator().manual_seed(seed)
        if self.arch == "transformer":
            return TransformerPrior(
                input_dim=self.z_dim, dim=self.prior_dim, n_layers=self.prior_layers,
                n_heads=self.prior_heads, n_classes=self.n_classes, n_experts=self.n_experts,
                spatial_cond=self.spatial_cond, cond_dim=self.cond_dim, dtype=dtype,
                generator=gen)
        return GatedPixelCNN(
            input_dim=self.z_dim, dim=self.prior_dim, n_layers=self.prior_layers,
            n_classes=self.n_classes, spatial_cond=self.spatial_cond, cond_dim=self.cond_dim,
            dtype=dtype, generator=gen)


def compute_dtype(args) -> torch.dtype:
    """``--bf16``'s compute dtype."""
    return torch.bfloat16 if args.bf16 else torch.float32


def bottom_args(args):
    """The sample-time bottom prior's flags: ``--bottom-*`` overriding the
    top's ``--arch``/``--prior-*``; the rest, ``--moe-experts`` and
    ``--bf16`` among them, carry over (the JAX ``_bottom_args``)."""
    overrides = {"arch": args.bottom_arch, "prior_dim": args.bottom_dim,
                 "prior_layers": args.bottom_layers, "prior_heads": args.bottom_heads}
    return argparse.Namespace(**{
        **vars(args), **{k: v for k, v in overrides.items() if v is not None}})


def load_prior(ckpt_dir: str, spec: PriorSpec, device,
               dtype: torch.dtype = torch.float32) -> TransformerPrior | GatedPixelCNN:
    """The prior of a checkpoint (an artifact, its ``_ema`` sibling or a
    train state), computing in ``dtype``, in eval mode on ``device``;
    refuses one recorded with another spec."""
    prior = spec.build(dtype=dtype)
    try:
        checkpoint.check_extra(ckpt_dir, **spec.metadata())
        checkpoint.restore_params(ckpt_dir, prior)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    return prior.to(device).eval()


#: one train step at the hierarchy's 40 x 56 bottom grid (T = 2240, batch 32,
#: spatially conditioned), measured by chip_smoke.py (phase 12) on an NVIDIA
#: H100 80GB HBM3 at a 700 W power limit: ms of the transformer (dim 128, 4
#: layers) and of the default PixelCNN (dim 64, 15 layers)
LONG_GRID_STEP_MS = {"transformer": 34.4, "pixelcnn": 69.1}


def long_t_warning(arch: str, codes_shape, threshold: int = 1024):
    """A note (or None) for transformer priors over long code grids, where
    causal attention's cost grows as T^2, with the card's own measurement
    at the hierarchy's bottom grid. Long grids still train."""
    h, w = int(codes_shape[1]), int(codes_shape[2])
    if arch != "transformer" or h * w < threshold:
        return None
    ms = LONG_GRID_STEP_MS
    return (
        f"WARNING: transformer prior over a {h}x{w} code grid (T={h * w}): causal "
        f"attention cost grows as T^2. At 40x56 (T=2240, batch 32) a train step of a "
        f"128-wide 4-layer transformer took {ms['transformer']} ms and of the default "
        f"--arch pixelcnn {ms['pixelcnn']} ms on an NVIDIA H100 80GB HBM3 at 700 W"
    )


def _prior_cfg(args) -> Config:
    cfg = Config()
    if args.preset:
        cfg = load_preset(args.preset, cfg)
    return cfg


def load_vqvae(args, cfg: Config, device) -> VQVAE | HierVQVAE:
    """The ``--vqvae-ckpt`` model (live parameters and running statistics)
    in eval mode on ``device``: the two-level one under ``--hier``, else
    the flat one, speaker-conditioned when the preset says so."""
    from neural_sound_generation_tpu_torch.cli.serve import restore_weights

    if args.hier:
        model = HierVQVAE(1, args.dim, args.z_dim)
    else:
        gin = cfg.arch.gin_channels
        n_speakers = cfg.arch.n_speakers if gin > 0 else 0
        model = VQVAE(1, args.dim, args.z_dim, n_speakers=n_speakers,
                      gin_channels=gin if n_speakers else -1)
    restore_weights(model, cfg, args.vqvae_ckpt, ema=False)
    return model.to(device).eval()


def make_encoder(args, vqvae):
    """``encode(x) -> (codes, cond_map or None)``: the flat model's codes,
    or under ``--hier`` the configured level's, the bottom level with the
    top codes' conditioning map (the JAX ``cmd_train``'s ``encode``)."""
    bottom = args.hier and args.hier_level == "bottom"

    @torch.no_grad()
    def encode(x: torch.Tensor):
        if not args.hier:
            return vqvae.encode(x), None
        idx_t, idx_b = vqvae.encode(x)
        return (idx_b, hier_cond_map(vqvae, idx_t)) if bottom else (idx_t, None)

    return encode


def cmd_train(args) -> None:
    check_pipe_flags(args)
    with process_group(args.device):
        (_train_pp if args.mesh_pipe > 1 else _train)(args)


def _setup(args, device, mesh):
    """What both train paths read: (cfg with the run's train settings, the
    loaders, the epoch's batches of this rank's rows encoded on
    ``device``, the prior's spec)."""
    cfg = _prior_cfg(args)
    loaders = get_audio_data_loaders(args.datadir, None, args.batch_size, cfg,
                                     latent_stride=2 * LATENT_STRIDE if args.hier else LATENT_STRIDE)
    vqvae = load_vqvae(args, cfg, device)
    encode = make_encoder(args, vqvae)
    bottom_level = args.hier and args.hier_level == "bottom"
    spec = PriorSpec.from_args(args, cond_dim=args.dim if bottom_level else 0)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, initial_learning_rate=args.lr, batch_size=args.batch_size,
        ema_warmup=args.ema_warmup))
    say = primary_print(mesh)
    warned = []

    def epoch_batches():
        for i, batch in enumerate(loaders["train"]):
            if args.max_batches_per_epoch and i >= args.max_batches_per_epoch:
                break
            # this rank's rows, encoded here: the codes of a row do not
            # depend on the others (the VQ-VAE runs in eval mode)
            batch = shard_batch(batch, mesh)
            codes, cond = encode(torch.from_numpy(batch["x"]).to(device))
            if not warned:
                warned.append(True)
                warning = long_t_warning(args.arch, codes.shape)
                if warning:
                    say(warning)
            labels = np.asarray(batch.get("g", np.zeros(codes.shape[0])), np.int32)
            out = {"codes": codes, "labels": torch.from_numpy(labels).to(device)}
            if bottom_level:
                out["cond"] = cond
            yield out

    return cfg, loaders, epoch_batches, spec


def _epoch_line(args, epoch: int, means: dict) -> str:
    nll = means.get("loss", float("nan"))
    routed = (f" load_balance {means['moe_load_balance']:.4f}"
              if "moe_load_balance" in means else "")
    return (f"prior epoch {epoch}: nll/code {nll:.4f} (ppl {np.exp(nll):.1f} of "
            f"{args.z_dim}){routed}")


def _train_pp(args) -> None:
    """GPipe over the mesh's pipe axis (``--mesh-pipe S`` > 1; JAX's
    ``_train_pp``): each rank builds the prior whole on the host from the
    seed, keeps its stage's blocks (``parallel.pipeline.place_stage``) and
    encodes its rows with the frozen VQ-VAE; the lifecycle is
    ``cli._pp.run_pp_training``'s."""
    from neural_sound_generation_tpu_torch.cli._pp import pp_mesh, run_pp_training
    from neural_sound_generation_tpu_torch.parallel import pipeline as pp

    mesh, n_micro = pp_mesh(args)
    device = resolve_device(args.device)
    mesh.build_first(device, vq_kernel, fused_adam, flash_attention)
    cfg, loaders, epoch_batches, spec = _setup(args, device, mesh)
    prior = spec.build(args.seed, compute_dtype(args))
    state = pp.place_stage(prior, cfg.train, mesh, device)
    run_pp_training(
        ckpt_dir=args.ckpt_dir, resume=args.resume, epochs=args.epochs, mesh=mesh,
        n_micro=n_micro, checkpoint_interval=cfg.train.checkpoint_interval,
        set_epoch=loaders["train"].set_epoch, epoch_batches=epoch_batches, state=state,
        step_fn=pp.make_pp_prior_train_step(prior, mesh, n_micro), kind="prior",
        epoch_line=lambda epoch, means: _epoch_line(args, epoch, means),
        meta=spec.metadata(), say=primary_print(mesh))


def _train(args) -> None:
    device = resolve_device(args.device)
    mesh = mesh_from_args(args.mesh_data, args.mesh_model, args.batch_size)
    say = primary_print(mesh)
    if mesh is not None:
        kernels = (flash_attention,) if args.arch == "transformer" else ()
        mesh.build_first(device, vq_kernel, fused_adam, *kernels)
    cfg, loaders, epoch_batches, spec = _setup(args, device, mesh)
    meta = spec.metadata()
    prior = spec.build(args.seed, compute_dtype(args)).to(device)
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
                say(f"resumed train state from step {int(state.step)}, epoch {start_epoch}")
            elif checkpoint.latest_step(args.ckpt_dir) is not None:
                # an artifact alone: params and the EMA sibling resume, the
                # step lands in the state, Adam's moments restart
                at = checkpoint.latest_step(args.ckpt_dir)
                checkpoint.check_extra(args.ckpt_dir, **meta)
                extra = checkpoint.restore_params(args.ckpt_dir, prior)
                state.step.fill_(at)
                checkpoint.restore_ema_sibling(args.ckpt_dir, state)
                start_epoch = int((extra or {}).get("epoch", 0)) + 1
                say(f"resumed params from step {at}, epoch {start_epoch} (no *_train "
                    f"sibling: Adam moments restart)")
        except ValueError as e:
            raise SystemExit(str(e)) from e
    if mesh is not None and mesh.tensor_parallel:
        # this rank's slices of the whole (restored) state every rank holds
        state = shard_train_state(state, mesh)
    if mesh is not None:
        mesh.replicate(state)

    trainer = Trainer(prior, cfg, state, log_fn=None, multi_steps=args.multi_steps, mesh=mesh)

    def save_ckpt(state, step, completed_epoch):
        # completed_epoch is the last FINISHED epoch: an interval save inside
        # epoch N stores N-1, so --resume replays epoch N with its data order
        extra = {"epoch": completed_epoch, **meta}
        checkpoint.save_params(args.ckpt_dir, state.model, step, extra, shards=state.shards)
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
        say(_epoch_line(args, epoch, means))
        save_ckpt(trainer.state, int(trainer.state.step), completed_epoch=epoch)
    checkpoint.wait_for_pending()
    say(f"prior saved to {args.ckpt_dir}")
    if trainer.state.ema_params is not None:
        say(f"averaged-model (EMA) artifact saved to {args.ckpt_dir.rstrip('/')}_ema")


def cmd_sample(args) -> None:
    device = resolve_device(args.device)
    cfg = _prior_cfg(args)
    h, w = args.code_shape
    if args.hier and not args.bottom_ckpt:
        raise SystemExit("--hier sampling requires --bottom-ckpt")
    vqvae = load_vqvae(args, cfg, device)
    prior = load_prior(args.prior_ckpt, PriorSpec.from_args(args), device, compute_dtype(args))
    labels = torch.full((args.num_samples,), args.label, dtype=torch.int32, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.hier:
        # --code-shape names the top grid; the bottom prior samples twice it
        bottom = load_prior(args.bottom_ckpt,
                            PriorSpec.from_args(bottom_args(args), cond_dim=args.dim), device,
                            compute_dtype(args))
        _, _, wavs = sample_hier_audio(vqvae, prior, bottom, labels, (h, w), cfg.audio,
                                       generator)
        stem, what = "hier_sample", "hier samples"
    else:
        # a speaker-conditioned decoder takes the class label as the speaker id
        g = labels if vqvae.speakered else None
        _, wavs = sample_prior_audio(vqvae, prior, labels, (h, w), cfg.audio, generator, g=g)
        stem, what = "prior_sample", "samples"
    os.makedirs(args.output_dir, exist_ok=True)
    wavs = wavs.cpu().numpy()
    for i in range(args.num_samples):
        dsp.save_wav(wavs[i], os.path.join(args.output_dir, f"{stem}_{i:03d}.wav"),
                     cfg.audio.sample_rate)
    print(f"wrote {args.num_samples} {what} to {args.output_dir}")


def main(argv=None):
    args = parse_args(argv)
    {"train": cmd_train, "sample": cmd_sample}[args.cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])

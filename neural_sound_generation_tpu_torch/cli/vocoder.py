"""WaveNet vocoder CLI: train a vocoder on a preprocessed corpus, and
synthesize audio from a mel or, through units, from a waveform.

Counterpart of ``neural_sound_generation_tpu/cli/vocoder.py``, with its
flags and defaults.

``train`` fits the WaveNet by teacher forcing (the MoL loss for scalar
input, the masked cross entropy for mulaw-quantize; speakers when the
preset sets ``gin_channels``) through the ``Trainer``, one fused-Adam
kernel launch a step, on crops of the corpus's raw batches. ``--bf16`` runs
the teacher-forced convolutions in bf16 (parameters, loss and optimizer
float32). The learning rate is constant: the JAX CLI builds its state
without the preset's schedule, and so does this one. Checkpoints follow the
JAX layout: ``--ckpt-dir`` holds the ``{"params"}`` artifact that
``synthesize`` and ``serve --vocoder-ckpt`` restore, ``<ckpt-dir>_ema`` the
averaged model and ``<ckpt-dir>_train`` the full state that ``--resume``
continues (without it, ``--resume`` takes the artifact's parameters and the
EMA sibling, and Adam's moments restart). Every save records the epoch and
the conditioning chain (``_condition_meta``), which every restore checks.

``--condition units`` conditions the WaveNet on a frozen WaveVQVAE's
quantized latents (a ``cli.main --model wavevqvae`` checkpoint at the
``--units-*`` widths; its EMA shadow when it has one): each train step
encodes its targets, one nearest-code kernel launch a residual stage, and
``synthesize --wav-in`` resynthesizes a WAV through wav -> units ->
WaveNet. ``synthesize`` runs the scan sampler (``models/wavenet``; bf16
products by default) and undoes mu-law companding for ``mulaw`` and
``mulaw-quantize`` inputs.

``train`` runs data-parallel under ``torchrun`` (``--mesh-data N``, the
policy of ``cli.main``): every rank reads the same seeded batches and
trains on its rows of each (encoding them to units itself under
``--condition units``, the frozen WaveVQVAE whole on every rank); the
masked losses divide by the global batch's valid positions, and rank 0
writes the checkpoints. ``--mesh-model M`` lays a (W / M, M) mesh: the
ranks of a model group hold the same rows and a slice each of the
WaveNet's convolutions, each gate split block-wise so that a rank gates
its own channels (``training.sharding``), placed after any ``--resume``
restore; the checkpoints stay whole, gathered for rank 0, so
``synthesize``, ``serve --vocoder-ckpt`` and ``--resume`` at any M read
them. ``--mesh-pipe S`` (``--stacks`` divisible by S, mel or units
conditioning) trains GPipe over a (W / S, S) mesh, ``--pp-microbatches
M`` (default S) microbatches a step (``parallel.pipeline``, the lifecycle
of ``cli._pp``): each rank holds the layers of its stacks and their
moments; ``--bf16`` runs the stages' layers in bfloat16 on float32
parameters, with bfloat16 activations between stages and a float32 head,
as JAX's pipe path does; the checkpoints are dense
(``<ckpt-dir>_pp_train`` holds the state that ``--resume`` continues at
any pipe width; without it the artifact and its EMA sibling). Speaker ids
are dropped for a model without speakers. ``--mesh-model`` with
``--mesh-pipe`` refuses: JAX's pipe path lays no model axis.

Run: ``python -m neural_sound_generation_tpu_torch.cli.vocoder train
--datadir <corpus> [--condition units --units-vqvae-ckpt <ckpt>] [--bf16]
[--resume] [--device cuda]`` (``torchrun --nproc_per_node 4 -m ... train
--mesh-model 2 ...`` for two data ranks of two model ranks, ``...
--mesh-pipe 2 ...`` for two data rows of two stages); ``...
synthesize --ckpt-dir <artifact> --mel-npy <frames x mels .npy> |
--condition units --wav-in <wav> --output out.wav``
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import Config, load_preset
from neural_sound_generation_tpu_torch.data.pipeline import get_audio_data_loaders
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.models import WaveVQVAE
from neural_sound_generation_tpu_torch.models.wavenet import WaveNet, make_generate_fn
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.ops.cuda import fused_adam, vq_kernel
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WaveNet vocoder train/synthesize")
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train")
    tr.add_argument("--datadir", required=True)
    tr.add_argument("--ckpt-dir", default="./models/wavenet")
    tr.add_argument("--preset", default=None)
    tr.add_argument("--batch-size", type=int, default=2)
    tr.add_argument("--epochs", type=int, default=2000)
    tr.add_argument("--layers", type=int, default=None)
    tr.add_argument("--stacks", type=int, default=None)
    tr.add_argument("--residual-channels", type=int, default=None)
    tr.add_argument("--max-batches-per-epoch", type=int, default=None)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint: the *_train sibling's "
                         "full state, else the artifact's parameters and EMA (Adam's "
                         "moments restart)")
    tr.add_argument("--mesh-data", type=int, default=None,
                    help="data-parallel ranks (torchrun --nproc_per_node N)")
    tr.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel ranks (the model axis)")
    tr.add_argument("--mesh-pipe", type=int, default=1,
                    help="pipeline-parallel stages (GPipe over the stacks)")
    tr.add_argument("--pp-microbatches", type=int, default=None,
                    help="pipeline microbatches a step (default: --mesh-pipe)")
    tr.add_argument("--multi-steps", type=int, default=1,
                    help="optimization steps per super-batch")
    tr.add_argument("--bf16", action="store_true",
                    help="bfloat16 teacher-forced convolutions (parameters, loss and "
                         "optimizer float32)")
    tr.add_argument("--ema-warmup", action="store_true",
                    help="ramp the EMA decay min(decay, (1+t)/(10+t))")
    tr.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, cuda:N or cpu)")
    _units_args(tr)

    sy = sub.add_parser("synthesize")
    sy.add_argument("--ckpt-dir", required=True)
    sy.add_argument("--mel-npy", default=None, help="time-major mel .npy "
                    "(required for --condition mel)")
    sy.add_argument("--wav-in", default=None,
                    help="source wav for --condition units: encoded to units by the "
                         "frozen WaveVQVAE, then resynthesized through the WaveNet")
    _units_args(sy)
    sy.add_argument("--output", required=True)
    sy.add_argument("--preset", default=None)
    sy.add_argument("--layers", type=int, default=None)
    sy.add_argument("--stacks", type=int, default=None)
    sy.add_argument("--residual-channels", type=int, default=None)
    sy.add_argument("--max-frames", type=int, default=40)
    sy.add_argument("--seed", type=int, default=0)
    sy.add_argument("--speaker-id", type=int, default=None,
                    help="speaker id for a speaker-conditioned checkpoint "
                         "(gin_channels > 0); required when the model carries "
                         "speaker embeddings")
    sy.add_argument("--gen-precision", choices=["bf16", "f32"], default="bf16",
                    help="dtype of the sampling products: bf16, or f32 for "
                         "parity with teacher-forced evaluation")
    sy.add_argument("--device", default="cuda",
                    help="torch device to synthesize on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def _units_args(p) -> None:
    """The units -> WaveNet chain's flags, shared by train and synthesize."""
    p.add_argument("--condition", choices=["mel", "units"], default="mel",
                   help="conditioning signal: preprocessed mels, or a frozen "
                        "WaveVQVAE's quantized unit latents (--units-vqvae-ckpt)")
    p.add_argument("--units-vqvae-ckpt", default=None,
                   help="trained WaveVQVAE checkpoint (cli.main --model wavevqvae)")
    p.add_argument("--units-dim", type=int, default=256,
                   help="WaveVQVAE hidden width (= conditioning channels)")
    p.add_argument("--units-z-dim", type=int, default=512)
    p.add_argument("--units-downsample", type=int, default=6,
                   help="WaveVQVAE stride-2 layers (unit hop = 2^n)")
    p.add_argument("--units-num-quantizers", type=int, default=1)


def check_pipe_flags(args, cfg: Config) -> None:
    """JAX's refusals of the pipe path (``_train_pp``), before anything is
    read: the stacks must stage evenly and the layers fill them, the
    vocoder must be conditioned; and ``--mesh-model`` with ``--mesh-pipe``."""
    from neural_sound_generation_tpu_torch.cli._pp import refuse_model_and_pipe

    refuse_model_and_pipe(args)
    n_pipe = args.mesh_pipe
    if n_pipe <= 1:
        return
    layers, stacks = args.layers or cfg.arch.layers, args.stacks or cfg.arch.stacks
    if stacks % n_pipe:
        raise SystemExit(f"--stacks {stacks} does not stage evenly over --mesh-pipe {n_pipe}")
    if layers % stacks:
        raise SystemExit(f"--layers {layers} does not divide into --stacks {stacks}")
    cin = args.units_dim if args.condition == "units" else cfg.arch.cin_channels
    if cin <= 0:
        raise SystemExit("--mesh-pipe requires mel conditioning (cin_channels > 0)")


def _units_scales(num_downsample: int) -> tuple[int, ...]:
    """Transposed-conv upsample factors multiplying to the unit hop
    2^num_downsample (6 -> (4, 4, 4), 5 -> (4, 4, 2), 4 -> (4, 4))."""
    scales, n = [], int(num_downsample)
    while n >= 2:
        scales.append(4)
        n -= 2
    if n:
        scales.append(2)
    return tuple(scales)


def build_model(cfg: Config, args, generator: torch.Generator | None = None) -> WaveNet:
    """The vocoder of ``cfg.arch`` with the width and depth flags: gate
    channels = residual, skip = min(arch skip, residual); categorical
    output for mulaw-quantize inputs; under ``--condition units`` the
    WaveVQVAE's width as conditioning channels and an upsampler by the unit
    hop; bf16 teacher-forced convolutions under ``--bf16``."""
    arch = cfg.arch
    scalar = cfg.audio.is_scalar_input
    residual = args.residual_channels or arch.residual_channels
    cin, scales = arch.cin_channels, tuple(arch.upsample_scales)
    if getattr(args, "condition", "mel") == "units":
        cin, scales = args.units_dim, _units_scales(args.units_downsample)
    return WaveNet(
        out_channels=arch.out_channels if scalar else cfg.audio.quantize_channels,
        layers=args.layers or arch.layers,
        stacks=args.stacks or arch.stacks,
        residual_channels=residual,
        gate_channels=residual,
        skip_out_channels=min(arch.skip_out_channels, residual),
        kernel_size=arch.kernel_size,
        cin_channels=cin,
        gin_channels=arch.gin_channels,
        n_speakers=arch.n_speakers,
        upsample_scales=scales,
        scalar_input=scalar,
        quantize_channels=cfg.audio.quantize_channels,
        generator=generator,
        dtype=torch.bfloat16 if getattr(args, "bf16", False) else torch.float32,
    )


def _build_units_encoder(args, cfg: Config, device):
    """The frozen WaveVQVAE of ``--units-vqvae-ckpt`` on ``device``, in eval
    mode with its EMA shadow when the checkpoint has one (the weights
    evaluate and serve treat as the model): ``(units_fn, model)``, with
    ``units_fn(x)`` the quantized latents (B, T / hop, units_dim) of a
    waveform batch ((B, T, 1) floats, or (B, T) ints for mulaw-quantize)."""
    if not args.units_vqvae_ckpt:
        raise SystemExit(
            "--condition units requires --units-vqvae-ckpt (a trained wavevqvae checkpoint)")
    model = WaveVQVAE(
        dim=args.units_dim, z_dim=args.units_z_dim, num_downsample=args.units_downsample,
        input_type=cfg.audio.input_type, quantize_channels=cfg.audio.quantize_channels,
        num_quantizers=args.units_num_quantizers)
    try:
        checkpoint.check_extra(args.units_vqvae_ckpt, arch="wavevqvae",
                               num_quantizers=args.units_num_quantizers,
                               num_downsample=args.units_downsample)
        state, _ = checkpoint.restore(args.units_vqvae_ckpt,
                                      create_train_state(model, cfg.train))
    except ValueError as e:
        raise SystemExit(str(e)) from e
    with torch.no_grad():
        state.flat.flat.copy_(state.eval_params())
    model.zero_grad(set_to_none=True)  # frozen: no gradient buffer
    model = model.requires_grad_(False).to(device).eval()

    @torch.no_grad()
    def units_fn(x: torch.Tensor) -> torch.Tensor:
        return model.quantized_latents(x)

    return units_fn, model


def _condition_meta(args) -> dict:
    """The conditioning chain a checkpoint records in ``extra``, checked at
    every restore: a units checkpoint restored with other ``--units-*``
    flags would otherwise graft another upsampler and cond convs."""
    if getattr(args, "condition", "mel") != "units":
        return {"condition": "mel"}
    return {"condition": "units", "units_dim": int(args.units_dim),
            "units_z_dim": int(args.units_z_dim),
            "units_downsample": int(args.units_downsample),
            "units_num_quantizers": int(args.units_num_quantizers)}


def _check_condition_meta(args, extra) -> None:
    """SystemExit when the checkpoint's recorded conditioning chain does not
    match the flags (checkpoints without the metadata pass)."""
    meta = extra or {}
    if "condition" not in meta:
        return
    want = _condition_meta(args)
    if meta["condition"] != want["condition"]:
        raise SystemExit(
            f"this checkpoint was trained with --condition {meta['condition']}; "
            f"rerun with matching flags")
    for k, v in want.items():
        if k != "condition" and int(meta.get(k, v)) != int(v):
            raise SystemExit(
                f"checkpoint metadata {k}={meta[k]} does not match --{k.replace('_', '-')} "
                f"{v}; the restored model would be a silent architecture mismatch")


def _batch_to_wavenet(batch, cfg: Config, with_mel: bool = True):
    """A raw collate batch -> (targets, mel (B, T', n_mels) or None): int32
    targets (B, T) for mulaw-quantize, float32 (B, T, 1) otherwise.
    ``with_mel=False`` leaves the mel block alone (the units chain)."""
    if cfg.audio.is_mulaw_quantize:
        targets = np.asarray(batch["y"], np.int32)
    else:
        targets = np.asarray(batch["y"], np.float32)[..., None]
    if not with_mel:
        return targets, None
    return targets, np.ascontiguousarray(np.asarray(batch["c"]).transpose(0, 2, 1))


def _batch_speakers(batch):
    g = batch.get("g")
    return None if g is None else np.asarray(g, np.int32)


def load_vocoder(ckpt_dir: str, model: WaveNet, device) -> WaveNet:
    """A vocoder artifact's parameters in ``model``, in eval mode on
    ``device``; a checkpoint of another shape refuses with the names."""
    try:
        checkpoint.restore_params(ckpt_dir, model)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    return model.to(device).eval()


def postprocess(samples: torch.Tensor, audio) -> torch.Tensor:
    """The vocoder's output as a waveform: inverse mu-law for ``mulaw``
    inputs, inverse mu-law quantization for ``mulaw-quantize``, as is for
    ``raw``. Memoryless, so chunks may be processed one at a time."""
    if audio.is_mulaw_quantize:
        return dsp.inv_mulaw_quantize(samples, audio.quantize_channels)
    if audio.is_mulaw:
        return dsp.inv_mulaw(samples, audio.quantize_channels)
    return samples


def _load_cfg(args) -> Config:
    cfg = Config()
    if args.preset:
        cfg = load_preset(args.preset, cfg)
    return cfg


def _resume(args, state, train_dir: str, say=print) -> int:
    """``--resume``: the first epoch to run. The recorded chain is checked
    first; the ``_train`` sibling restores the whole state, an artifact
    alone its parameters, the EMA sibling and the step."""
    for d in (train_dir, args.ckpt_dir):
        if checkpoint.latest_step(d) is not None:
            _check_condition_meta(args, checkpoint.read_extra(d))
            break
    try:
        if checkpoint.latest_step(train_dir) is not None:
            state, extra = checkpoint.restore(train_dir, state)
            start_epoch = int((extra or {}).get("epoch", 0)) + 1
            say(f"resumed train state from step {int(state.step)}, epoch {start_epoch}")
            return start_epoch
        at = checkpoint.latest_step(args.ckpt_dir)
        if at is None:
            return 1
        extra = checkpoint.restore_params(args.ckpt_dir, state.model)
        state.step.fill_(at)
        checkpoint.restore_ema_sibling(args.ckpt_dir, state)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    start_epoch = int((extra or {}).get("epoch", 0)) + 1
    say(f"resumed params from step {at}, epoch {start_epoch} (no *_train sibling: Adam "
        f"moments restart)")
    return start_epoch


def cmd_train(args) -> None:
    check_pipe_flags(args, _load_cfg(args))
    with process_group(args.device):
        (_train_pp if args.mesh_pipe > 1 else _train)(args)


def _batches(args, cfg: Config, loaders, mesh, device, speakers: bool = True):
    """The epoch's batches of this rank's rows: (targets, the mels or, under
    ``--condition units``, the units encoded on ``device``, the lengths,
    the speaker ids where the corpus has them and ``speakers``)."""
    units_fn = None
    if args.condition == "units":
        units_fn, units_model = _build_units_encoder(args, cfg, device)
        uhop = units_model.hop

    def epoch_batches():
        for i, batch in enumerate(loaders["train"]):
            if args.max_batches_per_epoch and i >= args.max_batches_per_epoch:
                break
            batch = shard_batch(batch, mesh)
            if units_fn is not None:
                # the units of the target waveform itself, encoded on the
                # device; the mel block is never read
                targets, _ = _batch_to_wavenet(batch, cfg, with_mel=False)
                targets = targets[:, : targets.shape[1] - targets.shape[1] % uhop]
                y = torch.from_numpy(np.ascontiguousarray(targets)).to(device)
                out = {"y": y, "c": units_fn(y)}
            else:
                y, c = _batch_to_wavenet(batch, cfg)
                out = {"y": y, "c": c}
            out["input_lengths"] = np.asarray(batch["input_lengths"])
            g = _batch_speakers(batch)
            if g is not None and speakers:
                out["g"] = g
            yield out

    return epoch_batches


def _train_pp(args) -> None:
    """GPipe over the mesh's pipe axis (``--mesh-pipe S`` > 1; JAX's
    ``_train_pp``): each rank builds the vocoder whole (float32) on the
    host from the seed and keeps the layers of its stacks
    (``parallel.pipeline.place_stage``, bf16 stage math under ``--bf16``);
    under ``--condition units`` the frozen WaveVQVAE stays whole on every
    rank and encodes its rows; the lifecycle is
    ``cli._pp.run_pp_training``'s."""
    from neural_sound_generation_tpu_torch.cli._pp import pp_mesh, run_pp_training
    from neural_sound_generation_tpu_torch.parallel import pipeline as pp

    mesh, n_micro = pp_mesh(args)
    device = resolve_device(args.device)
    if args.resume:
        for d in (args.ckpt_dir.rstrip("/") + "_pp_train", args.ckpt_dir):
            if checkpoint.latest_step(d) is not None:
                _check_condition_meta(args, checkpoint.read_extra(d))
                break
    mesh.build_first(device, fused_adam, *((vq_kernel,) if args.condition == "units" else ()))
    cfg = _load_cfg(args)
    loaders = get_audio_data_loaders(args.datadir, None, args.batch_size, cfg, batch_mode="raw")
    # the module float32; --bf16 selects the stages' compute dtype
    model = build_model(cfg, argparse.Namespace(**{**vars(args), "bf16": False}),
                        generator=torch.Generator().manual_seed(args.seed))
    epoch_batches = _batches(args, cfg, loaders, mesh, device, speakers=model.speakered)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=args.batch_size, ema_warmup=args.ema_warmup))
    state = pp.place_stage(model, cfg.train, mesh, device,
                           torch.bfloat16 if args.bf16 else None)
    run_pp_training(
        ckpt_dir=args.ckpt_dir, resume=args.resume, epochs=args.epochs, mesh=mesh,
        n_micro=n_micro, checkpoint_interval=cfg.train.checkpoint_interval,
        set_epoch=loaders["train"].set_epoch, epoch_batches=epoch_batches, state=state,
        step_fn=pp.make_pp_wavenet_train_step(model, cfg, mesh, n_micro, bf16=args.bf16),
        kind="wavenet",
        epoch_line=lambda epoch, means: f"wavenet epoch {epoch}: loss "
                                        f"{means.get('loss', float('nan')):.4f}",
        meta=_condition_meta(args), say=primary_print(mesh))


def _train(args) -> None:
    from neural_sound_generation_tpu_torch.cli.main import epoch_generator

    device = resolve_device(args.device)
    mesh = mesh_from_args(args.mesh_data, args.mesh_model, args.batch_size)
    say = primary_print(mesh)
    if mesh is not None:
        mesh.build_first(device, fused_adam, *(
            (vq_kernel,) if args.condition == "units" else ()))
    cfg = _load_cfg(args)
    loaders = get_audio_data_loaders(args.datadir, None, args.batch_size, cfg, batch_mode="raw")
    model = build_model(cfg, args, generator=torch.Generator().manual_seed(args.seed)).to(device)
    epoch_batches = _batches(args, cfg, loaders, mesh, device)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=args.batch_size, ema_warmup=args.ema_warmup))
    state = create_train_state(model, cfg.train)
    train_dir = args.ckpt_dir.rstrip("/") + "_train"
    start_epoch = _resume(args, state, train_dir, say) if args.resume else 1
    if mesh is not None and mesh.tensor_parallel:
        # this rank's slices of the whole (restored) state every rank holds
        state = shard_train_state(state, mesh)
    if mesh is not None:
        mesh.replicate(state)
    trainer = Trainer(model, cfg, state, log_fn=None, multi_steps=args.multi_steps, mesh=mesh)
    meta = _condition_meta(args)

    def save_ckpt(state, step, completed_epoch):
        # completed_epoch is the last FINISHED epoch: an interval save inside
        # epoch N records N-1, so --resume replays epoch N with its data order
        extra = {"epoch": completed_epoch, **meta}
        checkpoint.save_params(args.ckpt_dir, state.model, step, extra, shards=state.shards)
        checkpoint.save_ema_sibling(args.ckpt_dir, state, step, extra)
        checkpoint.save(train_dir, state, step, extra, block=False)

    for epoch in range(start_epoch, args.epochs + 1):
        # the data order is f(seed, epoch): --resume replays what an
        # uninterrupted run's epoch N would see
        loaders["train"].set_epoch(epoch - 1)
        means = trainer.train_epoch(
            epoch_batches(), epoch_generator(args.seed, epoch, device), epoch=epoch,
            checkpoint_cb=lambda s, st, e=epoch: save_ckpt(s, st, completed_epoch=e - 1))
        say(f"wavenet epoch {epoch}: loss {means.get('loss', float('nan')):.4f}")
        save_ckpt(trainer.state, int(trainer.state.step), completed_epoch=epoch)
    checkpoint.wait_for_pending()
    if trainer.state.ema_params is not None:
        say(f"averaged-model (EMA) artifact saved to {args.ckpt_dir.rstrip('/')}_ema")


def _units_condition(args, cfg: Config, device):
    """``synthesize --condition units``: the ``--wav-in`` waveform, peak
    rescaled before companding as the corpus was, cropped to a multiple of
    the unit hop and to ``--max-frames`` hops, as the frozen WaveVQVAE's
    quantized latents (1, T', units_dim); and the length in samples.
    Silence is not trimmed: that would shift timing against the source."""
    if not args.wav_in:
        raise SystemExit("--condition units synthesize needs --wav-in")
    units_fn, units_model = _build_units_encoder(args, cfg, device)
    audio = cfg.audio
    wav = dsp.load_wav(args.wav_in, audio.sample_rate)
    if audio.rescaling:
        wav = wav / max(np.abs(wav).max(), 1e-8) * audio.rescaling_max
    x = torch.from_numpy(np.asarray(wav, np.float32)).to(device)
    if audio.is_mulaw_quantize:
        x = torch.clamp(dsp.mulaw_quantize(x, audio.quantize_channels), 0,
                        audio.quantize_channels - 1)
    elif audio.is_mulaw:
        x = dsp.mulaw(x, audio.quantize_channels)
    uhop = units_model.hop
    t = min(x.shape[0] - x.shape[0] % uhop, args.max_frames * uhop)
    if t <= 0:
        raise SystemExit(f"--wav-in shorter than one unit hop ({uhop} samples)")
    x = x[:t] if audio.is_mulaw_quantize else x[:t, None]
    c = units_fn(x[None])
    return c, int(c.shape[1]) * uhop


def cmd_synthesize(args) -> None:
    cfg = _load_cfg(args)
    # the recorded conditioning chain is checked before anything is built
    _check_condition_meta(args, checkpoint.read_extra(args.ckpt_dir))
    device = resolve_device(args.device)
    model = build_model(cfg, args)
    if args.condition == "units":
        c, length = _units_condition(args, cfg, device)
    else:
        if not args.mel_npy:
            raise SystemExit("--condition mel synthesize needs --mel-npy")
        mel = np.load(args.mel_npy)[: args.max_frames]  # (frames, n_mels)
        c = torch.from_numpy(np.asarray(mel, np.float32))[None].to(device)
        length = mel.shape[0] * cfg.audio.effective_hop_size

    g = None
    if model.speakered:
        if args.speaker_id is None:
            raise SystemExit(
                f"this checkpoint is speaker-conditioned (gin_channels {model.gin_channels}): "
                f"pass --speaker-id 0..{model.n_speakers - 1}"
            )
        g = torch.tensor([args.speaker_id], dtype=torch.long, device=device)
    elif args.speaker_id is not None:
        raise SystemExit(
            "--speaker-id given but the model has no speaker embeddings "
            "(gin_channels <= 0); use the multispeaker preset"
        )
    model = load_vocoder(args.ckpt_dir, model, device)
    generate = make_generate_fn(
        model, length, dtype=torch.bfloat16 if args.gen_precision == "bf16" else None)
    out = generate(c, g, torch.Generator(device=device).manual_seed(args.seed))
    wav = postprocess(out[0], cfg.audio).float().cpu().numpy()
    dsp.save_wav(wav, args.output, cfg.audio.sample_rate)
    print(f"synthesized {len(wav)} samples -> {args.output}")


def main(argv=None):
    args = parse_args(argv)
    {"train": cmd_train, "synthesize": cmd_synthesize}[args.cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])

"""WaveNet vocoder CLI: synthesize audio from a mel with a vocoder artifact.

Counterpart of ``neural_sound_generation_tpu/cli/vocoder.py`` for the
mel-conditioned chain. ``synthesize`` restores a vocoder artifact (the
port's checkpoint format: ``params/<name>`` tensors and ``{"condition":
"mel"}`` in ``_extra.json``, see ``training/checkpoint.py``), runs the
scan sampler (``models/wavenet.make_generate_fn``; bf16 products by
default) over a stored time-major mel, undoes mu-law companding for
``mulaw`` and ``mulaw-quantize`` inputs and writes a WAV of frames x hop
samples. A checkpoint recorded with another conditioning chain is refused.

``train``, ``--condition units`` (and with them ``--mesh-*``, ``--bf16``,
``--multi-steps``) raise ``NotImplementedError``: vocoder training and the
units chain are the next slice of the port.

Run: ``python -m neural_sound_generation_tpu_torch.cli.vocoder synthesize
--ckpt-dir <artifact> --mel-npy <frames x mels .npy> --output out.wav
[--device cuda]``
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import Config, load_preset
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.models.wavenet import WaveNet, make_generate_fn
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.training import checkpoint

NEXT_SLICE = "vocoder training and the units chain come with the next slice of the port"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="WaveNet vocoder train/synthesize")
    sub = p.add_subparsers(dest="cmd", required=True)
    # train's flags are the next slice's; they are accepted and refused
    sub.add_parser("train", help=f"not ported: {NEXT_SLICE}")

    sy = sub.add_parser("synthesize")
    sy.add_argument("--ckpt-dir", required=True)
    sy.add_argument("--mel-npy", default=None, help="time-major mel .npy "
                    "(required for --condition mel)")
    sy.add_argument("--condition", choices=["mel", "units"], default="mel",
                    help="conditioning signal (units: the next slice)")
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
    args, rest = p.parse_known_args(argv)
    if rest and args.cmd != "train":
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return args


def build_model(cfg: Config, args, generator: torch.Generator | None = None) -> WaveNet:
    """The vocoder of ``cfg.arch`` with the width and depth flags: gate
    channels = residual, skip = min(arch skip, residual); categorical
    output for mulaw-quantize inputs."""
    arch = cfg.arch
    scalar = cfg.audio.is_scalar_input
    residual = args.residual_channels or arch.residual_channels
    return WaveNet(
        out_channels=arch.out_channels if scalar else cfg.audio.quantize_channels,
        layers=args.layers or arch.layers,
        stacks=args.stacks or arch.stacks,
        residual_channels=residual,
        gate_channels=residual,
        skip_out_channels=min(arch.skip_out_channels, residual),
        kernel_size=arch.kernel_size,
        cin_channels=arch.cin_channels,
        gin_channels=arch.gin_channels,
        n_speakers=arch.n_speakers,
        upsample_scales=tuple(arch.upsample_scales),
        scalar_input=scalar,
        quantize_channels=cfg.audio.quantize_channels,
        generator=generator,
    )


def condition_meta() -> dict:
    """The conditioning chain a vocoder artifact records in ``extra`` (the
    port has the mel chain)."""
    return {"condition": "mel"}


def check_condition_meta(extra) -> None:
    """SystemExit when the checkpoint's recorded conditioning chain is not
    the mel chain (checkpoints without the metadata pass)."""
    meta = extra or {}
    if "condition" in meta and meta["condition"] != condition_meta()["condition"]:
        raise SystemExit(
            f"this checkpoint was trained with --condition {meta['condition']}; "
            f"rerun with matching flags"
        )


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


def cmd_synthesize(args) -> None:
    if args.condition != "mel":
        raise NotImplementedError(f"--condition {args.condition}: {NEXT_SLICE}")
    cfg = _load_cfg(args)
    # the recorded conditioning chain is checked before anything is built
    check_condition_meta(checkpoint.read_extra(args.ckpt_dir))
    device = resolve_device(args.device)
    model = build_model(cfg, args)
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
    if args.cmd == "train":
        raise NotImplementedError(
            f"cli.vocoder train (--condition units, --mesh-*, --bf16, --multi-steps): "
            f"{NEXT_SLICE}")
    cmd_synthesize(args)


if __name__ == "__main__":
    main(sys.argv[1:])

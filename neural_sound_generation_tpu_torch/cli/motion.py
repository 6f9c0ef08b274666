"""Motion-stack CLI: capture / analyze / watch / generate.

Counterpart of ``neural_sound_generation_tpu/cli/motion.py``, with its flags
and defaults, plus ``generate --device`` (the card unless the caller names
another, e.g. ``cpu``):

  * ``capture``: record the synthetic C++ hand's joint angles to CSV;
  * ``analyze``: fit PCA on a recorded CSV and print the projection;
  * ``watch``: print streamed frames through the listener callbacks, or with
    ``--gestures`` the scripted choreography's recognized gestures;
  * ``generate``: replay a CSV through PCA into a feature-conditioned VQ-VAE
    decoder and write audio by Griffin-Lim.

``generate --ckpt-dir`` restores a ``cli.main`` checkpoint's live parameters
and BatchNorm statistics into the conditioned model. Such a checkpoint has no
``feature_proj`` (no training CLI takes features): that projection keeps its
seeded initialization, with a warning, as the JAX CLI's restore fills it from
the template. Every other parameter must be there at its shape.

    python -m neural_sound_generation_tpu_torch.cli.motion capture cap.csv
    python -m neural_sound_generation_tpu_torch.cli.motion generate cap.csv out.wav \\
        --ckpt-dir models/vqvae/checkpoint_ljspeech_256_512 --dim 256 --z-dim 512
"""

from __future__ import annotations

import argparse
import math
import sys
import threading

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.motion import capture
from neural_sound_generation_tpu_torch.motion.inference import MotionDrivenGenerator
from neural_sound_generation_tpu_torch.motion.pca import load_pca
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.training import checkpoint

#: the conditioned model's parameters a ``cli.main`` checkpoint lacks
FILLED_FROM_INIT = ("feature_proj",)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Motion-conditioning tools")
    sub = p.add_subparsers(dest="cmd", required=True)

    cap = sub.add_parser("capture", help="record synthetic hand motion to CSV")
    cap.add_argument("output_csv")
    cap.add_argument("--frames", type=int, default=600)
    cap.add_argument("--seed", type=int, default=0)

    ana = sub.add_parser("analyze", help="fit PCA on a joint-angle CSV")
    ana.add_argument("input_csv")
    ana.add_argument("--components", type=int, default=3)

    wat = sub.add_parser("watch", help="print streamed frames to the console")
    wat.add_argument("--csv", default=None, help="replay this CSV; default: synthetic")
    wat.add_argument("--frames", type=int, default=20)
    wat.add_argument("--fps", type=float, default=120.0)
    wat.add_argument("--seed", type=int, default=0)
    wat.add_argument(
        "--gestures", action="store_true",
        help="stream the scripted gesture choreography and print "
             "recognized circle/swipe/tap events",
    )

    gen = sub.add_parser("generate", help="replay CSV -> decoder -> wav")
    gen.add_argument("input_csv")
    gen.add_argument("output_wav")
    gen.add_argument("--ckpt-dir", default=None,
                     help="trained cli.main VQ-VAE checkpoint dir (optional; "
                          "seeded untrained weights are used if omitted)")
    gen.add_argument("--dim", type=int, default=64)
    gen.add_argument("--z-dim", type=int, default=128)
    gen.add_argument("--components", type=int, default=3)
    gen.add_argument("--window", type=int, default=16)
    gen.add_argument("--max-windows", type=int, default=8)
    gen.add_argument("--seed", type=int, default=0)
    gen.add_argument("--device", default="cuda",
                     help="torch device to generate on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def cmd_capture(args):
    ctrl = capture.synthetic_controller(seed=args.seed, n_frames=args.frames)
    try:
        got = ctrl.record_csv(args.output_csv, args.frames)
    finally:
        ctrl.close()
    print(f"recorded {got} frames -> {args.output_csv}")


def cmd_analyze(args):
    proj = load_pca(args.input_csv, args.components)
    data = np.genfromtxt(args.input_csv, delimiter=",")
    if data.ndim == 1:  # single-row recording (same guard as load_pca)
        data = data[None, :]
    latents = proj.project(data)
    print(f"{data.shape[0]} frames x {data.shape[1]} features "
          f"-> {latents.shape[1]} components")
    print("per-component latent std:", np.round(latents.std(axis=0), 4).tolist())


def _describe_gesture(event, last_progress):
    """One gesture event as text: circles report clockwiseness and the angle
    swept since the previous update; swipes report direction and speed;
    taps report position."""
    if event.type == capture.GESTURE_TYPE_CIRCLE:
        clockwiseness = "clockwise" if event.clockwise else "counterclockwise"
        swept = 0.0
        if event.state != capture.GESTURE_STATE_START:
            swept = (
                event.progress - last_progress.get(event.id, event.progress)
            ) * 2 * math.pi
        last_progress[event.id] = event.progress
        return (
            f"Circle id: {event.id}, {event.state_name}, progress: "
            f"{event.progress:.2f}, radius: {event.radius:.1f}, angle: "
            f"{math.degrees(swept):.1f} degrees, {clockwiseness}"
        )
    if event.type == capture.GESTURE_TYPE_SWIPE:
        d = event.direction
        return (
            f"Swipe id: {event.id}, {event.state_name}, direction: "
            f"({d[0]:+.2f} {d[1]:+.2f} {d[2]:+.2f}), speed: {event.speed:.0f}"
        )
    p = event.position
    return (
        f"{event.type_name} id: {event.id}, {event.state_name}, position: "
        f"({p[0]:.0f} {p[1]:.0f} {p[2]:.0f})"
    )


def cmd_watch(args):
    """Stream frames through the listener-callback path and print them; with
    --gestures, print recognized gesture events as they fire."""
    if args.gestures:
        ctrl = capture.scripted_gesture_controller(fps=args.fps)
        args.frames = max(args.frames, len(ctrl))
    elif args.csv:
        ctrl = capture.replay_controller(args.csv, fps=args.fps)
    else:
        ctrl = capture.synthetic_controller(seed=args.seed, fps=args.fps,
                                            n_frames=args.frames)
    last_progress = {}
    if args.gestures:
        ctrl.add_gesture_listener(
            lambda e: print("  " + _describe_gesture(e, last_progress))
        )
    done = threading.Event()
    count = [0]

    def on_frame(feats):
        count[0] += 1
        if not args.gestures:  # gesture mode prints events, not frames
            print(
                f"frame {count[0]}: pitch={feats[0]:+.3f} roll={feats[1]:+.3f} "
                f"yaw={feats[2]:+.3f} joints[{feats[3]:+.2f} {feats[4]:+.2f} ...]"
            )
        if count[0] >= args.frames:
            done.set()

    ctrl.add_listener(on_frame)
    try:
        ctrl.start()
        done.wait(timeout=max(5.0, args.frames / args.fps * 4))
    finally:
        ctrl.stop()
        ctrl.close()
    print(f"watched {count[0]} frames")


def build_model(args) -> VQVAE:
    """The feature-conditioned VQ-VAE of ``generate``, seeded from --seed on
    the CPU, then restored from --ckpt-dir when one is given."""
    model = VQVAE(input_dim=1, dim=args.dim, z_dim=args.z_dim,
                  cond_features=args.components,
                  generator=torch.Generator().manual_seed(args.seed))
    if args.ckpt_dir:
        checkpoint.check_extra(args.ckpt_dir, arch="vqvae", num_quantizers=1)
        checkpoint.restore_model(args.ckpt_dir, model, fill=FILLED_FROM_INIT)
    return model


def cmd_generate(args):
    device = resolve_device(args.device)
    cfg = Config()
    projector = load_pca(args.input_csv, args.components)
    latent_hw = (cfg.audio.num_mels // 4, args.window // 4)
    gen = MotionDrivenGenerator(build_model(args), projector, cfg.audio, latent_hw, device)
    ctrl = capture.replay_controller(args.input_csv)
    mels = []
    try:
        for _, mel in gen.run_stream(ctrl, window=args.window, max_windows=args.max_windows):
            mels.append(mel)
    finally:
        ctrl.close()
    if not mels:
        print("no frames in recording")
        return
    # each window yields one (num_mels, frames) mel; concatenate along time
    mel_full = torch.from_numpy(np.concatenate(mels, axis=-1)).to(device)
    wav = dsp.inv_mel_spectrogram(
        mel_full, cfg.audio, torch.Generator(device=device).manual_seed(args.seed))
    dsp.save_wav(wav.cpu().numpy(), args.output_wav, cfg.audio.sample_rate)
    print(f"generated {len(mels)} windows -> {args.output_wav}")


def main(argv=None):
    args = parse_args(argv)
    {
        "capture": cmd_capture,
        "analyze": cmd_analyze,
        "watch": cmd_watch,
        "generate": cmd_generate,
    }[args.cmd](args)


if __name__ == "__main__":
    main(sys.argv[1:])

"""Mel-inversion CLI.

Counterpart of ``neural_sound_generation_tpu/cli/invert.py``. Reference
surface: ``python src/audio_tacotron.py <out_dir> <sample_rate> <fft_size>
<hop_size> <n_mels>`` (audio_tacotron.py:279-312): loads a saved time-major
mel ``.npy``, inverts it with pinv-mel + Griffin-Lim, and writes
``recon-...-{sr}-{fft}-{hop}-{mels}.wav``. The same positional surface,
plus ``--mel-file``, ``--seed`` (seeds a generator on the device),
``--output``, ``--gl-iters``, ``--gl-momentum`` and ``--device``.

    python -m neural_sound_generation_tpu_torch.cli.invert <out_dir> 22050 \\
        1024 256 80 --mel-file ljspeech-mel-00001.npy [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.ops import dsp


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Invert a saved mel .npy to a wav")
    p.add_argument("out_dir")
    p.add_argument("sample_rate", type=int)
    p.add_argument("fft_size", type=int)
    p.add_argument("hop_size", type=int)
    p.add_argument("n_mels", type=int)
    p.add_argument(
        "--mel-file", default="ljspeech-mel-00001.npy",
        help="mel filename inside out_dir (reference default, "
             "audio_tacotron.py:295)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None)
    p.add_argument("--gl-iters", type=int, default=60)
    p.add_argument("--gl-momentum", type=float, default=0.0,
                   help="fast Griffin-Lim extrapolation (0.99 typical; "
                        "0 = plain reference algorithm)")
    p.add_argument("--device", default="cuda",
                   help="torch device to invert on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = AudioConfig(
        sample_rate=args.sample_rate,
        fft_size=args.fft_size,
        hop_size=args.hop_size,
        num_mels=args.n_mels,
        fmax=min(7600.0, args.sample_rate / 2),
        griffin_lim_iters=args.gl_iters,
        griffin_lim_momentum=args.gl_momentum,
    )
    mel = np.load(os.path.join(args.out_dir, args.mel_file))
    mel = mel.T  # stored time-major; the chain expects (n_mels, frames)
    print(mel.shape)
    if mel.shape[0] != args.n_mels:
        raise SystemExit(f"{args.mel_file} has {mel.shape[0]} mels, expected {args.n_mels}")

    generator = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        signal = dsp.inv_mel_spectrogram(
            torch.from_numpy(np.ascontiguousarray(mel)).to(device), cfg, generator)
    stem = os.path.splitext(os.path.basename(args.mel_file))[0]
    out = args.output or (
        f"./recon-{stem}-{args.sample_rate}-{args.fft_size}-"
        f"{args.hop_size}-{args.n_mels}.wav"
    )
    dsp.save_wav(signal.cpu().numpy(), out, args.sample_rate)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])

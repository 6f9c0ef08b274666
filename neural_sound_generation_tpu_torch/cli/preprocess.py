"""Preprocessing CLI.

Counterpart of ``neural_sound_generation_tpu/cli/preprocess.py``, with the
same arguments plus ``--device``. Reference surface (src/preprocess.py:1-16,
docopt):

    preprocess.py [options] <name> <in_dir> <out_dir>

with --num_workers, --preset, --hparams, --sample_rate, --fft_size,
--hop_size, --n_mels. The corpus is dispatched by name from a registry,
the preset JSON overlays the config (src/preprocess.py:62-66), and a
train.txt manifest + hours summary is written (src/preprocess.py:32-45).

    python -m neural_sound_generation_tpu_torch.cli.preprocess ljspeech \\
        <LJSpeech-1.1> <out_dir> [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from neural_sound_generation_tpu_torch.config import Config, config_debug_string, load_preset
from neural_sound_generation_tpu_torch.data.corpora import CORPORA
from neural_sound_generation_tpu_torch.data.manifest import manifest_stats, write_manifest
from neural_sound_generation_tpu_torch.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Preprocess a speech corpus")
    p.add_argument("name", choices=sorted(CORPORA.keys()))
    p.add_argument("in_dir")
    p.add_argument("out_dir")
    p.add_argument("--num_workers", type=int, default=os.cpu_count())
    p.add_argument("--preset", type=str, default=None, help="preset JSON path")
    p.add_argument(
        "--hparams", type=str, default="", help="comma-separated key=value overrides"
    )
    p.add_argument("--sample_rate", type=int, default=None)
    p.add_argument("--fft_size", type=int, default=None)
    p.add_argument("--hop_size", type=int, default=None)
    p.add_argument("--n_mels", type=int, default=None)
    p.add_argument("--device_batch", type=int, default=16)
    p.add_argument("--skip-errors", action="store_true",
                   help="drop undecodable utterances with a warning")
    p.add_argument("--device", default="cuda",
                   help="torch device of the batch transform (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def preprocess(name, in_dir, out_dir, cfg: Config, num_workers, device_batch=16,
               skip_errors=False, device=None):
    mod = CORPORA[name]
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.time()
    entries = mod.build_from_path(
        in_dir, out_dir, num_workers=num_workers, cfg=cfg.audio,
        skip_errors=skip_errors, device=device, device_batch=device_batch,
    )
    dt = time.time() - t0
    write_metadata(entries, out_dir, cfg)
    stats = manifest_stats(entries, cfg.audio.sample_rate, cfg.audio.effective_hop_size)
    frames = stats["mel_frames"]
    print(
        f"Preprocessed {stats['utterances']} utterances "
        f"({stats['hours']:.2f} hours, {frames} mel frames) in {dt:.1f}s "
        f"({frames / max(dt, 1e-9):.0f} frames/sec)"
    )
    return entries


def write_metadata(entries, out_dir, cfg: Config):
    """train.txt + summary (src/preprocess.py:32-45)."""
    write_manifest(out_dir, entries)
    stats = manifest_stats(entries, cfg.audio.sample_rate, cfg.audio.effective_hop_size)
    print(
        "Wrote %d utterances, %d time steps (%.2f hours)"
        % (stats["utterances"], stats["total_timesteps"], stats["hours"])
    )
    print(
        "Max/min timesteps:",
        max((e.timesteps for e in entries), default=0),
        min((e.timesteps for e in entries), default=0),
    )


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = Config()
    if args.preset:
        cfg = load_preset(args.preset, cfg)
    if args.hparams:
        cfg = cfg.parse(args.hparams)
    overrides = {}
    for flag, key in [
        ("sample_rate", "sample_rate"),
        ("fft_size", "fft_size"),
        ("hop_size", "hop_size"),
        ("n_mels", "num_mels"),
    ]:
        value = getattr(args, flag)
        if value is not None:
            overrides[key] = value
    if overrides:
        cfg = cfg.parse_json(overrides)
    # the reference asserts the hparams bag is the vocoder one
    # (src/preprocess.py:67)
    if cfg.name != "vocoder":
        raise SystemExit(f"preprocessing needs the vocoder hparams, got name={cfg.name!r}")
    print(config_debug_string(cfg))
    return preprocess(
        args.name,
        args.in_dir,
        args.out_dir,
        cfg,
        args.num_workers,
        args.device_batch,
        skip_errors=args.skip_errors,
        device=device,
    )


if __name__ == "__main__":
    main(sys.argv[1:])

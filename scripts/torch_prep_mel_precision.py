#!/usr/bin/env python3
"""Float32 mels of the port's corpus preprocessing against float64, on one CUDA card.

Writes ``chip_smoke.py``'s two corpora (``write_prep_corpora``: 128
LJSpeech-length utterances at 22050 Hz, and a two-speaker cmu_arctic one at
16 kHz under the cmu_arctic_8bit settings), runs ``cli.preprocess`` on each
on the card, with ``--device cpu``, and on the card with TF32 matrix
products allowed (a lower-precision mel product, which the smoke's limits
must refuse), and prints for each run the errors of every batch's mels
against float64 from the same prepared blocks (``chip_smoke.mel_reference``):
``chip_smoke.mel_errors`` (above the floor, near it, and in linear magnitude
over each frame's largest) and the largest normalized error by the float64
level of the bin, in bands of 10 dB above the floor.

Run from the repository root: ``python3 scripts/torch_prep_mel_precision.py``.
One JSON line per corpus and run, each with the card's name and power
limit; fails without a CUDA device.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND_DB = 10


def bands(cfg) -> int:
    return int(-cfg.min_level_db) // BAND_DB


def by_level(torch, dsp, mels: np.ndarray, ref: np.ndarray, cfg) -> list:
    """The largest |mels - ref| in each BAND_DB band of the reference's
    level above the floor (the last band takes everything above it)."""
    db = torch.from_numpy(ref)
    db = dsp.denormalize_spectrogram(db, cfg) if cfg.signal_normalization else db
    level = (db - cfg.min_level_db).numpy()  # dB above the floor
    band = np.clip((level // BAND_DB).astype(int), 0, bands(cfg) - 1)
    err = np.abs(mels.astype(np.float64) - ref)
    return [float(err[band == b].max(initial=0.0)) for b in range(bands(cfg))]


def with_tf32(torch, transform):
    """``transform`` with TF32 matrix products allowed while it runs (the
    CLI sets full float32 when it resolves its device)."""
    def run(*args):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return transform(*args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
    return run


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from neural_sound_generation_tpu_torch.cli import preprocess as cli_preprocess
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.data.corpora import engine
    from neural_sound_generation_tpu_torch.data.corpora.engine import convention
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops import dsp

    if not torch.cuda.is_available():
        print("FAIL: a CUDA device is required", file=sys.stderr)
        return 1
    set_full_float32()
    card = cs.card_line()
    print(card, flush=True)
    root = os.path.join(ROOT, "build", "prep_mel_precision")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        lj_in, cmu_in = cs.write_prep_corpora(root)
        preset = os.path.join(root, "cmu_arctic_8bit.json")
        with open(preset, "w", encoding="utf-8") as f:
            json.dump(cs.CMU_PRESET, f)
        corpora = (("ljspeech", lj_in, [], Config().audio),
                   ("cmu_arctic", cmu_in, ["--preset", preset],
                    convention(Config().parse_json(cs.CMU_PRESET).audio)))
        for name, in_dir, flags, cfg in corpora:
            for run, device, tf32 in (("card", "cuda", False), ("cpu", "cpu", False),
                                      ("card_tf32", "cuda", True)):
                out_dir = os.path.join(root, f"{name}_{run}")
                real = engine._batch_transform
                if tf32:
                    engine._batch_transform = with_tf32(torch, real)
                try:
                    record, calls = cs.run_preprocess(
                        torch, cli_preprocess, engine,
                        [name, in_dir, out_dir, "--num_workers", "8", *flags], device)
                finally:
                    engine._batch_transform = real
                worst = {}
                by_band = np.zeros(bands(cfg))
                for call in calls:
                    ref = cs.mel_reference(torch, dsp, call["prepped"], cfg)
                    for k, v in cs.mel_errors(torch, dsp, call["mels"], ref, cfg).items():
                        worst[k] = max(worst.get(k, 0.0), v)
                    by_band = np.maximum(by_band, by_level(torch, dsp, call["mels"], ref, cfg))
                shutil.rmtree(out_dir, ignore_errors=True)
                print(json.dumps({
                    "corpus": name, "run": run, "batches": len(calls),
                    "mel_frames": record["mel_frames"], "errors_vs_float64": worst,
                    f"max_err_by_{BAND_DB}db_above_floor": by_band.tolist(),
                    "limits": {"above_floor": cs.PREP_MEL_ABOVE_FLOOR_ATOL,
                               "near_floor": cs.PREP_MEL_NEAR_FLOOR_ATOL,
                               "linear_over_frame_max": cs.PREP_MEL_LIN_REL},
                    "card": card}), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

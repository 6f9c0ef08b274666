"""Audio augmentation.

A copy of ``neural_sound_generation_tpu/utils/augment.py`` (numpy and
scipy only; ``NoiseInjection`` reads WAVs through the port's
``ops.dsp.load_wav``). It rebuilds the reference's sox-subprocess
augmentation (``src/util.py:86-196``: random tempo/gain perturbation, plus
SNR-controlled noise injection) in process: no temp files, no
subprocesses, deterministic under a seeded rng.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

import numpy as np
from scipy.signal import resample_poly


def change_tempo(wav: np.ndarray, rate: float) -> np.ndarray:
    """Time-stretch by ``rate`` (>1 = faster/shorter) via polyphase
    resampling — the capability of ``sox tempo`` (util.py:92-115) without
    the subprocess. NOTE: this also shifts pitch (like ``sox speed``);
    phase-vocoder pitch preservation is out of scope for parity."""
    if rate == 1.0:
        return np.asarray(wav, np.float32)
    # approximate the ratio with a small rational
    from fractions import Fraction

    frac = Fraction(rate).limit_denominator(100)
    up, down = frac.denominator, frac.numerator
    return resample_poly(np.asarray(wav, np.float64), up, down).astype(np.float32)


def change_gain(wav: np.ndarray, gain_db: float) -> np.ndarray:
    """Apply gain in dB (sox gain, util.py:116-134)."""
    return (np.asarray(wav, np.float32) * (10.0 ** (gain_db / 20.0))).astype(
        np.float32
    )


def augment_audio(
    wav: np.ndarray,
    rng: np.random.Generator,
    tempo_range: tuple = (0.85, 1.15),
    gain_range: tuple = (-6.0, 8.0),
) -> np.ndarray:
    """Random tempo + gain perturbation (the reference's ranges,
    util.py:137-161)."""
    tempo = float(rng.uniform(*tempo_range))
    gain = float(rng.uniform(*gain_range))
    return change_gain(change_tempo(wav, tempo), gain)


class NoiseInjection:
    """Mix recorded noise at a random SNR (util.py:164-196 semantics).

    ``noise_dir`` holds wav files; ``inject`` picks one, loops/crops it to
    length, and mixes at an SNR drawn from ``noise_levels`` (interpreted as
    noise/signal energy ratio bounds like the reference's levels)."""

    def __init__(
        self,
        noise_dir: Optional[str] = None,
        sample_rate: int = 22050,
        noise_levels: tuple = (0.0, 0.5),
        noises: Optional[Sequence[np.ndarray]] = None,
    ):
        from neural_sound_generation_tpu_torch.ops.dsp import load_wav

        self.sample_rate = sample_rate
        self.noise_levels = noise_levels
        if noises is not None:
            self.noises = [np.asarray(n, np.float32) for n in noises]
        elif noise_dir:
            paths = sorted(glob.glob(os.path.join(noise_dir, "*.wav")))
            self.noises = [load_wav(p, sample_rate) for p in paths]
        else:
            self.noises = []
        if not self.noises:
            raise ValueError("no noise sources provided")

    def inject(self, wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        noise = self.noises[int(rng.integers(len(self.noises)))]
        if len(noise) < len(wav):
            reps = int(np.ceil(len(wav) / len(noise)))
            noise = np.tile(noise, reps)
        start = int(rng.integers(0, len(noise) - len(wav) + 1))
        noise = noise[start : start + len(wav)]

        level = float(rng.uniform(*self.noise_levels))
        sig_energy = float(np.sum(wav**2)) + 1e-12
        noise_energy = float(np.sum(noise**2)) + 1e-12
        scale = np.sqrt(level * sig_energy / noise_energy)
        return (wav + scale * noise).astype(np.float32)

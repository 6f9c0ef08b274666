"""Mel filterbank construction (Slaney-style, librosa-compatible).

The reference builds its mel basis with ``librosa.filters.mel(sr, n_fft,
n_mels, fmin, fmax)`` (``src/audio_tacotron.py:208-219``), i.e. the Slaney
mel scale (htk=False) with Slaney area normalization. This module
re-derives that filterbank from the underlying math so the framework has
no librosa dependency; the matrix is precomputed on the host and used as
a plain matmul operand on the device.

A copy of ``neural_sound_generation_tpu/ops/mel.py`` (numpy only), kept in
the port so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# Slaney mel scale constants: linear below 1 kHz, logarithmic above.
_F_SP = 200.0 / 3.0  # Hz per mel in the linear region
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # = 15.0
_LOGSTEP = np.log(6.4) / 27.0  # step size in log region


def hz_to_mel(frequencies: np.ndarray) -> np.ndarray:
    """Slaney-scale Hz -> mel (librosa hz_to_mel with htk=False)."""
    frequencies = np.asarray(frequencies, dtype=np.float64)
    mels = frequencies / _F_SP
    log_region = frequencies >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL
        + np.log(np.maximum(frequencies, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray) -> np.ndarray:
    """Slaney-scale mel -> Hz (librosa mel_to_hz with htk=False)."""
    mels = np.asarray(mels, dtype=np.float64)
    freqs = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
        freqs,
    )
    return freqs


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """n_mels frequencies equally spaced on the Slaney mel scale."""
    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels)
    return mel_to_hz(mels)


def fft_frequencies(sample_rate: int, n_fft: int) -> np.ndarray:
    return np.linspace(0.0, sample_rate / 2.0, 1 + n_fft // 2)


def mel_basis(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft//2).

    Matches ``librosa.filters.mel(sr, n_fft, n_mels=n_mels, fmin=fmin,
    fmax=fmax)`` defaults (htk=False, norm='slaney') as consumed at
    ``src/audio_tacotron.py:215-219``.
    """
    if fmax > sample_rate / 2:
        raise ValueError(f"fmax={fmax} above Nyquist for sr={sample_rate}")
    fftfreqs = fft_frequencies(sample_rate, n_fft)
    # Band edges: n_mels + 2 points spanning [fmin, fmax] on the mel scale.
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)

    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization: each filter integrates to ~equal energy.
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(dtype)


def inv_mel_basis(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float,
    fmax: float,
    dtype=np.float32,
) -> np.ndarray:
    """Pseudo-inverse of the mel basis, shape (1 + n_fft//2, n_mels).

    Used for mel -> linear spectrogram inversion
    (``src/audio_tacotron.py:202-206``).
    """
    basis = mel_basis(sample_rate, n_fft, n_mels, fmin, fmax, dtype=np.float64)
    return np.linalg.pinv(basis).astype(dtype)

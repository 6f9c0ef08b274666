"""The audio transform chain in PyTorch: analysis, normalization, inversion.

Counterpart of ``neural_sound_generation_tpu/ops/dsp.py``: preemphasis ->
STFT -> mel -> amp_to_db -> normalize, and the way back through Griffin-Lim.
Functions take tensors on any device and keep them there. Where the JAX
package ``vmap``s over a batch, these functions accept leading batch
dimensions instead: a signal is (..., samples) and a spectrogram
(..., frames, bins) or (..., mels, frames), as in the JAX functions.

Mu-law companding and its inverse (the vocoder's output for ``mulaw`` and
``mulaw-quantize`` inputs) are here. The LWS convention (``cfg.use_lws``)
and silence trimming are not ported yet; ``use_lws=True`` raises.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.ops import mel as mel_lib

# ---------------------------------------------------------------------------
# Windows and framing
# ---------------------------------------------------------------------------


def hann_window(win_size: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window (scipy get_window('hann', N, fftbins=True))."""
    n = torch.arange(win_size, dtype=torch.float32, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_size)).to(dtype)


def _padded_window(win_size: int, fft_size: int, device) -> torch.Tensor:
    window = hann_window(win_size, device)
    if win_size < fft_size:
        lpad = (fft_size - win_size) // 2
        window = F.pad(window, (lpad, fft_size - win_size - lpad))
    return window


def num_stft_frames(length: int, fft_size: int, hop_size: int) -> int:
    """Frame count of a centered STFT (librosa convention)."""
    return 1 + (length + 2 * (fft_size // 2) - fft_size) // hop_size


def frame_signal(y: torch.Tensor, frame_length: int, hop_size: int) -> torch.Tensor:
    """(..., samples) already padded -> (..., n_frames, frame_length) view."""
    return y.unfold(-1, frame_length, hop_size)


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """``numpy.pad(mode="reflect")`` along the last axis, for any length.

    ``F.pad(mode="reflect")`` refuses a pad longer than the signal; numpy
    (and ``jnp.pad``) keep reflecting, which is the periodic extension with
    period 2 * (n - 1). A one-sample signal repeats its sample. The index
    is computed on ``y``'s device: Griffin-Lim pads every iteration."""
    n = y.shape[-1]
    idx = torch.arange(-pad, n + pad, device=y.device)
    if n == 1:
        return y[..., torch.zeros_like(idx)]
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return y[..., torch.where(idx >= n, period - idx, idx)]


# ---------------------------------------------------------------------------
# STFT / ISTFT (librosa convention: centered, reflect padding, hann)
# ---------------------------------------------------------------------------


def stft(
    y: torch.Tensor,
    fft_size: int,
    hop_size: int,
    win_size: int | None = None,
    center: bool = True,
) -> torch.Tensor:
    """Centered STFT: (..., samples) -> complex64 (..., n_frames, 1 + fft_size//2)."""
    win_size = win_size or fft_size
    if center:
        y = _reflect_pad(y, fft_size // 2)
    frames = frame_signal(y, fft_size, hop_size)
    window = _padded_window(win_size, fft_size, y.device)
    return torch.fft.rfft(frames * window, dim=-1)


def istft(
    spec: torch.Tensor,
    fft_size: int,
    hop_size: int,
    win_size: int | None = None,
    length: int | None = None,
) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add with window-sum-square
    normalization (librosa.istft convention, centered).

    ``spec``: complex (..., n_frames, 1 + fft_size//2). Returns float32
    (..., length) with ``length`` defaulting to hop_size * (n_frames - 1).
    """
    win_size = win_size or fft_size
    lead = spec.shape[:-2]
    n_frames = spec.shape[-2]
    window = _padded_window(win_size, fft_size, spec.device)
    frames = torch.fft.irfft(spec, n=fft_size, dim=-1) * window
    full_len = fft_size + hop_size * (n_frames - 1)

    def overlap_add(cols: torch.Tensor) -> torch.Tensor:
        # cols: (B, fft_size, n_frames) -> (B, full_len)
        out = F.fold(
            cols,
            output_size=(1, full_len),
            kernel_size=(1, fft_size),
            stride=(1, hop_size),
        )
        return out.reshape(cols.shape[0], full_len)

    y = overlap_add(frames.reshape(-1, n_frames, fft_size).transpose(1, 2))
    wss = overlap_add((window**2)[None, :, None].expand(1, fft_size, n_frames))
    y = torch.where(wss > 1e-10, y / torch.clamp(wss, min=1e-10), y)

    pad = fft_size // 2
    y = y[:, pad : full_len - pad]
    if length is not None:
        if length > y.shape[-1]:
            y = F.pad(y, (0, length - y.shape[-1]))
        else:
            y = y[:, :length]
    return y.reshape(*lead, y.shape[-1])


# ---------------------------------------------------------------------------
# Pre-emphasis
# ---------------------------------------------------------------------------


def preemphasis(wav: torch.Tensor, k: float, preemphasize: bool = True) -> torch.Tensor:
    """FIR pre-emphasis: y[n] = x[n] - k*x[n-1] (scipy lfilter([1,-k],[1],x))."""
    if not preemphasize:
        return wav
    shifted = F.pad(wav[..., :-1], (1, 0))
    return wav - k * shifted


def inv_preemphasis(
    wav: torch.Tensor, k: float, inv_preemphasize: bool = True
) -> torch.Tensor:
    """IIR de-emphasis y[n] = x[n] + k*y[n-1] (scipy lfilter([1],[1,-k],x)).

    A log-depth doubling scan instead of a loop over samples: after step s,
    y[i] holds sum_{j < 2^s} k^j x[i-j], and step s adds k^(2^s) y[i-2^s].
    The loop stops once k^(2^s) rounds to zero in float32, where further
    steps would add exact zeros."""
    if not inv_preemphasize:
        return wav
    y = wav
    n = wav.shape[-1]
    step, coef = 1, float(k)
    while step < n and np.float32(coef) != 0.0:
        y = torch.cat([y[..., :step], y[..., step:] + coef * y[..., :-step]], dim=-1)
        step, coef = 2 * step, coef * coef
    return y


# ---------------------------------------------------------------------------
# dB scaling and normalization
# ---------------------------------------------------------------------------


def amp_to_db(x: torch.Tensor, min_level_db: float) -> torch.Tensor:
    min_level = float(np.exp(min_level_db / 20 * np.log(10)))
    return 20.0 * torch.log10(torch.clamp(x, min=min_level))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize_spectrogram(S: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """dB spectrogram -> normalized range (audio_tacotron.py:228-240)."""
    m = cfg.max_abs_value
    mdb = cfg.min_level_db
    if cfg.symmetric_mels:
        scaled = (2 * m) * ((S - mdb) / (-mdb)) - m
        return torch.clamp(scaled, -m, m) if cfg.allow_clipping_in_normalization else scaled
    scaled = m * ((S - mdb) / (-mdb))
    return torch.clamp(scaled, 0, m) if cfg.allow_clipping_in_normalization else scaled


def denormalize_spectrogram(D: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Inverse of normalize_spectrogram (audio_tacotron.py:242-254)."""
    m = cfg.max_abs_value
    mdb = cfg.min_level_db
    if cfg.symmetric_mels:
        if cfg.allow_clipping_in_normalization:
            D = torch.clamp(D, -m, m)
        return ((D + m) * -mdb / (2 * m)) + mdb
    if cfg.allow_clipping_in_normalization:
        D = torch.clamp(D, 0, m)
    return (D * -mdb / m) + mdb


# ---------------------------------------------------------------------------
# Spectrogram chains
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _mel_matrices(sample_rate, fft_size, num_mels, fmin, fmax, device):
    """(mel basis, its pseudo-inverse) on ``device``; callers never mutate."""
    args = (sample_rate, fft_size, num_mels, fmin, fmax)
    return (
        torch.as_tensor(mel_lib.mel_basis(*args), device=device),
        torch.as_tensor(mel_lib.inv_mel_basis(*args), device=device),
    )


def _mels(cfg: AudioConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    return _mel_matrices(
        cfg.sample_rate, cfg.fft_size, cfg.num_mels, cfg.fmin, cfg.fmax,
        torch.device(device),
    )


def _check_no_lws(cfg: AudioConfig) -> None:
    if cfg.use_lws:
        raise NotImplementedError("the LWS convention (use_lws) is not ported yet")


def melspectrogram(wav: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """Normalized mel dB spectrogram: (..., samples) -> (..., num_mels, n_frames).

    Parity target: ``src/audio_tacotron.py:70-78`` with the librosa-centered
    STFT (the reference tacotron default, use_lws=False)."""
    _check_no_lws(cfg)
    y = preemphasis(wav, cfg.preemphasis, cfg.preemphasize)
    D = stft(y, cfg.fft_size, cfg.effective_hop_size, cfg.effective_win_size)
    basis, _ = _mels(cfg, wav.device)
    mel_mag = torch.abs(D) @ basis.T
    S = amp_to_db(mel_mag, cfg.min_level_db) - cfg.ref_level_db
    if cfg.signal_normalization:
        S = normalize_spectrogram(S, cfg)
    return S.transpose(-1, -2)


def melspectrogram_batch(wavs: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """(B, T) padded waveforms -> (B, num_mels, n_frames)."""
    if wavs.ndim != 2:
        raise ValueError(f"expected (B, T) waveforms, got {tuple(wavs.shape)}")
    return melspectrogram(wavs, cfg)


def random_angles(
    shape, generator: torch.Generator | None = None, device=None
) -> torch.Tensor:
    """Griffin-Lim's initial phase: 2*pi*U[0, 1) of ``shape``, drawn from
    ``generator`` (which lives on ``device``)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return 2.0 * math.pi * u


def griffin_lim(
    S: torch.Tensor,
    cfg: AudioConfig,
    generator: torch.Generator | None = None,
    n_iters: int | None = None,
    momentum: float = 0.0,
    init_angles: torch.Tensor | None = None,
) -> torch.Tensor:
    """Griffin-Lim phase reconstruction.

    ``S``: magnitude spectrogram (..., n_frames, n_freq). The initial phase
    is ``init_angles`` (radians, broadcastable to ``S``) when given, else
    drawn from ``generator``. ``momentum`` > 0 enables fast Griffin-Lim
    (Perraudin et al. 2013): the projection is extrapolated by
    ``momentum``/(1+``momentum``). A zero STFT bin keeps phase 0, as
    ``exp(1j * angle(0))`` does in JAX.
    """
    n_iters = cfg.griffin_lim_iters if n_iters is None else n_iters
    fft_size, hop = cfg.fft_size, cfg.effective_hop_size
    if init_angles is None:
        init_angles = random_angles(S.shape, generator, S.device)
    mag = torch.abs(S).to(torch.float32)
    y = istft(torch.polar(mag, init_angles.expand_as(mag)), fft_size, hop)

    if momentum <= 0.0:
        for _ in range(n_iters):
            D = stft(y, fft_size, hop)
            y = istft(torch.polar(mag, torch.angle(D)), fft_size, hop)
        return y

    alpha = momentum / (1.0 + momentum)
    t_prev = None  # the JAX loop starts from t_prev = stft(y0), so t_ex = t
    for _ in range(n_iters):
        t = stft(y, fft_size, hop)
        t_ex = t if t_prev is None else t + alpha * (t - t_prev)
        y = istft(torch.polar(mag, torch.angle(t_ex)), fft_size, hop)
        t_prev = t
    return y


def inv_mel_spectrogram(
    mel_spectrogram: torch.Tensor,
    cfg: AudioConfig,
    generator: torch.Generator | None = None,
    init_angles: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mel dB spectrogram (..., num_mels, n_frames) -> waveform (..., samples).

    Parity target: ``src/audio_tacotron.py:99-116``: denormalize ->
    db_to_amp -> pinv mel basis -> power -> Griffin-Lim -> inverse
    preemphasis. ``generator``/``init_angles`` set Griffin-Lim's initial
    phase (see ``griffin_lim``)."""
    _check_no_lws(cfg)
    D = mel_spectrogram
    if cfg.signal_normalization:
        D = denormalize_spectrogram(D, cfg)
    amp = db_to_amp(D + cfg.ref_level_db)  # (..., n_mels, T)
    _, inv_basis = _mels(cfg, D.device)
    S = torch.clamp(inv_basis @ amp, min=1e-10)  # (..., n_freq, T)
    y = griffin_lim(
        (S**cfg.power).transpose(-1, -2), cfg, generator,
        momentum=cfg.griffin_lim_momentum, init_angles=init_angles,
    )
    return inv_preemphasis(y, cfg.preemphasis, cfg.preemphasize)


def inv_mel_spectrogram_batch(
    mels: torch.Tensor,
    cfg: AudioConfig,
    generator: torch.Generator | None = None,
    init_angles: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, num_mels, T) -> (B, samples)."""
    if mels.ndim != 3:
        raise ValueError(f"expected (B, num_mels, T) mels, got {tuple(mels.shape)}")
    return inv_mel_spectrogram(mels, cfg, generator, init_angles)


# ---------------------------------------------------------------------------
# Mu-law (nnmnkwii.preprocessing semantics, as called by src/ljspeech.py:42-53)
# ---------------------------------------------------------------------------


def mulaw(x: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """Mu-law companding to [-1, 1]. The reference passes ``mu =
    quantize_channels`` (256 or 65536), not ``quantize_channels - 1``."""
    mu = float(mu)
    return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / math.log1p(mu)


def inv_mulaw(y: torch.Tensor, mu: int = 256) -> torch.Tensor:
    mu = float(mu)
    return torch.sign(y) * (1.0 / mu) * ((1.0 + mu) ** torch.abs(y) - 1.0)


def mulaw_quantize(x: torch.Tensor, mu: int = 256) -> torch.Tensor:
    """Mu-law + quantize to integers in [0, mu] (truncation toward zero)."""
    return ((mulaw(x, mu) + 1) / 2 * mu).to(torch.int32)


def inv_mulaw_quantize(y: torch.Tensor, mu: int = 256) -> torch.Tensor:
    return inv_mulaw(2.0 * y.to(torch.float32) / mu - 1.0, mu)


# ---------------------------------------------------------------------------
# Host-side WAV I/O (src/audio_tacotron.py:12-21 semantics, sans librosa)
# ---------------------------------------------------------------------------


def save_wav(wav: np.ndarray, path: str, sample_rate: int) -> None:
    """Peak-scale to int16 and write (src/audio_tacotron.py:15-18)."""
    from scipy.io import wavfile

    wav = np.asarray(wav, dtype=np.float32)
    wav = wav * (32767 / max(0.01, float(np.max(np.abs(wav)))))
    wavfile.write(path, sample_rate, wav.astype(np.int16))


def _decode_pcm(file_sr: int, data: np.ndarray, sample_rate: int) -> np.ndarray:
    """PCM array (any WAV dtype) -> mono float32 in [-1, 1] at
    ``sample_rate`` (polyphase resample when the file rate differs)."""
    from scipy.signal import resample_poly

    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if file_sr != sample_rate:
        g = np.gcd(int(file_sr), int(sample_rate))
        data = resample_poly(data, sample_rate // g, file_sr // g).astype(np.float32)
    return data


def load_wav(path: str, sample_rate: int) -> np.ndarray:
    """Read a WAV as float32 in [-1, 1]; resamples with polyphase filtering
    if the file rate differs (librosa.core.load semantics, scipy backend)."""
    from scipy.io import wavfile

    file_sr, data = wavfile.read(path)
    return _decode_pcm(file_sr, data, sample_rate)


def load_wav_bytes(wav_bytes: bytes, sample_rate: int) -> np.ndarray:
    """RIFF bytes -> mono float32 in [-1, 1] at ``sample_rate`` — the
    in-memory twin of ``load_wav`` (same dtype scaling and resampling)."""
    import io

    from scipy.io import wavfile

    file_sr, data = wavfile.read(io.BytesIO(wav_bytes))
    return _decode_pcm(file_sr, data, sample_rate)

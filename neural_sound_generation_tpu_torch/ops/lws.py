"""LWS in PyTorch: the lws STFT framing convention and Local Weighted Sums
phase estimation.

Counterpart of ``neural_sound_generation_tpu/ops/lws.py``. The reference's
wavenet-variant audio chain is LWS-only (``src/audio.py:112-127``:
``lws.lws(fft_size, hop_size, mode="speech")``; analysis by
``processor.stft``, inversion by ``processor.run_lws`` then
``processor.istft``), and it feeds the cmu_arctic, jsut and librivox
preprocessors. This is a native implementation of both halves; it needs no
``lws`` package.

- **Framing**: the signal is zero-padded by ``fsize - fshift`` on the left
  and enough on the right to complete the last frame (``lws_num_frames``,
  ``lws_pad_lr`` in ``ops/dsp.py``). Every real sample sits under full
  window overlap, so a dual-window pair reconstructs exactly with no
  window-sum-square division.
- **Windows**: analysis is the periodic sqrt-Hann (lws's default for a
  scalar window size), synthesis its canonical dual
  ``awin / sum_q awin^2(t - q*fshift)``.
- **Phase estimation** (Le Roux, Kameoka, Ono & Sagayama, DAFx 2010): the
  consistency projection G = STFT o ISTFT expanded into local weighted sums
  over frame offsets q and frequency offsets k,

      (Gz)[m, w] = sum_{q,k} W[q, k] * exp(-2i*pi*(w-k)*q*H/N) * z[m+q, w-k]
      W[q, k]    = (1/N) * sum_u awin[u] * swin[u - q*H] * exp(-2i*pi*k*u/N)

  truncated to |k| <= k_radius (lws's ``L = 2*k_radius + 1``, default 5).
  Each iteration snaps magnitudes back to the target: z <- |S| * phase(Gz).
  The updates are synchronous (Jacobi): every bin is updated from the same
  iterate, where the C library updates bins in place one after another
  (Gauss-Seidel, by magnitude). Both iterate toward the same consistency
  fixed point; the order changes only the path. Initial phase zero; the
  phase of g is g / max(|g|, 1e-12).

Functions take tensors on any device and keep them there, with leading
batch dimensions: a signal is (..., samples), a spectrogram (..., frames,
1 + fsize//2). The weighted sums are plain tensor operations, 35 shifted
terms an iteration at fft 1024 / hop 256, launched one by one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from neural_sound_generation_tpu_torch.ops.dsp import frame_signal, lws_pad_lr

__all__ = [
    "lws_windows",
    "lws_stft",
    "lws_stft_prepadded",
    "lws_istft",
    "lws_kernel_weights",
    "lws_apply_kernel",
    "run_lws",
]


@functools.lru_cache(maxsize=None)
def _windows_np(fsize: int, fshift: int) -> tuple[np.ndarray, np.ndarray]:
    if fsize % fshift != 0:
        raise ValueError(f"lws requires fshift | fsize, got {fsize}, {fshift}")
    n = np.arange(fsize)
    awin = np.sqrt(0.5 * (1.0 - np.cos(2.0 * np.pi * n / fsize)))
    # canonical dual: swin = awin / sum_q awin^2(t - q*fshift); for the
    # periodic sqrt-Hann with fshift | fsize the denominator is the
    # constant fsize / (2 * fshift) at every t
    ola = np.zeros(fsize)
    for q in range(-(fsize // fshift) + 1, fsize // fshift):
        lo, hi = max(0, q * fshift), min(fsize, fsize + q * fshift)
        src = awin[lo - q * fshift : hi - q * fshift]
        ola[lo:hi] += src**2
    swin = awin / ola
    return awin.astype(np.float64), swin.astype(np.float64)


def lws_windows(fsize: int, fshift: int) -> tuple[np.ndarray, np.ndarray]:
    """(analysis, synthesis) window pair of the speech-mode processor."""
    return _windows_np(fsize, fshift)


def _window(fsize: int, fshift: int, which: int, device) -> torch.Tensor:
    return torch.as_tensor(_windows_np(fsize, fshift)[which], device=device).to(torch.float32)


def lws_stft_prepadded(p: torch.Tensor, fsize: int, fshift: int) -> torch.Tensor:
    """LWS STFT of a signal already padded with ``lws_pad_lr``'s zeros
    (the batched preprocessing engine pads each utterance on the host;
    trailing zero-fill to the bucket length only adds frames of zeros)."""
    frames = frame_signal(p, fsize, fshift)
    return torch.fft.rfft(frames * _window(fsize, fshift, 0, p.device), dim=-1)


def lws_stft(y: torch.Tensor, fsize: int, fshift: int) -> torch.Tensor:
    """LWS-convention STFT: (..., n) -> (..., lws_num_frames(n), 1 + fsize//2)."""
    pad_l, pad_r = lws_pad_lr(y.shape[-1], fsize, fshift)
    return lws_stft_prepadded(F.pad(y, (pad_l, pad_r)), fsize, fshift)


def lws_istft(
    spec: torch.Tensor, fsize: int, fshift: int, length: int | None = None
) -> torch.Tensor:
    """Linear inverse of ``lws_stft``: synthesis-windowed overlap-add, then
    the lws left-pad crop. Returns (..., fshift * n_frames) samples, or the
    first ``length``."""
    lead = spec.shape[:-2]
    n_frames = spec.shape[-2]
    frames = torch.fft.irfft(spec, n=fsize, dim=-1).to(torch.float32)
    frames = frames * _window(fsize, fshift, 1, spec.device)
    full_len = fsize + fshift * (n_frames - 1)
    cols = frames.reshape(-1, n_frames, fsize).transpose(1, 2)
    y = F.fold(cols, output_size=(1, full_len), kernel_size=(1, fsize),
               stride=(1, fshift)).reshape(-1, full_len)
    y = y[:, fsize - fshift :]
    if length is not None:
        y = y[:, :length]
    return y.reshape(*lead, y.shape[-1])


@functools.lru_cache(maxsize=None)
def _kernel_np(fsize: int, fshift: int, k_radius: int) -> np.ndarray:
    """W[q, k]: complex weights, shape (2*Q+1, 2*k_radius+1) with
    Q = fsize//fshift - 1 (window overlap reach). Derived exactly from
    the analysis/synthesis window pair; no tuning constants."""
    awin, swin = _windows_np(fsize, fshift)
    q_max = fsize // fshift - 1
    ks = np.arange(-k_radius, k_radius + 1)
    u = np.arange(fsize)
    weights = np.zeros((2 * q_max + 1, 2 * k_radius + 1), np.complex128)
    for qi, q in enumerate(range(-q_max, q_max + 1)):
        # swin shifted by q*fshift, zero outside [0, fsize)
        sh = np.zeros(fsize)
        lo, hi = max(0, q * fshift), min(fsize, fsize + q * fshift)
        sh[lo:hi] = swin[lo - q * fshift : hi - q * fshift]
        prod = awin * sh
        for ki, k in enumerate(ks):
            weights[qi, ki] = np.sum(prod * np.exp(-2j * np.pi * k * u / fsize)) / fsize
    return weights.astype(np.complex64)


def lws_kernel_weights(fsize: int, fshift: int, k_radius: int = 2) -> np.ndarray:
    return _kernel_np(fsize, fshift, k_radius)


def _freq_shift(v: torch.Tensor, k: int) -> torch.Tensor:
    """(shift_k v)[w] = v[w - k] over the half-spectrum of a real signal,
    extending past the edges by conjugate symmetry (v[-j] = conj(v[j]),
    v[N/2 + j] = conj(v[N/2 - j]))."""
    if k == 0:
        return v
    n_freq = v.shape[-1]  # 1 + N/2
    if k > 0:
        head = torch.conj_physical(v[..., 1 : k + 1]).flip(-1)  # v[-k..-1]
        return torch.cat([head, v[..., : n_freq - k]], dim=-1)
    k = -k
    tail = torch.conj_physical(v[..., n_freq - 1 - k : n_freq - 1]).flip(-1)  # past Nyquist
    return torch.cat([v[..., k:], tail], dim=-1)


@functools.lru_cache(maxsize=16)
def _ramps(fsize: int, fshift: int, n_freq: int, device) -> torch.Tensor:
    """ramp_q[w] = exp(-2i pi w q H / N) for q = -Q..Q, (2Q+1, n_freq)
    complex64, each phase reduced modulo N in integers and evaluated in
    float64 before the cast; callers never mutate it."""
    q_max = fsize // fshift - 1
    q = np.arange(-q_max, q_max + 1)[:, None]
    w = np.arange(n_freq)[None, :]
    phase = -2.0 * np.pi * ((w * q * fshift) % fsize) / fsize
    return torch.as_tensor(np.exp(1j * phase).astype(np.complex64), device=device)


def lws_apply_kernel(
    z: torch.Tensor, fsize: int, fshift: int, k_radius: int = 2
) -> torch.Tensor:
    """Truncated consistency projection (Gz) by local weighted sums.

    ``z``: complex (..., n_frames, 1 + fsize//2). Out-of-range frames are
    zero (the lws boundary convention)."""
    n_frames = z.shape[-2]
    W = _kernel_np(fsize, fshift, k_radius)
    q_max = fsize // fshift - 1
    ramps = _ramps(fsize, fshift, z.shape[-1], z.device)
    zp = F.pad(z, (0, 0, q_max, q_max))
    out = torch.zeros_like(z)
    for qi in range(2 * q_max + 1):
        # the ramp is applied at index w - k, so it is folded into v before
        # the frequency shift
        v = ramps[qi] * zp[..., qi : qi + n_frames, :]
        for ki, k in enumerate(range(-k_radius, k_radius + 1)):
            out = out + complex(W[qi, ki]) * _freq_shift(v, k)
    return out


def run_lws(
    S: torch.Tensor,
    fsize: int,
    fshift: int,
    iterations: int = 100,
    k_radius: int = 2,
) -> torch.Tensor:
    """Phase estimation from a magnitude spectrogram (``processor.run_lws``):
    complex (..., n_frames, 1 + fsize//2) with the input magnitudes and
    LWS-estimated phases. Zero-phase init, ``iterations`` Jacobi sweeps of
    z <- |S| * phase(Gz)."""
    mag = torch.abs(S).to(torch.float32)
    z = mag.to(torch.complex64)
    for _ in range(iterations):
        g = lws_apply_kernel(z, fsize, fshift, k_radius)
        z = mag * (g / torch.clamp(torch.abs(g), min=1e-12))
    return z


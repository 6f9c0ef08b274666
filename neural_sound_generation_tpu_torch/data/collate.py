"""Batch collation with static shapes.

Rebuilds the reference collate (dataloader.py:324-434): hop-aligned random
crop to ``max_time_steps``, padding, mu-law one-hot branch, returning
(x, y, c, g, input_lengths). TPU-first difference: the output shape is
*fully static* — every batch is padded/cropped to the same
(frames, samples) so XLA compiles one program — and the mel frame count is
a multiple of the VQ-VAE's total stride (4), which removes the reference's
decoder-width mismatch hack (train.py:118-120).

A copy of ``neural_sound_generation_tpu/data/collate.py`` (no JAX in it), kept
in the port so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from neural_sound_generation_tpu_torch.config import AudioConfig


def ensure_divisible(length: int, divisible_by: int = 256, lower: bool = True) -> int:
    """dataloader.py:310-317."""
    if length % divisible_by == 0:
        return length
    if lower:
        return length - length % divisible_by
    return length + (divisible_by - length % divisible_by)


def static_crop_frames(
    max_time_steps: Optional[int], hop_size: int, latent_stride: int = 4
) -> int:
    """Static mel-frame count per batch item: max_time_steps rounded down
    to a hop multiple, then to a multiple of the encoder stride."""
    if max_time_steps is None:
        raise ValueError("static batching requires max_time_steps")
    steps = ensure_divisible(max_time_steps, hop_size, lower=True)
    frames = steps // hop_size
    frames -= frames % latent_stride
    if frames <= 0:
        raise ValueError(
            f"max_time_steps={max_time_steps} too small for hop={hop_size} "
            f"and stride={latent_stride}"
        )
    return frames


def _mulaw_quantize_np(x, mu):
    y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return ((y + 1) / 2 * mu).astype(np.int64)


def collate_mel_batch(
    items: Sequence[Tuple[np.ndarray, np.ndarray, Optional[int]]],
    cfg: AudioConfig,
    max_time_steps: Optional[int] = 8000,
    rng: Optional[np.random.Generator] = None,
    latent_stride: int = 4,
    frames_out: Optional[int] = None,
    one_hot: bool = True,
) -> Dict[str, np.ndarray]:
    """items: list of (audio (T,), mel (frames, n_mels), speaker_id|None).

    Returns a dict of static-shape arrays:
      x: waveform input (B, S, 1) float32, or one-hot (B, S, Q) for
         mulaw-quantize (dataloader.py:391-400)
      y: target waveform (B, S) float32 / int64
      c: mel conditioning (B, n_mels, F) float32
      g: speaker ids (B,) int32 or None
      input_lengths: true (uncropped/unpadded) lengths in samples

    ``frames_out`` overrides the static crop size — used by bucketed
    batching (DataConfig.bucket_boundaries), where each batch is padded
    only to its bucket's frame count instead of the global maximum.
    """
    rng = rng or np.random.default_rng()
    hop = cfg.effective_hop_size
    if frames_out is None:
        frames_out = static_crop_frames(max_time_steps, hop, latent_stride)
    samples_out = frames_out * hop

    if cfg.is_mulaw_quantize:
        pad_value = int(_mulaw_quantize_np(np.float64(0.0), cfg.quantize_channels))
    else:
        pad_value = 0.0

    xs, cs, gs, lengths = [], [], [], []
    for audio, mel, g in items:
        audio = np.asarray(audio)
        mel = np.asarray(mel)
        n_frames = mel.shape[0]
        usable = min(len(audio) // hop, n_frames)
        # length of audio actually placed in the batch: the crop branch
        # fills all samples_out, the pad branch copies usable*hop — NOT
        # min(len(audio), samples_out), which would count up to hop-1
        # (or, with n_frames-capped utterances, arbitrarily many) pad
        # samples as real audio inside the loss mask
        lengths.append(min(usable, frames_out) * hop)
        if usable > frames_out:
            s = int(rng.integers(0, usable - frames_out))
            mel_c = mel[s : s + frames_out]
            aud_c = audio[s * hop : (s + frames_out) * hop]
        else:
            mel_c = np.pad(
                mel[:usable], [(0, frames_out - usable), (0, 0)], mode="constant"
            )
            aud = audio[: usable * hop]
            aud_c = np.pad(
                aud,
                (0, samples_out - len(aud)),
                mode="constant",
                constant_values=pad_value,
            )
        xs.append(aud_c)
        cs.append(mel_c)
        gs.append(g)

    c = np.stack(cs).astype(np.float32).transpose(0, 2, 1)  # (B, n_mels, F)
    y = np.stack(xs)
    if cfg.is_mulaw_quantize:
        y = y.astype(np.int64)
        # one-hot x matches the reference collate contract
        # (dataloader.py:391-400); the framework's own models embed the
        # int targets instead, so internal loaders pass one_hot=False and
        # skip materializing (B, S, Q) float32 on host.
        if one_hot:
            x = np.eye(cfg.quantize_channels, dtype=np.float32)[
                np.clip(y, 0, cfg.quantize_channels - 1)
            ]  # (B, S, Q)
        else:
            x = y.astype(np.int32)
    else:
        y = y.astype(np.float32)
        x = y[..., None]

    has_speakers = all(g is not None for g in gs) and len(gs) > 0
    return {
        "x": x,
        "y": y,
        "c": c,
        "g": np.asarray(gs, np.int32) if has_speakers else None,
        "input_lengths": np.asarray(lengths, np.int32),
    }


def as_wave_batch(batch: Dict[str, np.ndarray], cfg: AudioConfig) -> Dict[str, np.ndarray]:
    """Adapter for the raw-waveform family (WaveVQVAE): scalar input modes
    feed (B, S, 1) floats; mulaw-quantize feeds the int targets directly
    (the model embeds them)."""
    if cfg.is_mulaw_quantize:
        out = {"x": batch["y"].astype(np.int32)}
    else:
        out = {"x": batch["y"].astype(np.float32)[..., None]}
    out["input_lengths"] = batch["input_lengths"]
    if batch.get("g") is not None:
        out["g"] = batch["g"]
    return out


def as_model_batch(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Adapter: reference training feeds the mel ``c`` into the
    autoencoder as a 1-channel image (train.py:115: ``c.unsqueeze(1)``);
    in NHWC that is (B, n_mels, F, 1)."""
    out = {"x": batch["c"][..., None]}
    if batch.get("g") is not None:
        out["g"] = batch["g"]
    return out

"""Batched inference: unit extraction, reconstruction, and prior sampling
to code grids, mels and audio.

Counterpart of ``neural_sound_generation_tpu/inference/audio.py`` for the
flat mel VQ-VAE and the ``TransformerPrior`` (``audio.py:57-156``). The
JAX functions take a module and its variables; the port's modules hold
their weights (in eval mode, as the JAX calls pass ``train=False``), and
the random draws come from an explicit ``torch.Generator`` on the model's
device instead of a PRNG key. Synthesis is the mel inversion of
``ops/dsp.py``: Griffin-Lim, or LWS under ``cfg.use_lws``. The PixelCNN
sampler and the hierarchical chain come with later slices.
"""

from __future__ import annotations

import torch

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.models import VQVAE, TransformerPrior
from neural_sound_generation_tpu_torch.models.transformer_prior import generate
from neural_sound_generation_tpu_torch.ops import dsp


@torch.inference_mode()
def extract_units(model: VQVAE, mels: torch.Tensor) -> torch.Tensor:
    """Mel batch (B, num_mels, frames, 1) -> discrete unit grid
    (B, num_mels/4, frames/4): the ZeroSpeech-style unit extraction (the
    encoder downsamples both spatial axes by 4, in input order)."""
    return model.encode(mels)


@torch.inference_mode()
def reconstruct_audio(
    model: VQVAE, mels: torch.Tensor, cfg: AudioConfig,
    generator: torch.Generator | None = None, g: torch.Tensor | None = None,
    init_angles: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mel batch -> (reconstructed mel batch (B, num_mels, frames), waveform
    batch). ``generator`` draws Griffin-Lim's initial phases, or
    ``init_angles`` gives them."""
    x_tilde, _, _ = model(mels, g=g)
    mel_batch = x_tilde[..., 0]
    return mel_batch, dsp.inv_mel_spectrogram_batch(mel_batch, cfg, generator, init_angles)


@torch.inference_mode()
def codes_to_audio(
    model: VQVAE, indices: torch.Tensor, cfg: AudioConfig,
    generator: torch.Generator | None = None, g: torch.Tensor | None = None,
    init_angles: torch.Tensor | None = None,
) -> torch.Tensor:
    """Discrete code grids (B, H', W') -> waveforms through the decoder and
    the mel inversion (phases as in ``reconstruct_audio``)."""
    mel = model.decode(indices, g=g)[..., 0]
    return dsp.inv_mel_spectrogram_batch(mel, cfg, generator, init_angles)


@torch.inference_mode()
def sample_prior_mels(
    model: VQVAE, prior: TransformerPrior, labels: torch.Tensor, code_shape: tuple[int, int],
    generator: torch.Generator | None = None, g: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The prior samples code grids, the decoder turns them into mels:
    (codes (B, H', W'), mels (B, num_mels, frames)). ``g``: speaker ids for
    a speaker-conditioned decoder."""
    codes = generate(prior, labels, generator, shape=code_shape,
                     batch_size=int(labels.shape[0]))
    return codes, model.decode(codes, g=g)[..., 0]


@torch.inference_mode()
def sample_prior_audio(
    model: VQVAE, prior: TransformerPrior, labels: torch.Tensor, code_shape: tuple[int, int],
    cfg: AudioConfig, generator: torch.Generator | None = None,
    g: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole generative path: prior -> decoder -> Griffin-Lim.
    Returns (code grids, waveforms); one generator draws both in turn."""
    codes, mels = sample_prior_mels(model, prior, labels, code_shape, generator, g=g)
    return codes, dsp.inv_mel_spectrogram_batch(mels, cfg, generator)

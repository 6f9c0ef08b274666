"""Batched inference: unit extraction, reconstruction, and prior sampling
to code grids, mels and audio.

Counterpart of ``neural_sound_generation_tpu/inference/audio.py``: the
flat mel VQ-VAE with either prior family (``prior_generate`` dispatches to
the ``TransformerPrior``'s KV-cached sampler or the ``GatedPixelCNN``'s
row-cached one), and the hierarchical chain (a top prior, a bottom prior
conditioned on the top codes through ``hier_cond_map``, the
``HierVQVAE``'s decoder). The JAX functions take a module and its
variables; the port's modules hold their weights (in eval mode, as the JAX
calls pass ``train=False``), and the random draws come from an explicit
``torch.Generator`` on the model's device instead of a PRNG key. Where the
JAX chain splits one key three ways (top, bottom, Griffin-Lim), one
generator draws the three in that order; the tests inject each prior's
noise instead. Synthesis is the mel inversion of ``ops/dsp.py``:
Griffin-Lim, or LWS under ``cfg.use_lws``.
"""

from __future__ import annotations

import torch

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.models import (
    VQVAE,
    GatedPixelCNN,
    HierVQVAE,
    TransformerPrior,
)
from neural_sound_generation_tpu_torch.models import pixelcnn
from neural_sound_generation_tpu_torch.models import transformer_prior
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.ops.vq import codebook_lookup

Prior = TransformerPrior | GatedPixelCNN


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


def prior_generate(prior: Prior, labels: torch.Tensor, generator: torch.Generator | None = None,
                   *, shape: tuple[int, int], batch_size: int,
                   cond_map: torch.Tensor | None = None,
                   gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Ancestral sampling dispatched on the prior family: the PixelCNN's
    row-cached sampler or the Transformer's KV-cached one. (batch_size, H,
    W) int32; ``gumbel`` is the injected (H*W, B, K) noise."""
    gen = (transformer_prior.generate if isinstance(prior, TransformerPrior)
           else pixelcnn.fast_generate)
    return gen(prior, labels, generator, shape=shape, batch_size=batch_size,
               cond_map=cond_map, gumbel=gumbel)


@torch.inference_mode()
def sample_prior_mels(
    model: VQVAE, prior: Prior, labels: torch.Tensor, code_shape: tuple[int, int],
    generator: torch.Generator | None = None, g: torch.Tensor | None = None,
    gumbel: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The prior samples code grids, the decoder turns them into mels:
    (codes (B, H', W'), mels (B, num_mels, frames)). ``g``: speaker ids for
    a speaker-conditioned decoder."""
    codes = prior_generate(prior, labels, generator, shape=code_shape,
                           batch_size=int(labels.shape[0]), gumbel=gumbel)
    return codes, model.decode(codes, g=g)[..., 0]


@torch.inference_mode()
def sample_prior_audio(
    model: VQVAE, prior: Prior, labels: torch.Tensor, code_shape: tuple[int, int],
    cfg: AudioConfig, generator: torch.Generator | None = None,
    g: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole generative path: prior -> decoder -> Griffin-Lim.
    Returns (code grids, waveforms); one generator draws both in turn."""
    codes, mels = sample_prior_mels(model, prior, labels, code_shape, generator, g=g)
    return codes, dsp.inv_mel_spectrogram_batch(mels, cfg, generator)


def hier_cond_map(model: HierVQVAE, idx_top: torch.Tensor) -> torch.Tensor:
    """The bottom prior's conditioning: the top codes' codebook vectors,
    nearest-upsampled x2 to the bottom grid, (B, 2 Ht, 2 Wt, dim)."""
    z = codebook_lookup(model.codebook_top, idx_top)
    return z.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


@torch.inference_mode()
def sample_hier_mels(
    model: HierVQVAE, top_prior: Prior, bottom_prior: Prior, labels: torch.Tensor,
    top_shape: tuple[int, int], generator: torch.Generator | None = None,
    top_gumbel: torch.Tensor | None = None, bottom_gumbel: torch.Tensor | None = None,
):
    """The VQ-VAE-2-style chain up to the decoded mel: the top prior
    samples the top grid, the bottom prior (``spatial_cond``) samples the
    grid twice its size conditioned on the top codes, the decoder turns
    both into mels. Returns (idx_top, idx_bottom, mels (B, num_mels,
    frames)); ``generator`` draws the top's noise, then the bottom's."""
    b = int(labels.shape[0])
    ht, wt = top_shape
    idx_t = prior_generate(top_prior, labels, generator, shape=(ht, wt), batch_size=b,
                           gumbel=top_gumbel)
    cond = hier_cond_map(model, idx_t)
    idx_b = prior_generate(bottom_prior, labels, generator, shape=(2 * ht, 2 * wt),
                           batch_size=b, cond_map=cond, gumbel=bottom_gumbel)
    return idx_t, idx_b, model.decode(idx_t, idx_b)[..., 0]


@torch.inference_mode()
def sample_hier_audio(
    model: HierVQVAE, top_prior: Prior, bottom_prior: Prior, labels: torch.Tensor,
    top_shape: tuple[int, int], cfg: AudioConfig, generator: torch.Generator | None = None,
):
    """The whole hierarchical chain: ``sample_hier_mels``, then the mel
    inversion, with Griffin-Lim's phases drawn third from ``generator``.
    Returns (idx_top, idx_bottom, waveforms)."""
    idx_t, idx_b, mels = sample_hier_mels(model, top_prior, bottom_prior, labels, top_shape,
                                          generator)
    return idx_t, idx_b, dsp.inv_mel_spectrogram_batch(mels, cfg, generator)

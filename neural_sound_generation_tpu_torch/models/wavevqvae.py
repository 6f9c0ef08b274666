"""Raw-waveform VQ-VAE: strided 1-D conv encoder and decoder over samples.

Counterpart of ``neural_sound_generation_tpu/models/wavevqvae.py``, the
unit-discovery variant that quantizes the waveform directly. Public
functions keep the JAX layout (B, T, C); inside, the convolutions run
(B, C, T). Submodules carry flax's names (``encoder.conv_i``,
``encoder.bn_i``, ``encoder.res_0``, ``decoder.conv_i``, ``decoder.out``,
``codebook``, ``input_embed``, ``speaker_embed``, ``speaker_proj``); the
decoder's transpose convs are named ``conv_i`` and ``out``, not
``ConvTranspose_i``, so ``convert.py`` needs the module to lay out their
kernels.

Input modes:
  * ``raw`` / ``mulaw``: (B, T, 1) floats in, tanh output (B, T, 1);
  * ``mulaw-quantize``: (B, T) integer codes (int32 or int64) embedded to
    ``dim`` channels, (B, T, quantize_channels) logits out.

The encoder halves T ``num_downsample`` times (stride-2 width-4 convs), so
T must be a multiple of 2**num_downsample; the decoder doubles it back with
SAME transpose convs of width 4. ``num_quantizers`` > 1 quantizes the units
with residual VQ over a (Q, K, D) codebook; the nearest-code search runs
once per stage (``ops/vq``). A speaker embedding is added to the quantized
units when ``n_speakers`` and ``gin_channels`` are both positive, and
speaker ids are ignored otherwise.

Under the mesh's model axis (``training.sharding``) every encoder and
decoder convolution holds a slice of its output channels, with the
biases and the BatchNorm after it, and the codebook a slice of its rows
(of each stage's under residual VQ); the forward gathers the channels
after each split layer (and its norm and ReLU), so the skip sums, the
straight-through codes and the losses stay whole. ``decoder.out`` splits
where its outputs do (the 256 mulaw-quantize logits, gathered before the
cross entropy) and stays whole for one scalar output; ``input_embed``,
``speaker_embed`` and ``speaker_proj`` are computed whole on every rank.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import (
    BatchNorm1d,
    Conv1d,
    ConvTranspose1dSame,
    conv1d_down,
    gather_split,
    init_weights,
)
from neural_sound_generation_tpu_torch.ops.vq import codebook_lookup, residual_vq, vq, vq_st


class ResBlock1D(nn.Module):
    """ReLU -> width-3 conv -> BN -> ReLU -> 1x1 conv -> BN, plus skip, over
    (B, C, T)."""

    def __init__(self, dim: int):
        super().__init__()
        self.Conv_0 = Conv1d(dim, dim, 3, padding=1)
        self.BatchNorm_0 = BatchNorm1d(dim)
        self.Conv_1 = Conv1d(dim, dim, 1)
        self.BatchNorm_1 = BatchNorm1d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.BatchNorm_0(self.Conv_0(torch.relu(x)))
        h = gather_split(torch.relu(h), self.Conv_0)
        h = self.BatchNorm_1(self.Conv_1(h))
        return x + gather_split(h, self.Conv_1)


class WaveEncoder(nn.Module):
    """(B, in_dim, T) -> (B, dim, T / 2**num_downsample)."""

    def __init__(self, in_dim: int, dim: int, num_downsample: int):
        super().__init__()
        self.num_downsample = num_downsample
        for i in range(num_downsample):
            self.add_module(f"conv_{i}", conv1d_down(in_dim if i == 0 else dim, dim))
            if i < num_downsample - 1:
                self.add_module(f"bn_{i}", BatchNorm1d(dim))
        self.res_0 = ResBlock1D(dim)
        self.res_1 = ResBlock1D(dim)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_downsample):
            conv = getattr(self, f"conv_{i}")
            h = conv(h)
            if i < self.num_downsample - 1:
                h = torch.relu(getattr(self, f"bn_{i}")(h))
            h = gather_split(h, conv)
        return self.res_1(self.res_0(h))


class WaveDecoder(nn.Module):
    """(B, dim, T') -> (B, out_channels, T' * 2**num_downsample): logits
    when ``categorical``, else tanh."""

    def __init__(self, dim: int, num_downsample: int, out_channels: int, categorical: bool):
        super().__init__()
        self.num_downsample, self.categorical = num_downsample, categorical
        self.res_0 = ResBlock1D(dim)
        self.res_1 = ResBlock1D(dim)
        for i in range(num_downsample - 1):
            self.add_module(f"conv_{i}", ConvTranspose1dSame(dim, dim, 4, 2))
            self.add_module(f"bn_{i}", BatchNorm1d(dim))
        self.out = ConvTranspose1dSame(dim, out_channels, 4, 2)

    def forward(self, d: torch.Tensor) -> torch.Tensor:
        d = torch.relu(self.res_1(self.res_0(d)))
        for i in range(self.num_downsample - 1):
            conv = getattr(self, f"conv_{i}")
            d = gather_split(torch.relu(getattr(self, f"bn_{i}")(conv(d))), conv)
        out = gather_split(self.out(d), self.out)
        return out if self.categorical else torch.tanh(out)


class WaveVQVAE(nn.Module):
    """The JAX ``WaveVQVAE`` fields; weights are initialized from
    ``generator``: Xavier-uniform kernels and zero biases
    (``layers.init_weights``), the codebook U(-1/K, 1/K), embedding tables
    N(0, 1/d) (flax ``Embed``'s default)."""

    def __init__(
        self,
        dim: int = 256,
        z_dim: int = 512,
        num_downsample: int = 6,
        input_type: str = "raw",
        quantize_channels: int = 256,
        n_speakers: int = 0,
        gin_channels: int = -1,
        num_quantizers: int = 1,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if input_type not in ("raw", "mulaw", "mulaw-quantize"):
            raise ValueError(f"unknown input_type {input_type!r}")
        if num_quantizers < 1:
            raise ValueError(f"num_quantizers must be >= 1, got {num_quantizers}")
        self.dim, self.z_dim, self.num_downsample = dim, z_dim, num_downsample
        self.input_type, self.quantize_channels = input_type, quantize_channels
        self.n_speakers, self.gin_channels = n_speakers, gin_channels
        self.num_quantizers = num_quantizers
        cb_shape = (z_dim, dim) if num_quantizers == 1 else (num_quantizers, z_dim, dim)
        self.codebook = nn.Parameter(torch.empty(cb_shape))
        self.encoder = WaveEncoder(dim if self.categorical else 1, dim, num_downsample)
        self.decoder = WaveDecoder(dim, num_downsample,
                                   quantize_channels if self.categorical else 1, self.categorical)
        if self.categorical:
            self.input_embed = nn.Embedding(quantize_channels, dim)
        if self.speakered:
            self.speaker_embed = nn.Embedding(n_speakers, gin_channels)
            self.speaker_proj = nn.Linear(gin_channels, dim)
        self.reset_parameters(generator)

    @property
    def hop(self) -> int:
        return 2**self.num_downsample

    @property
    def categorical(self) -> bool:
        return self.input_type == "mulaw-quantize"

    @property
    def speakered(self) -> bool:
        return self.n_speakers > 0 and self.gin_channels > 0

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)
        self.codebook.uniform_(-1.0 / self.z_dim, 1.0 / self.z_dim, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim), generator=generator)

    def _embed_input(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) integer codes or (B, T, 1) floats -> (B, C, T)."""
        if self.categorical:
            return self.input_embed(x.long()).transpose(1, 2)
        return x.transpose(1, 2)

    def _condition(self, d: torch.Tensor, g: torch.Tensor | None) -> torch.Tensor:
        """Add the speaker embedding to units (B, T', dim); ids are ignored
        by an unconditioned model (the WaveNet convention)."""
        if g is not None and self.speakered:
            d = d + self.speaker_proj(self.speaker_embed(g.long()))[:, None, :]
        return d

    def encode_latents(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's output z_e (B, T', dim)."""
        return self.encoder(self._embed_input(x)).transpose(1, 2)

    def _decode(self, d: torch.Tensor) -> torch.Tensor:
        return self.decoder(d.transpose(1, 2)).transpose(1, 2)

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None):
        """Returns (out, z_e, z_q): the decoder consumes the straight-through
        codes; ``z_q`` is the differentiable lookup (the stage sum under
        residual VQ)."""
        z_e = self.encode_latents(x)
        if self.num_quantizers > 1:
            codes_st, z_q, _ = residual_vq(z_e, self.codebook)
        else:
            codes_st, indices = vq_st(z_e, self.codebook)
            z_q = codebook_lookup(self.codebook, indices).reshape(z_e.shape)
        return self._decode(self._condition(codes_st, g)), z_e, z_q

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Waveform -> unit indices (B, T'), or (Q, B, T') stage indices
        under residual VQ; int32."""
        z_e = self.encode_latents(x)
        if self.num_quantizers > 1:
            _, _, indices = residual_vq(z_e, self.codebook)
            return indices.reshape(self.num_quantizers, *z_e.shape[:-1])
        return vq(z_e, self.codebook)

    def quantized_latents(self, x: torch.Tensor) -> torch.Tensor:
        """Waveform -> the quantized units z_q (B, T', dim), summed over the
        stages under residual VQ: the conditioning of the units -> WaveNet
        chain."""
        z_e = self.encode_latents(x)
        if self.num_quantizers > 1:
            return residual_vq(z_e, self.codebook)[1]
        return codebook_lookup(self.codebook, vq(z_e, self.codebook))

    def decode(self, indices: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """Unit indices -> waveform (B, T, 1), or logits (B, T, Q) under
        mulaw-quantize; (Q, B, T') stage indices sum their stage vectors."""
        if self.num_quantizers > 1:
            z_q = codebook_lookup(self.codebook[0], indices[0])
            for q in range(1, self.num_quantizers):
                z_q = z_q + codebook_lookup(self.codebook[q], indices[q])
        else:
            z_q = codebook_lookup(self.codebook, indices)
        return self._decode(self._condition(z_q, g))

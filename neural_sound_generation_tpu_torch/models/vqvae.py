"""VQ-VAE: strided conv encoder -> vector-quantized codebook -> deconv decoder.

Counterpart of ``neural_sound_generation_tpu/models/vqvae.py`` (the flat
``VQVAE`` with speaker conditioning). Public functions take and return the
JAX package's NHWC layout: a mel window is (B, n_mels, frames, 1), latents
are (B, H/4, W/4, dim), codes are (B, H/4, W/4). Inside, the convolutions run
NCHW. Eval mode (``model.eval()``) uses BatchNorm's running statistics, as
the JAX package's ``train=False`` does.

Conditioning: a speaker embedding (``n_speakers``/``gin_channels``) and a
projection of continuous features (``cond_features``, the motion path's PCA
latents) are each added to the quantized latents before decoding;
``decode_from_features`` seeds the whole latent grid from the projected
features alone and snaps it to the codebook.

Architecture (for input (B, H, W, C)):
  encoder:  Conv4x4/s2 + norm + ReLU -> Conv4x4/s2 -> ResBlock x2   (H/4, W/4)
  codebook: z_dim codes of width `dim`, init U(-1/z_dim, 1/z_dim); with
            ``num_quantizers`` Q > 1 a (Q, z_dim, dim) stack of residual-VQ
            stages (SoundStream-style), codes (Q, B, H/4, W/4)
  decoder:  ResBlock x2 -> ReLU -> ConvT4x4/s2 + norm + ReLU -> ConvT4x4/s2
            -> Tanh

Under the mesh's model axis (``training.sharding``) every convolution but
a last one whose outputs do not split holds a slice of its output channels
and the codebook a slice of its rows; the forward gathers the channels
after each split layer (six gathers in the encoder, five in the decoder),
the skip sums stay whole, and ``ConvTranspose_1``, ``speaker_embed`` and
``feature_proj`` are computed whole on every rank.

``dtype`` is the convolution stacks' compute dtype (bfloat16 under
``--bf16``, see ``layers``): parameters stay float32, the encoder's output
is taken to float32 before the VQ, the losses stay float32, the speaker
embedding stays float32 and the decoder's tanh runs in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import (
    ResBlock,
    conv_down,
    conv_up,
    gather_split,
    init_weights,
    make_norm,
    norm_name,
)
from neural_sound_generation_tpu_torch.ops.vq import codebook_lookup, residual_vq, vq, vq_st


class Encoder(nn.Module):
    """(B, input_dim, H, W) -> (B, dim, H/4, W/4), NCHW."""

    def __init__(self, input_dim: int, dim: int, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = conv_down(input_dim, dim, dtype)
        self.add_module(norm_name(norm, 0), make_norm(norm, dim, dtype))
        self.Conv_1 = conv_down(dim, dim, dtype)
        self.ResBlock_0 = ResBlock(dim, norm, dtype)
        self.ResBlock_1 = ResBlock(dim, norm, dtype)
        self._norm = norm_name(norm, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(getattr(self, self._norm)(self.Conv_0(x)))
        h = gather_split(self.Conv_1(gather_split(h, self.Conv_0)), self.Conv_1)
        return self.ResBlock_1(self.ResBlock_0(h))


class Decoder(nn.Module):
    """(B, dim, H', W') -> (B, output_dim, 4H', 4W') in (-1, 1), NCHW."""

    def __init__(self, dim: int, output_dim: int, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ResBlock_0 = ResBlock(dim, norm, dtype)
        self.ResBlock_1 = ResBlock(dim, norm, dtype)
        self.ConvTranspose_0 = conv_up(dim, dim, dtype)
        self.add_module(norm_name(norm, 0), make_norm(norm, dim, dtype))
        self.ConvTranspose_1 = conv_up(dim, output_dim, dtype)
        self._norm = norm_name(norm, 0)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.ResBlock_1(self.ResBlock_0(z))
        h = self.ConvTranspose_0(torch.relu(h))
        h = gather_split(torch.relu(getattr(self, self._norm)(h)), self.ConvTranspose_0)
        return torch.tanh(gather_split(self.ConvTranspose_1(h), self.ConvTranspose_1).float())


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class VQVAE(nn.Module):
    """input_dim/dim/z_dim as in the reference ctor (models.py:162).

    ``n_speakers``/``gin_channels`` enable a learned speaker embedding added
    to the quantized latents before decoding (global conditioning, the
    multi-speaker CMU Arctic configuration); ``cond_features`` > 0 a dense
    projection of that many continuous features added the same way (the
    motion path). ``num_quantizers`` residual-VQ
    stages (1: the reference's single codebook) and the compute ``dtype``
    follow the JAX ``VQVAE`` (models/vqvae.py:86-108). Weights are
    initialized from ``generator`` (see ``layers.init_weights``)."""

    def __init__(
        self,
        input_dim: int = 1,
        dim: int = 256,
        z_dim: int = 512,
        n_speakers: int = 0,
        gin_channels: int = -1,
        norm: str = "batch",
        generator: torch.Generator | None = None,
        num_quantizers: int = 1,
        dtype: torch.dtype = torch.float32,
        cond_features: int = 0,
    ):
        super().__init__()
        if num_quantizers < 1:
            raise ValueError(f"num_quantizers must be >= 1, got {num_quantizers}")
        self.input_dim, self.dim, self.z_dim = input_dim, dim, z_dim
        self.n_speakers, self.gin_channels = n_speakers, gin_channels
        self.num_quantizers = num_quantizers
        self.cond_features = cond_features
        cb_shape = (z_dim, dim) if num_quantizers == 1 else (num_quantizers, z_dim, dim)
        self.codebook = nn.Parameter(torch.empty(cb_shape))
        self.encoder = Encoder(input_dim, dim, norm, dtype)
        self.decoder = Decoder(dim, input_dim, norm, dtype)
        if self.speakered:
            self.speaker_embed = nn.Embedding(n_speakers, gin_channels)
            self.speaker_proj = nn.Linear(gin_channels, dim)
        if cond_features > 0:
            self.feature_proj = nn.Linear(cond_features, dim)
        self.reset_parameters(generator)

    @property
    def speakered(self) -> bool:
        return self.n_speakers > 0 and self.gin_channels > 0

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)
        # codebook U(-1/z_dim, 1/z_dim) (models.py:125)
        self.codebook.uniform_(-1.0 / self.z_dim, 1.0 / self.z_dim, generator=generator)
        if self.speakered:
            # flax nn.Embed's default: variance scaling 1.0, fan_in, normal
            self.speaker_embed.weight.normal_(
                0.0, self.n_speakers**-0.5, generator=generator
            )

    def _condition(self, z: torch.Tensor, g: torch.Tensor | None,
                   features: torch.Tensor | None = None) -> torch.Tensor:
        """Add the speaker embedding, then the projected features, to
        latents (B, H', W', dim). Speaker ids are ignored when the model is
        unconditioned (gin <= 0)."""
        if g is not None and self.speakered:
            emb = self.speaker_proj(self.speaker_embed(g.long()))  # (B, dim)
            z = z + emb[:, None, None, :]
        if features is not None:
            z = z + self._project(features)[:, None, None, :]
        return z

    def _project(self, features: torch.Tensor) -> torch.Tensor:
        if self.cond_features <= 0:
            raise ValueError("features given to a VQVAE built without cond_features")
        return self.feature_proj(features)  # (B, dim)

    def _encode_latents(self, x: torch.Tensor) -> torch.Tensor:
        return _nhwc(self.encoder(_nchw(x))).float()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> int32 code indices (B, H/4, W/4), or (Q, B,
        H/4, W/4) under residual VQ."""
        z_e = self._encode_latents(x)
        if self.num_quantizers > 1:
            _, _, indices = residual_vq(z_e, self.codebook)
            return indices.reshape(self.num_quantizers, *z_e.shape[:-1])
        return vq(z_e, self.codebook)

    def decode(self, indices: torch.Tensor, g: torch.Tensor | None = None,
               features: torch.Tensor | None = None) -> torch.Tensor:
        """Code indices (B, H', W'), or (Q, B, H', W') under residual VQ ->
        reconstruction (B, 4H', 4W', input_dim)."""
        if self.num_quantizers > 1:
            z_q = codebook_lookup(self.codebook[0], indices[0])
            for q in range(1, self.num_quantizers):
                z_q = z_q + codebook_lookup(self.codebook[q], indices[q])
        else:
            z_q = codebook_lookup(self.codebook, indices)
        z_q = self._condition(z_q, g, features)
        return _nhwc(self.decoder(_nchw(z_q)))

    def decode_from_features(self, features: torch.Tensor,
                             latent_hw: tuple[int, int]) -> torch.Tensor:
        """Continuous features (B, cond_features) -> frames (B, 4H', 4W',
        input_dim): the projection fills an (H', W') latent grid, which is
        snapped to the nearest codebook entries (the nearest-code search of
        B * H' * W' rows, all of a batch item's rows one vector) and
        decoded."""
        emb = self._project(features)
        z = emb[:, None, None, :].expand(features.shape[0], *latent_hw, self.dim)
        if self.num_quantizers > 1:
            codes, _, _ = residual_vq(z, self.codebook)
        else:
            codes, _ = vq_st(z, self.codebook)
        return _nhwc(self.decoder(_nchw(codes)))

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None,
                features: torch.Tensor | None = None):
        """Returns (x_tilde, z_e, z_q) like the reference forward
        (models.py:198-216): ``z_e`` is the encoder output (NHWC, float32),
        ``z_q`` the codebook vectors by a differentiable lookup (under
        residual VQ the sum of the stage lookups), and the decoder consumes
        the straight-through codes."""
        z_e = self._encode_latents(x)
        if self.num_quantizers > 1:
            codes_st, z_q, _ = residual_vq(z_e, self.codebook)
        else:
            codes_st, indices = vq_st(z_e, self.codebook)
            z_q = codebook_lookup(self.codebook, indices).reshape(z_e.shape)
        x_tilde = _nhwc(self.decoder(_nchw(self._condition(codes_st, g, features))))
        return x_tilde, z_e, z_q

"""Hierarchical (two-level) VQ-VAE, the VQ-VAE-2-style family.

Counterpart of ``neural_sound_generation_tpu/models/hiervqvae.py``. A top
code grid at stride 8 holds global structure; a bottom grid at stride 4,
quantized *conditioned on the decoded top*, holds the residual detail.
Public functions take and return NHWC, as the JAX module does: a mel window
(B, n_mels, frames, 1), top codes (B, H/8, W/8), bottom codes (B, H/4, W/4);
inside, the convolutions run NCHW. Submodules carry flax's names
(``enc_bottom``, ``enc_top``, ``dec_top``, ``bottom_merge``,
``decode_merge``, ``decoder``, ``codebook_top``, ``codebook_bottom``).

Both levels quantize through ``ops/vq.vq_st``, the nearest-code kernel on
the card: every forward and every ``encode`` runs it twice, top first. The
compute ``dtype`` (``--bf16``) and the ``norm`` follow the flat model; each
level's z_e is taken to float32 before its VQ, as the JAX ``_levels`` does.
"""

from __future__ import annotations

import torch
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import (
    Conv2d,
    ResBlock,
    conv_down,
    conv_up,
    init_weights,
    make_norm,
    norm_name,
)
from neural_sound_generation_tpu_torch.models.vqvae import Decoder, Encoder, _nchw, _nhwc
from neural_sound_generation_tpu_torch.ops.vq import codebook_lookup, vq_st


class TopEncoder(nn.Module):
    """Bottom features (stride 4) -> top features (stride 8), NCHW."""

    def __init__(self, dim: int, norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = conv_down(dim, dim, dtype)
        self.add_module(norm_name(norm, 0), make_norm(norm, dim, dtype))
        self.ResBlock_0 = ResBlock(dim, norm, dtype)
        self._norm = norm_name(norm, 0)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = torch.relu(getattr(self, self._norm)(self.Conv_0(h)))
        return self.ResBlock_0(h)


class TopDecoder(nn.Module):
    """Quantized top codes (stride 8) -> bottom resolution (stride 4), NCHW."""

    def __init__(self, dim: int, norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ResBlock_0 = ResBlock(dim, norm, dtype)
        self.ConvTranspose_0 = conv_up(dim, dim, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.ConvTranspose_0(torch.relu(self.ResBlock_0(z)))


class HierVQVAE(nn.Module):
    """Two-level VQ-VAE. ``z_dim`` is the bottom codebook's size;
    ``z_dim_top`` (0: the same) the top's. Weights are initialized from
    ``generator``: the convolutions as ``layers.init_weights``, each
    codebook U(-1/K, 1/K), top first."""

    def __init__(
        self,
        input_dim: int = 1,
        dim: int = 256,
        z_dim: int = 512,
        z_dim_top: int = 0,
        norm: str = "batch",
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.input_dim, self.dim, self.z_dim, self.z_dim_top = input_dim, dim, z_dim, z_dim_top
        self.codebook_top = nn.Parameter(torch.empty(self.k_top, dim))
        self.codebook_bottom = nn.Parameter(torch.empty(z_dim, dim))
        self.enc_bottom = Encoder(input_dim, dim, norm, dtype)
        self.enc_top = TopEncoder(dim, norm, dtype)
        self.dec_top = TopDecoder(dim, norm, dtype)
        # encoder features merged with the decoded top before the bottom VQ
        self.bottom_merge = Conv2d(2 * dim, dim, 1, dtype=dtype)
        # both quantized levels merged before the final decoder
        self.decode_merge = Conv2d(2 * dim, dim, 1, dtype=dtype)
        self.decoder = Decoder(dim, input_dim, norm, dtype)
        self.reset_parameters(generator)

    @property
    def k_top(self) -> int:
        return self.z_dim_top or self.z_dim

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)
        for cb in (self.codebook_top, self.codebook_bottom):
            k = cb.shape[0]
            cb.uniform_(-1.0 / k, 1.0 / k, generator=generator)

    @staticmethod
    def _quantize(z_e: torch.Tensor, codebook: torch.Tensor):
        """(straight-through codes, differentiable lookup, indices) of an
        NHWC float32 z_e."""
        st, indices = vq_st(z_e, codebook)
        z_q = codebook_lookup(codebook, indices).reshape(z_e.shape)
        return st, z_q, indices.reshape(z_e.shape[:-1])

    def levels(self, x: torch.Tensor):
        """The JAX ``_levels``: x (B, H, W, C) -> ((st_t, z_e_t, z_q_t,
        idx_t, dec_t), (st_b, z_e_b, z_q_b, idx_b)), NHWC, z_e and dec_t in
        float32."""
        h_b = self.enc_bottom(_nchw(x)).float()
        z_e_t = _nhwc(self.enc_top(h_b)).float()
        st_t, z_q_t, idx_t = self._quantize(z_e_t, self.codebook_top)
        dec_t = self.dec_top(_nchw(st_t)).float()
        z_e_b = _nhwc(self.bottom_merge(torch.cat([h_b, dec_t], dim=1))).float()
        st_b, z_q_b, idx_b = self._quantize(z_e_b, self.codebook_bottom)
        return (st_t, z_e_t, z_q_t, idx_t, _nhwc(dec_t)), (st_b, z_e_b, z_q_b, idx_b)

    def _decode_sts(self, dec_t: torch.Tensor, st_b: torch.Tensor) -> torch.Tensor:
        """NHWC decoded top and bottom codes -> NHWC reconstruction."""
        h = self.decode_merge(torch.cat([_nchw(st_b), _nchw(dec_t)], dim=1))
        return _nhwc(self.decoder(h))

    def encode(self, x: torch.Tensor):
        """x (B, H, W, C) -> (top indices (B, H/8, W/8), bottom indices
        (B, H/4, W/4)), int32."""
        top, bottom = self.levels(x)
        return top[3], bottom[3]

    def decode(self, idx_top: torch.Tensor, idx_bottom: torch.Tensor) -> torch.Tensor:
        """Top and bottom code grids -> reconstruction (B, 8 H', 8 W',
        input_dim)."""
        z_t = codebook_lookup(self.codebook_top, idx_top)
        z_b = codebook_lookup(self.codebook_bottom, idx_bottom)
        dec_t = _nhwc(self.dec_top(_nchw(z_t)).float())
        return self._decode_sts(dec_t, z_b)

    def forward(self, x: torch.Tensor):
        """Returns (x_tilde, (z_e_top, z_q_top), (z_e_bottom, z_q_bottom)):
        one straight-through pair per level, each with its own codebook
        gradient path, as the JAX module's call."""
        top, bottom = self.levels(x)
        st_t, z_e_t, z_q_t, _, dec_t = top
        st_b, z_e_b, z_q_b, _ = bottom
        return self._decode_sts(dec_t, st_b), (z_e_t, z_q_t), (z_e_b, z_q_b)

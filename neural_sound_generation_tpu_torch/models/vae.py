"""Convolutional VAE (the reference's ``VAE``, models.py:64-118) and the MLP
``DefaultVAE`` (models.py:35-61).

Counterpart of ``neural_sound_generation_tpu/models/vae.py``. Public
functions take NHWC images (B, H, W, C), as the JAX modules do; inside, the
convolutions run NCHW. Submodules carry flax's auto-names (``Conv_0``..3,
``BatchNorm_0``..6, ``ConvTranspose_0``..3; ``Dense_0``..4).

Encoder: Conv4x4/s2 + BN + ReLU x2 -> Conv5x5/VALID + BN + ReLU ->
Conv3x3/VALID (2 * z_dim channels) + BN, split into (mu, logvar).
Decoder: the mirror, ConvTranspose 3x3 and 5x5 VALID (flax's transpose
convs do not flip their kernels; ``convert.py`` flips them for
``ConvTranspose2d``), then two 4x4/s2 ones, tanh.
KL is the analytic N(mu, sigma) || N(0, 1) divergence, summed over latent
channels and averaged over batch and space.

Noise: train mode draws eps ~ N(0, 1) through ``sample_noise`` from the
``generator`` it is given (the JAX modules' ``make_rng("sample")``); eval
mode uses eps = 0, as the JAX package's ``train=False`` does. Tests replace
``sample_noise`` on an instance to inject the JAX package's draws. Inside a
data-parallel step (``parallel.mesh.current_mesh()``) the noise is drawn at
the global batch's shape, from the generator every rank holds in the same
state, and each rank keeps its own rows: W ranks draw what one rank draws.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import (
    BatchNorm,
    conv_down,
    conv_up,
    init_weights,
)
from neural_sound_generation_tpu_torch.parallel.mesh import current_mesh


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def sample_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """eps ~ N(0, 1) of ``shape`` from ``generator``; train mode needs one."""
    if generator is None:
        raise ValueError("a train-mode VAE forward draws its noise from a torch.Generator")
    return torch.randn(shape, generator=generator, device=device)


def _train_noise(model: nn.Module, like: torch.Tensor, generator) -> torch.Tensor:
    """``model.sample_noise`` for the rows of ``like``: the global batch's
    draw, this rank's rows of it, on a data mesh."""
    mesh = current_mesh()
    if mesh is None:
        return model.sample_noise(like.shape, generator, like.device)
    n = like.shape[0]
    eps = model.sample_noise((mesh.n_data * n, *like.shape[1:]), generator, like.device)
    return eps[mesh.rows(mesh.n_data * n)]


class VAE(nn.Module):
    """input_dim/dim/z_dim as in the reference ctor. Weights are initialized
    from ``generator`` (``layers.init_weights``)."""

    def __init__(self, input_dim: int = 1, dim: int = 256, z_dim: int = 128,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_dim, self.dim, self.z_dim = input_dim, dim, z_dim
        self.Conv_0 = conv_down(input_dim, dim)
        self.Conv_1 = conv_down(dim, dim)
        self.Conv_2 = nn.Conv2d(dim, dim, 5)
        self.Conv_3 = nn.Conv2d(dim, 2 * z_dim, 3)
        self.ConvTranspose_0 = nn.ConvTranspose2d(z_dim, dim, 3)
        self.ConvTranspose_1 = nn.ConvTranspose2d(dim, dim, 5)
        self.ConvTranspose_2 = conv_up(dim, dim)
        self.ConvTranspose_3 = conv_up(dim, input_dim)
        for i, width in enumerate((dim, dim, dim, 2 * z_dim, dim, dim, dim)):
            self.add_module(f"BatchNorm_{i}", BatchNorm(width))
        self.sample_noise = sample_noise
        init_weights(self, generator)

    def _bn(self, i: int, h: torch.Tensor) -> torch.Tensor:
        return getattr(self, f"BatchNorm_{i}")(h)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        """x (B, H, W, input_dim) -> (x_tilde of x's shape in (-1, 1), kl)."""
        h = torch.relu(self._bn(0, self.Conv_0(_nchw(x))))
        h = torch.relu(self._bn(1, self.Conv_1(h)))
        h = torch.relu(self._bn(2, self.Conv_2(h)))
        h = self._bn(3, self.Conv_3(h))
        mu, logvar = torch.chunk(h, 2, dim=1)
        # KL(N(mu, e^{logvar/2}) || N(0, 1)) per position, summed over the
        # channels, averaged over batch and space (models.py:108-110)
        kl = torch.mean(torch.sum(0.5 * (torch.exp(logvar) + mu**2 - 1.0 - logvar), dim=1))
        if self.training:
            eps = _train_noise(self, mu, generator)
        else:
            eps = torch.zeros_like(mu)
        z = mu + torch.exp(0.5 * logvar) * eps
        h = torch.relu(self._bn(4, self.ConvTranspose_0(z)))
        h = torch.relu(self._bn(5, self.ConvTranspose_1(h)))
        h = torch.relu(self._bn(6, self.ConvTranspose_2(h)))
        return torch.tanh(_nhwc(self.ConvTranspose_3(h))), kl


class DefaultVAE(nn.Module):
    """784 -> 400 -> 20 MLP VAE (models.py:35-61, the MNIST baseline).
    Weights follow flax's ``Dense`` defaults: LeCun-normal kernels (a
    normal truncated at two standard deviations, variance 1 / fan_in) and
    zero biases, drawn from ``generator``."""

    def __init__(self, input_size: int = 784, hidden: int = 400, latent: int = 20,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.Dense_0 = nn.Linear(input_size, hidden)
        self.Dense_1 = nn.Linear(hidden, latent)
        self.Dense_2 = nn.Linear(hidden, latent)
        self.Dense_3 = nn.Linear(latent, hidden)
        self.Dense_4 = nn.Linear(hidden, input_size)
        self.sample_noise = sample_noise
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    # flax's truncated normal: std / .87962566 keeps the
                    # truncated draw's variance at 1 / fan_in
                    std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
                    nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                    nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        """x (B, ...) flattened to (B, input_size) -> (recon in (0, 1), mu,
        logvar)."""
        x = x.reshape(x.shape[0], -1)
        h1 = torch.relu(self.Dense_0(x))
        mu, logvar = self.Dense_1(h1), self.Dense_2(h1)
        if self.training:
            eps = _train_noise(self, mu, generator)
        else:
            eps = torch.zeros_like(mu)
        z = mu + torch.exp(0.5 * logvar) * eps
        h3 = torch.relu(self.Dense_3(z))
        return torch.sigmoid(self.Dense_4(h3)), mu, logvar

"""The mel VQ-VAE of van den Oord et al. 2017 (arXiv:1711.00937), as the
reference repository builds it (``src/models.py:161-216``), in plain float32.

Input (B, mels, frames, 1); inside NCHW. Encoder: 4x4 stride-2 convolution,
batch norm, ReLU, 4x4 stride-2 convolution, two residual blocks (ReLU, 3x3
convolution, batch norm, ReLU, 1x1 convolution, batch norm, plus the
input). The nearest of ``z_dim`` codes by squared distance; the decoder
reads the code with the straight-through gradient, which also reaches the
code's row. Decoder: two residual blocks, ReLU, 4x4 stride-2 transposed
convolution, batch norm, ReLU, 4x4 stride-2 transposed convolution, tanh.
Loss: mean squared reconstruction error + mean ||sg(z_e) - z_q||^2 +
beta * mean ||z_e - sg(z_q)||^2. Weights: Glorot-uniform kernels, zero
biases, unit norm scales, the codebook U(-1/z_dim, 1/z_dim).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import batch_norm_train

EPS = 1e-5  # batch normalisation's epsilon


def param_table(dim: int, z_dim: int, input_dim: int = 1):
    """[(name, shape, init, arg)] under the port's parameter names."""
    t = [("codebook", (z_dim, dim), "uniform", 1.0 / z_dim)]

    def conv(prefix, cout, cin, k):
        t.append((f"{prefix}.weight", (cout, cin, k, k), "xavier", None))
        t.append((f"{prefix}.bias", (cout,), "zeros", None))

    def convt(prefix, cin, cout):
        t.append((f"{prefix}.weight", (cin, cout, 4, 4), "xavier", None))
        t.append((f"{prefix}.bias", (cout,), "zeros", None))

    def norm(prefix):
        t.append((f"{prefix}.weight", (dim,), "ones", None))
        t.append((f"{prefix}.bias", (dim,), "zeros", None))

    def resblock(prefix):
        conv(f"{prefix}.Conv_0", dim, dim, 3)
        norm(f"{prefix}.BatchNorm_0")
        conv(f"{prefix}.Conv_1", dim, dim, 1)
        norm(f"{prefix}.BatchNorm_1")

    conv("encoder.Conv_0", dim, input_dim, 4)
    norm("encoder.BatchNorm_0")
    conv("encoder.Conv_1", dim, dim, 4)
    resblock("encoder.ResBlock_0")
    resblock("encoder.ResBlock_1")
    resblock("decoder.ResBlock_0")
    resblock("decoder.ResBlock_1")
    convt("decoder.ConvTranspose_0", dim, dim)
    norm("decoder.BatchNorm_0")
    convt("decoder.ConvTranspose_1", dim, input_dim)
    return t


def _norm(p, prefix, h):
    return batch_norm_train(h, p[f"{prefix}.weight"], p[f"{prefix}.bias"], EPS)


def _resblock(p, prefix, x):
    h = F.conv2d(torch.relu(x), p[f"{prefix}.Conv_0.weight"], p[f"{prefix}.Conv_0.bias"],
                 padding=1)
    h = torch.relu(_norm(p, f"{prefix}.BatchNorm_0", h))
    h = F.conv2d(h, p[f"{prefix}.Conv_1.weight"], p[f"{prefix}.Conv_1.bias"])
    return x + _norm(p, f"{prefix}.BatchNorm_1", h)


def encode(p, x):
    """(B, H, W, C) -> z_e (B, H/4, W/4, dim), batch statistics."""
    h = F.conv2d(x.permute(0, 3, 1, 2), p["encoder.Conv_0.weight"], p["encoder.Conv_0.bias"],
                 stride=2, padding=1)
    h = torch.relu(_norm(p, "encoder.BatchNorm_0", h))
    h = F.conv2d(h, p["encoder.Conv_1.weight"], p["encoder.Conv_1.bias"], stride=2, padding=1)
    h = _resblock(p, "encoder.ResBlock_0", h)
    h = _resblock(p, "encoder.ResBlock_1", h)
    return h.permute(0, 2, 3, 1)


def nearest(flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Index of the nearest code of each row by squared distance (the row's
    own norm is the same for every code and left out)."""
    scores = (codebook * codebook).sum(-1)[None, :] - 2.0 * flat @ codebook.T
    return torch.argmin(scores, dim=-1)


def decode(p, z):
    """(B, H', W', dim) -> (B, 4H', 4W', C) in (-1, 1), batch statistics."""
    h = z.permute(0, 3, 1, 2)
    h = _resblock(p, "decoder.ResBlock_0", h)
    h = _resblock(p, "decoder.ResBlock_1", h)
    h = F.conv_transpose2d(torch.relu(h), p["decoder.ConvTranspose_0.weight"],
                           p["decoder.ConvTranspose_0.bias"], stride=2, padding=1)
    h = torch.relu(_norm(p, "decoder.BatchNorm_0", h))
    h = F.conv_transpose2d(h, p["decoder.ConvTranspose_1.weight"],
                           p["decoder.ConvTranspose_1.bias"], stride=2, padding=1)
    return torch.tanh(h).permute(0, 2, 3, 1)


def loss(p: dict, batch: dict, beta: float = 1.0) -> torch.Tensor:
    x = batch["x"]
    z_e = encode(p, x)
    cb = p["codebook"]
    flat = z_e.reshape(-1, cb.shape[1])
    idx = nearest(flat.detach(), cb.detach())
    z_q = cb.index_select(0, idx).reshape(z_e.shape)
    # the code's value; the gradient reaches both z_e and the code's row
    z_st = z_q + (z_e - z_e.detach())
    x_tilde = decode(p, z_st)
    recon = torch.mean((x_tilde - x) ** 2)
    vq = torch.mean((z_q - z_e.detach()) ** 2)
    commit = torch.mean((z_e - z_q.detach()) ** 2)
    return recon + vq + beta * commit

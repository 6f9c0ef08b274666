"""The WaveNet vocoder with a mixture-of-logistics output (van den Oord et
al. 2016; Salimans et al. 2017's discretized logistic mixture, as the
r9y9 ``wavenet_vocoder`` LJSpeech preset trains it), in plain float32.

Teacher forcing: the input at sample t is the target at t - 1. A 1x1
convolution lifts the input to the residual width R; each of ``layers``
layers (dilations doubling within each of ``stacks`` stacks) takes a causal
dilated convolution of width 3 to the gate width G, adds a 1x1 projection of
the upsampled mel, splits the result into halves a and b, gates them as
tanh(a) * sigmoid(b), and adds a 1x1 projection of the gate to the skip sum
(width S) and another to the residual stream. Head: ReLU, 1x1, ReLU, 1x1 to
3 x mixtures channels. The mel is upsampled by transposed convolutions of
width 2s and stride s (output s times the input's length; kernels in
PyTorch's transposed-convolution layout), each followed by a leaky ReLU of
slope 0.4. Loss: the discretized logistic mixture's negative
log-likelihood of the targets over the valid samples.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param_table(layers: int, residual: int, gate: int, skip: int, cin: int, out: int,
                scales=(4, 4, 4, 4)):
    t = [("first_conv.weight", (residual, 1, 1), "xavier", None),
         ("first_conv.bias", (residual,), "zeros", None)]
    for i in range(layers):
        t += [(f"dilated_{i}.weight", (gate, residual, 3), "xavier", None),
              (f"dilated_{i}.bias", (gate,), "zeros", None),
              (f"res_{i}.weight", (residual, gate // 2, 1), "xavier", None),
              (f"res_{i}.bias", (residual,), "zeros", None),
              (f"skip_{i}.weight", (skip, gate // 2, 1), "xavier", None),
              (f"skip_{i}.bias", (skip,), "zeros", None)]
    for j, s in enumerate(scales):
        t += [(f"upsampler.ConvTranspose_{j}.weight", (cin, cin, 2 * s), "xavier", None),
              (f"upsampler.ConvTranspose_{j}.bias", (cin,), "zeros", None)]
    t += [(f"cond_{i}.weight", (gate, cin, 1), "xavier", None) for i in range(layers)]
    t += [("post1.weight", (skip, skip, 1), "xavier", None), ("post1.bias", (skip,), "zeros", None),
          ("post2.weight", (out, skip, 1), "xavier", None), ("post2.bias", (out,), "zeros", None)]
    return t


def dilations(layers: int, stacks: int):
    per = layers // stacks
    return [2 ** (i % per) for i in range(layers)]


def upsample(p, c, n_scales: int):
    """Mel (B, T', C) -> (B, C, T' * prod(scales))."""
    x = c.transpose(1, 2)
    for j in range(n_scales):
        w = p[f"upsampler.ConvTranspose_{j}.weight"]
        k = w.shape[-1]
        s = k // 2
        pad_a = -(-(k + s - 2) // 2)  # the leading pad of a "same" transposed convolution
        y = F.conv_transpose1d(x, w, p[f"upsampler.ConvTranspose_{j}.bias"], stride=s,
                               padding=k - 1 - pad_a)
        x = F.leaky_relu(y[..., : x.shape[-1] * s], 0.4)
    return x


def logits(p, y, c, layers: int, stacks: int, n_scales: int = 4):
    """Targets (B, T, 1) in [-1, 1], mel (B, T', C) -> (B, T, 3M)."""
    x = F.pad(y[:, :-1], (0, 0, 1, 0)).transpose(1, 2)
    t = x.shape[-1]
    h = F.conv1d(x, p["first_conv.weight"], p["first_conv.bias"])
    c_up = upsample(p, c, n_scales)[..., :t]
    skips = 0.0
    for i, d in enumerate(dilations(layers, stacks)):
        z = F.conv1d(F.pad(h, (2 * d, 0)), p[f"dilated_{i}.weight"], p[f"dilated_{i}.bias"],
                     dilation=d)
        z = z + F.conv1d(c_up, p[f"cond_{i}.weight"], None)
        a, b = z.chunk(2, dim=1)
        g = torch.tanh(a) * torch.sigmoid(b)
        skips = skips + F.conv1d(g, p[f"skip_{i}.weight"], p[f"skip_{i}.bias"])
        h = h + F.conv1d(g, p[f"res_{i}.weight"], p[f"res_{i}.bias"])
    out = torch.relu(F.conv1d(torch.relu(skips), p["post1.weight"], p["post1.bias"]))
    return F.conv1d(out, p["post2.weight"], p["post2.bias"]).transpose(1, 2)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def mol_nll(y_hat, y, lengths, num_classes: int = 65536,
            log_scale_min: float = -32.23619130191664):
    """Mean negative log-likelihood of targets y (B, T, 1) under the
    discretized logistic mixture y_hat (B, T, 3M) = [weights | means |
    log-scales], over the first ``lengths[b]`` samples of each row. A bin's
    mass is the difference of two logistic CDFs half a bin either side of
    the target; the end bins take the open tails; a mass of at most 1e-5
    is replaced by the density at the bin's centre times the bin width."""
    y = y[..., 0]
    w, mu, log_s = y_hat.chunk(3, dim=-1)
    log_s = torch.clamp(log_s, min=log_scale_min)
    centered = y[..., None] - mu
    inv_s = torch.exp(-log_s)
    half = 1.0 / (num_classes - 1)
    plus = inv_s * (centered + half)
    minus = inv_s * (centered - half)
    mass = torch.sigmoid(plus) - torch.sigmoid(minus)
    lower_tail = plus - _softplus(plus)
    upper_tail = -_softplus(minus)
    mid = inv_s * centered
    log_pdf = mid - log_s - 2.0 * _softplus(mid)
    inner = torch.where(mass > 1e-5, torch.log(torch.clamp(mass, min=1e-12)),
                        log_pdf - math.log((num_classes - 1) / 2.0))
    yy = y[..., None]
    lp = torch.where(yy < -0.999, lower_tail, torch.where(yy > 0.999, upper_tail, inner))
    nll = -torch.logsumexp(lp + torch.log_softmax(w, dim=-1), dim=-1)
    mask = (torch.arange(y.shape[1], device=y.device)[None, :] < lengths[:, None]).float()
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)


def make_loss(layers: int, stacks: int, num_classes: int, log_scale_min: float):
    def loss(p: dict, batch: dict) -> torch.Tensor:
        y_hat = logits(p, batch["y"], batch["c"], layers, stacks)
        return mol_nll(y_hat, batch["y"], batch["input_lengths"], num_classes, log_scale_min)

    return loss

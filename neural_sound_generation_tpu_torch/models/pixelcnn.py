"""Gated PixelCNN prior over discrete VQ code grids.

Counterpart of ``neural_sound_generation_tpu/models/pixelcnn.py``: gated
masked-conv layers (mask A first, 7x7; mask B after, 3x3) with
class-conditional biases, an optional per-position conditioning map
(``spatial_cond``, the hierarchical bottom prior), and a 512-wide output
head over the code indices. Public functions take code grids (B, H, W) and
NHWC conditioning maps and return NHWC logits, as the JAX module does;
inside, the convolutions run NCHW.

The modules carry the flax names (``embedding``, ``layer_i.vert_kernel``,
``layer_i.class_cond_embedding``, ``out_hidden``, ``out_logits``), so
``convert.py`` maps one tree onto the other by name. The vertical and
horizontal kernels are raw parameters, kept OIHW (flax's are HWIO
``self.param``s); the 1x1 projections are convolutions.

Causality, as in the JAX module: the masks are constants multiplied into
the kernels on every forward, never written into the weights, so a masked
tap gets a zero gradient but weight decay still moves it; the vertical
convolution pads ``k // 2`` rows above and none below, the horizontal one
``k // 2`` columns on the left, so no crop is needed on either axis of a
non-square grid.

Sampling (``torch.inference_mode``): ``generate`` runs one full forward a
pixel (the tests' oracle); ``fast_generate`` is the row-cached sampler of
the JAX module. The vertical stack runs once a row over the whole grid
(its row i reads only rows < i), then the pixels of the row run the
horizontal stack as small matrix products, carrying each layer's input at
the previous column. Both draw with the Gumbel-max trick,
argmax(logits + G), which is how ``jax.random.categorical`` draws; the
(H*W, B, K) noise is drawn up front from a ``torch.Generator`` in raster
order, or injected. ``incremental_logits`` teacher-forces the row-cached
path, the fast sampler's parity oracle.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import init_weights
from neural_sound_generation_tpu_torch.models.transformer_prior import gumbel_noise

__all__ = ["GatedPixelCNN", "fast_generate", "generate", "incremental_logits"]

#: width of the output head's hidden layer (JAX ``out_hidden``)
HEAD_HIDDEN = 512


def _gate(x: torch.Tensor, dim: int) -> torch.Tensor:
    a, b = x.chunk(2, dim=dim)
    return torch.tanh(a) * torch.sigmoid(b)


class GatedMaskedConvLayer(nn.Module):
    """One gated layer: vertical and horizontal stacks, class-conditional
    (and optionally spatial) bias, tanh/sigmoid gates, an optional
    horizontal residual. Activations NCHW."""

    def __init__(self, dim: int, kernel: int, residual: bool = True, n_classes: int = 10,
                 mask_a: bool = False, spatial_cond: bool = False, cond_dim: int = 0):
        super().__init__()
        if spatial_cond and cond_dim <= 0:
            raise ValueError("a spatially conditioned layer needs cond_dim > 0")
        self.dim, self.kernel, self.residual, self.mask_a = dim, kernel, residual, mask_a
        dim2, k, half = 2 * dim, kernel, kernel // 2 + 1
        self.class_cond_embedding = nn.Embedding(n_classes, dim2)
        self.spatial_cond = nn.Conv2d(cond_dim, dim2, 1) if spatial_cond else None
        self.vert_kernel = nn.Parameter(torch.empty(dim2, dim, half, k))
        self.vert_bias = nn.Parameter(torch.empty(dim2))
        self.horiz_kernel = nn.Parameter(torch.empty(dim2, dim, 1, half))
        self.horiz_bias = nn.Parameter(torch.empty(dim2))
        self.vert_to_horiz = nn.Conv2d(dim2, dim2, 1)
        self.horiz_resid = nn.Conv2d(dim, dim, 1)
        v_mask = torch.ones(1, 1, half, k)
        h_mask = torch.ones(1, 1, 1, half)
        if mask_a:  # the current row (vertical) and pixel (horizontal) are unseen
            v_mask[:, :, half - 1] = 0.0
            h_mask[..., half - 1] = 0.0
        self.register_buffer("v_mask", v_mask, persistent=False)
        self.register_buffer("h_mask", h_mask, persistent=False)

    def kernels(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The masked (vertical, horizontal) kernels, OIHW."""
        if not self.mask_a:
            return self.vert_kernel, self.horiz_kernel
        return self.vert_kernel * self.v_mask, self.horiz_kernel * self.h_mask

    def vertical(self, x_v: torch.Tensor, vk: torch.Tensor) -> torch.Tensor:
        """The vertical stack's pre-activation: rows above (and the current
        row under mask B), NCHW."""
        p = self.kernel // 2
        return F.conv2d(F.pad(x_v, (p, p, p, 0)), vk) + self.vert_bias[:, None, None]

    def cond_bias(self, label: torch.Tensor, cond_map: torch.Tensor | None) -> torch.Tensor:
        """(B, 2C, 1, 1) class bias, plus the (B, 2C, H, W) spatial term."""
        h_cond = self.class_cond_embedding(label.long())[:, :, None, None]
        if self.spatial_cond is not None:
            if cond_map is None:
                raise ValueError("spatial_cond model requires cond_map")
            h_cond = h_cond + self.spatial_cond(cond_map)
        return h_cond

    def forward(self, x_v, x_h, label, cond_map=None):
        vk, hk = self.kernels()
        h_cond = self.cond_bias(label, cond_map)
        h_vert = self.vertical(x_v, vk)
        out_v = _gate(h_vert + h_cond, 1)
        p = self.kernel // 2
        h_horiz = F.conv2d(F.pad(x_h, (p, 0, 0, 0)), hk) + self.horiz_bias[:, None, None]
        out = _gate(self.vert_to_horiz(h_vert) + h_horiz + h_cond, 1)
        out_h = self.horiz_resid(out)
        if self.residual:
            out_h = out_h + x_h
        return out_v, out_h


class GatedPixelCNN(nn.Module):
    """``input_dim`` = codebook size, ``dim`` hidden width, ``n_layers``
    gated blocks, class-conditioned; ``spatial_cond`` adds a per-position
    conditioning map of ``cond_dim`` channels. ``(codes (B, H, W) int,
    label (B,) int[, cond_map (B, H, W, cond_dim)]) -> logits (B, H, W,
    input_dim)`` float32. Weights are initialized from ``generator``:
    Xavier-uniform kernels, zero biases, embeddings N(0, 1/width)."""

    def __init__(self, input_dim: int = 256, dim: int = 64, n_layers: int = 15,
                 n_classes: int = 10, spatial_cond: bool = False, cond_dim: int = 0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.input_dim, self.dim, self.n_layers = input_dim, dim, n_layers
        self.n_classes, self.spatial_cond, self.cond_dim = n_classes, spatial_cond, cond_dim
        self.embedding = nn.Embedding(input_dim, dim)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", GatedMaskedConvLayer(
                dim, 7 if i == 0 else 3, residual=i > 0, n_classes=n_classes, mask_a=i == 0,
                spatial_cond=spatial_cond, cond_dim=cond_dim))
        self.out_hidden = nn.Conv2d(dim, HEAD_HIDDEN, 1)
        self.out_logits = nn.Conv2d(HEAD_HIDDEN, input_dim, 1)
        self.reset_parameters(generator)

    @property
    def layers(self) -> list[GatedMaskedConvLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        init_weights(self, generator)
        for layer in self.layers:
            for w in (layer.vert_kernel, layer.horiz_kernel):
                nn.init.xavier_uniform_(w, generator=generator)
            nn.init.zeros_(layer.vert_bias)
            nn.init.zeros_(layer.horiz_bias)
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, m.embedding_dim**-0.5, generator=generator)

    def _cond_nchw(self, cond_map: torch.Tensor | None) -> torch.Tensor | None:
        if not self.spatial_cond:
            return None
        if cond_map is None:
            raise ValueError("spatial_cond model requires cond_map")
        return cond_map.to(self.embedding.weight.dtype).permute(0, 3, 1, 2)

    def forward(self, codes: torch.Tensor, label: torch.Tensor,
                cond_map: torch.Tensor | None = None) -> torch.Tensor:
        h = self.embedding(codes.long()).permute(0, 3, 1, 2)
        cond = self._cond_nchw(cond_map)
        x_v = x_h = h
        for layer in self.layers:
            x_v, x_h = layer(x_v, x_h, label, cond)
        out = self.out_logits(torch.relu(self.out_hidden(x_h)))
        return out.permute(0, 2, 3, 1).float()


def _noise(gumbel, generator, shape, device) -> torch.Tensor:
    """The (H*W, B, K) Gumbel noise: injected, or drawn up front."""
    if gumbel is not None:
        return gumbel.to(device=device, dtype=torch.float32)
    return gumbel_noise(shape, generator, device)


@torch.inference_mode()
def generate(model: GatedPixelCNN, label: torch.Tensor, generator: torch.Generator | None = None,
             shape: tuple[int, int] = (8, 8), batch_size: int = 64,
             cond_map: torch.Tensor | None = None,
             gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Ancestral sampling with one full forward a pixel, raster order:
    (batch_size, H, W) int32. ``gumbel`` (H*W, B, K) is the noise of pixel
    t = i * W + j; without it the noise comes from ``generator``."""
    h, w = shape
    device = model.embedding.weight.device
    label = label.to(device)
    noise = _noise(gumbel, generator, (h * w, batch_size, model.input_dim), device)
    x = torch.zeros(batch_size, h, w, dtype=torch.int32, device=device)
    for t in range(h * w):
        i, j = divmod(t, w)
        logits = model(x, label, cond_map)[:, i, j]
        x[:, i, j] = torch.argmax(logits + noise[t], dim=-1).to(torch.int32)
    return x


class _Weights:
    """The row-cached path's weights: per layer the masked vertical kernel,
    and every 1x1 projection and horizontal tap as an (in, out) matrix."""

    def __init__(self, model: GatedPixelCNN):
        self.layers = []
        for layer in model.layers:
            vk, hk = layer.kernels()
            taps = hk[:, :, 0].permute(2, 1, 0)  # (kw, in, out), taps j-kw+1 .. j
            self.layers.append({
                "layer": layer, "vk": vk,
                "v2h": layer.vert_to_horiz.weight[:, :, 0, 0].T,
                "v2h_b": layer.vert_to_horiz.bias,
                # the horizontal taps that see columns < j (the last, column j,
                # is masked in layer 0) and, after layer 0, column j itself
                "h_prev": taps[:-1].reshape(-1, taps.shape[-1]),
                "h_cur": None if layer.mask_a else taps[-1],
                "h_b": layer.horiz_bias,
                "res": layer.horiz_resid.weight[:, :, 0, 0].T, "res_b": layer.horiz_resid.bias,
            })
        self.hid = model.out_hidden.weight[:, :, 0, 0].T
        self.hid_b = model.out_hidden.bias
        self.out = model.out_logits.weight[:, :, 0, 0].T
        self.out_b = model.out_logits.bias


def _conditioning(model: GatedPixelCNN, label, cond_map) -> list:
    """Per layer the (B, 1, 1, 2C) class bias, or (B, H, W, 2C) with the
    spatial term, NHWC."""
    cond = model._cond_nchw(cond_map)
    return [layer.cond_bias(label, cond).permute(0, 2, 3, 1) for layer in model.layers]


def _vertical_pass(wts: _Weights, emb: torch.Tensor, cond: list) -> list:
    """All layers' vertical stacks over the whole grid: per layer the
    (B, H, W, 2C) vertical-to-horizontal map, NHWC. Row i is final once
    rows < i of ``emb`` (B, C, H, W) are."""
    x_v = emb
    v2h_all = []
    for lw, c in zip(wts.layers, cond):
        h_vert = lw["layer"].vertical(x_v, lw["vk"])  # (B, 2C, H, W)
        h_nhwc = h_vert.permute(0, 2, 3, 1)
        v2h_all.append(torch.addmm(lw["v2h_b"], h_nhwc.reshape(-1, h_nhwc.shape[-1]),
                                   lw["v2h"]).reshape(h_nhwc.shape))
        x_v = _gate(h_nhwc + c, -1).permute(0, 3, 1, 2)
    return v2h_all


def _run_incremental(model: GatedPixelCNN, label, h: int, w: int, batch: int,
                     noise: torch.Tensor | None = None, forced: torch.Tensor | None = None,
                     cond_map: torch.Tensor | None = None):
    """The row-cached pass: sample (``noise`` (H*W, B, K)) or teacher-force
    (``forced`` (B, H, W)) the grid. Returns (codes (B, H, W) int32,
    logits (B, H, W, K) float32; the logits only when forced)."""
    device = model.embedding.weight.device
    label = label.to(device)
    wts = _Weights(model)
    table = model.embedding.weight
    c_dim = table.shape[1]
    cond = _conditioning(model, label, cond_map)
    x = (torch.zeros(batch, h, w, dtype=torch.int32, device=device) if forced is None
         else forced.to(device=device, dtype=torch.int32))
    logits_all = None if forced is None else torch.empty(
        batch, h, w, model.input_dim, dtype=torch.float32, device=device)
    first = wts.layers[0]
    pad0 = model.layers[0].kernel // 2  # the mask-A horizontal conv's unmasked taps
    for i in range(h):
        emb = table[x.long()].permute(0, 3, 1, 2)
        v2h = _vertical_pass(wts, emb, cond)
        # per layer and column: vertical term + conditioning + horizontal bias
        base = [v[:, i] + (c[:, i] if c.shape[1] > 1 else c[:, 0]) + lw["h_b"]
                for v, c, lw in zip(v2h, cond, wts.layers)]
        emb_row = torch.zeros(batch, w + pad0, c_dim, dtype=table.dtype, device=device)
        prev = [torch.zeros(batch, c_dim, dtype=table.dtype, device=device)
                for _ in wts.layers[1:]]
        for j in range(w):
            window = emb_row[:, j:j + pad0].reshape(batch, -1)
            out = _gate(torch.addmm(base[0][:, j], window, first["h_prev"]), -1)
            cur = torch.addmm(first["res_b"], out, first["res"])
            for layer_i, lw in enumerate(wts.layers[1:]):
                hh = torch.addmm(base[layer_i + 1][:, j], prev[layer_i], lw["h_prev"])
                out = _gate(torch.addmm(hh, cur, lw["h_cur"]), -1)
                prev[layer_i] = cur
                cur = torch.addmm(lw["res_b"], out, lw["res"]) + cur
            hidden = torch.relu(torch.addmm(wts.hid_b, cur, wts.hid))
            logits = torch.addmm(wts.out_b, hidden, wts.out).float()
            if forced is None:
                pix = torch.argmax(logits + noise[i * w + j], dim=-1).to(torch.int32)
                x[:, i, j] = pix
            else:
                pix = x[:, i, j]
                logits_all[:, i, j] = logits
            emb_row[:, pad0 + j] = table[pix.long()]
    return x, logits_all


@torch.inference_mode()
def fast_generate(model: GatedPixelCNN, label: torch.Tensor,
                  generator: torch.Generator | None = None, shape: tuple[int, int] = (8, 8),
                  batch_size: int = 64, cond_map: torch.Tensor | None = None,
                  gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Row-cached ancestral sampling: (batch_size, H, W) int32, from the
    same noise as ``generate`` (``gumbel`` (H*W, B, K), or drawn from
    ``generator``); the two agree but where conv-vs-matmul rounding flips a
    near-tie."""
    h, w = shape
    device = model.embedding.weight.device
    noise = _noise(gumbel, generator, (h * w, batch_size, model.input_dim), device)
    return _run_incremental(model, label, h, w, batch_size, noise=noise, cond_map=cond_map)[0]


@torch.inference_mode()
def incremental_logits(model: GatedPixelCNN, codes: torch.Tensor, label: torch.Tensor,
                       cond_map: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced logits through the row-cached path; equal to the
    parallel forward up to float32 rounding. (B, H, W) -> (B, H, W, K)."""
    b, h, w = codes.shape
    return _run_incremental(model, label, h, w, b, forced=codes, cond_map=cond_map)[1]

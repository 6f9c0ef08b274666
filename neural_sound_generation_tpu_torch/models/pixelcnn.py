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

Compute dtype (``dtype``, bfloat16 under ``cli.prior --bf16``): the
parameters stay float32 and the whole stream after the embedding runs in
the compute dtype. The embedding and the class-conditioning embedding are
looked up in float32 and rounded; the masks are applied in float32 before
the kernels are cast; every convolution (the vertical and horizontal ones,
``vert_to_horiz``, ``horiz_resid``, ``spatial_cond``, ``out_hidden``,
``out_logits``) rounds its product once and then adds its rounded bias; the
gates (``layers.gate``: tanh, and the sigmoid op by op, as XLA lowers it)
and the residual are in the compute dtype; the logits return as float32.
The row-cached sampler casts every floating weight once at entry and the
conditioning map with them, and sums in the JAX sampler's order (its
horizontal taps as matrix products, each product rounded, then the bias,
the vertical term and the conditioning added one at a time); in float32 it
folds each bias into its product (``torch.addmm``), fewer launches for the
same sums up to rounding.

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

Under the mesh's model axis (``training.sharding``) ``forward`` runs on
this rank's slices. The embedding's feature slice is gathered before layer
0. In a layer whose gate is split the vertical and horizontal kernels and
biases, ``vert_to_horiz``, ``spatial_cond`` and the class table hold this
rank's channels of each gate half; the layer takes its inputs through
``copy_to_model`` (the raw kernels do not go through ``layers.Conv2d``),
gates its own channels, and gathers: the vertical pre-activation block-wise
as ``vert_to_horiz``'s input, both gates' outputs, and ``horiz_resid``'s
slice before the residual add. ``out_hidden`` and ``out_logits`` are
gathered, so the logits come out whole on every rank. The samplers and
``incremental_logits`` run on a whole model only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import (
    Conv2d,
    gate,
    gather_split,
    init_weights,
    split_mesh,
)
from neural_sound_generation_tpu_torch.models.transformer_prior import gumbel_noise

__all__ = ["GatedPixelCNN", "fast_generate", "generate", "incremental_logits"]

#: width of the output head's hidden layer (JAX ``out_hidden``)
HEAD_HIDDEN = 512


class GatedMaskedConvLayer(nn.Module):
    """One gated layer: vertical and horizontal stacks, class-conditional
    (and optionally spatial) bias, tanh/sigmoid gates, an optional
    horizontal residual. Activations NCHW, in the compute ``dtype``."""

    def __init__(self, dim: int, kernel: int, residual: bool = True, n_classes: int = 10,
                 mask_a: bool = False, spatial_cond: bool = False, cond_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if spatial_cond and cond_dim <= 0:
            raise ValueError("a spatially conditioned layer needs cond_dim > 0")
        self.dim, self.kernel, self.residual, self.mask_a = dim, kernel, residual, mask_a
        self.compute_dtype = dtype
        dim2, k, half = 2 * dim, kernel, kernel // 2 + 1
        self.class_cond_embedding = nn.Embedding(n_classes, dim2)
        self.spatial_cond = Conv2d(cond_dim, dim2, 1, dtype=dtype) if spatial_cond else None
        self.vert_kernel = nn.Parameter(torch.empty(dim2, dim, half, k))
        self.vert_bias = nn.Parameter(torch.empty(dim2))
        self.horiz_kernel = nn.Parameter(torch.empty(dim2, dim, 1, half))
        self.horiz_bias = nn.Parameter(torch.empty(dim2))
        self.vert_to_horiz = Conv2d(dim2, dim2, 1, dtype=dtype)
        self.horiz_resid = Conv2d(dim, dim, 1, dtype=dtype)
        v_mask = torch.ones(1, 1, half, k)
        h_mask = torch.ones(1, 1, 1, half)
        if mask_a:  # the current row (vertical) and pixel (horizontal) are unseen
            v_mask[:, :, half - 1] = 0.0
            h_mask[..., half - 1] = 0.0
        self.register_buffer("v_mask", v_mask, persistent=False)
        self.register_buffer("h_mask", h_mask, persistent=False)

    def kernels(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The masked (vertical, horizontal) kernels, OIHW, float32."""
        if not self.mask_a:
            return self.vert_kernel, self.horiz_kernel
        return self.vert_kernel * self.v_mask, self.horiz_kernel * self.h_mask

    def vertical(self, x_v: torch.Tensor, vk: torch.Tensor) -> torch.Tensor:
        """The vertical stack's pre-activation: rows above (and the current
        row under mask B), NCHW, in the compute dtype."""
        dt, p = self.compute_dtype, self.kernel // 2
        return (F.conv2d(F.pad(x_v.to(dt), (p, p, p, 0)), vk.to(dt))
                + self.vert_bias.to(dt)[:, None, None])

    def cond_bias(self, label: torch.Tensor, cond_map: torch.Tensor | None) -> torch.Tensor:
        """(B, 2C, 1, 1) class bias, plus the (B, 2C, H, W) spatial term."""
        h_cond = self.class_cond_embedding(label.long()).to(self.compute_dtype)[:, :, None, None]
        if self.spatial_cond is not None:
            if cond_map is None:
                raise ValueError("spatial_cond model requires cond_map")
            h_cond = h_cond + self.spatial_cond(cond_map)
        return h_cond

    def forward(self, x_v, x_h, label, cond_map=None):
        # the gate's leaves hold this rank's channels of each half
        mesh = split_mesh() if self.vert_to_horiz.model_split else None
        x_in = x_h if mesh is None else mesh.copy_to_model(x_h)
        if mesh is not None:
            x_v = mesh.copy_to_model(x_v)
        vk, hk = self.kernels()
        h_cond = self.cond_bias(label, cond_map)
        h_vert = self.vertical(x_v, vk)
        out_v = gate(h_vert + h_cond, 1)
        dt, p = self.compute_dtype, self.kernel // 2
        h_horiz = (F.conv2d(F.pad(x_in.to(dt), (p, 0, 0, 0)), hk.to(dt))
                   + self.horiz_bias.to(dt)[:, None, None])
        # vert_to_horiz reads the whole vertical pre-activation, in its order
        v_in = h_vert if mesh is None else mesh.gather_channels(h_vert, groups=2)
        out = gate(self.vert_to_horiz(v_in) + h_horiz + h_cond, 1)
        if mesh is not None:
            out_v, out = mesh.gather_channels(out_v), mesh.gather_channels(out)
        out_h = gather_split(self.horiz_resid(out), self.horiz_resid)
        if self.residual:
            out_h = out_h + x_h
        return out_v, out_h


class GatedPixelCNN(nn.Module):
    """``input_dim`` = codebook size, ``dim`` hidden width, ``n_layers``
    gated blocks, class-conditioned; ``spatial_cond`` adds a per-position
    conditioning map of ``cond_dim`` channels. ``(codes (B, H, W) int,
    label (B,) int[, cond_map (B, H, W, cond_dim)]) -> logits (B, H, W,
    input_dim)`` float32, computed in ``dtype`` (float32 or bfloat16; the
    parameters are float32 either way). Weights are initialized from
    ``generator``: Xavier-uniform kernels, zero biases, embeddings N(0,
    1/width)."""

    #: set by ``training.sharding``: this rank holds a feature slice of
    #: ``embedding``
    embed_split = False

    def __init__(self, input_dim: int = 256, dim: int = 64, n_layers: int = 15,
                 n_classes: int = 10, spatial_cond: bool = False, cond_dim: int = 0,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator | None = None):
        super().__init__()
        self.input_dim, self.dim, self.n_layers = input_dim, dim, n_layers
        self.n_classes, self.spatial_cond, self.cond_dim = n_classes, spatial_cond, cond_dim
        self.compute_dtype = dtype
        self.embedding = nn.Embedding(input_dim, dim)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", GatedMaskedConvLayer(
                dim, 7 if i == 0 else 3, residual=i > 0, n_classes=n_classes, mask_a=i == 0,
                spatial_cond=spatial_cond, cond_dim=cond_dim, dtype=dtype))
        self.out_hidden = Conv2d(dim, HEAD_HIDDEN, 1, dtype=dtype)
        self.out_logits = Conv2d(HEAD_HIDDEN, input_dim, 1, dtype=dtype)
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
        h = self.embedding(codes.long()).to(self.compute_dtype).permute(0, 3, 1, 2)
        if self.embed_split:
            h = split_mesh().gather_channels(h)
        cond = self._cond_nchw(cond_map)
        x_v = x_h = h
        for layer in self.layers:
            x_v, x_h = layer(x_v, x_h, label, cond)
        out = gather_split(torch.relu(self.out_hidden(x_h)), self.out_hidden)
        out = gather_split(self.out_logits(out), self.out_logits)
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
    """The row-cached path's weights, each cast once to the compute dtype:
    the embedding table, and per layer the class-conditioning table, the
    spatial projection, the masked vertical kernel and its bias, and every
    1x1 projection and horizontal tap as an (in, out) matrix."""

    def __init__(self, model: GatedPixelCNN):
        dt = model.compute_dtype

        def mat(conv):  # a 1x1 convolution as (in, out) and its bias
            return conv.weight[:, :, 0, 0].T.to(dt), conv.bias.to(dt)

        self.table = model.embedding.weight.to(dt)
        self.layers = []
        for layer in model.layers:
            vk, hk = (k.to(dt) for k in layer.kernels())
            taps = hk[:, :, 0].permute(2, 1, 0)  # (kw, in, out), taps j-kw+1 .. j
            self.layers.append({
                "layer": layer, "vk": vk, "vb": layer.vert_bias.to(dt),
                "class": layer.class_cond_embedding.weight.to(dt),
                "spatial": None if layer.spatial_cond is None else mat(layer.spatial_cond),
                "v2h": mat(layer.vert_to_horiz),
                # the horizontal taps that see columns < j (the last, column j,
                # is masked in layer 0) and, after layer 0, column j itself
                "h_prev": taps[:-1].reshape(-1, taps.shape[-1]),
                "h_cur": None if layer.mask_a else taps[-1],
                "h_b": layer.horiz_bias.to(dt),
                "res": mat(layer.horiz_resid),
            })
        self.hid = mat(model.out_hidden)
        self.out = mat(model.out_logits)


def _affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b over the last axis: in float32 one fused call; in bf16 the
    product rounded, then the bias added, as flax's Dense and the JAX
    sampler's matrix products do."""
    if x.dtype == torch.float32:
        return torch.addmm(b, x.reshape(-1, x.shape[-1]), w).reshape(*x.shape[:-1], -1)
    return x @ w + b


def _conditioning(wts: _Weights, label, cond_map) -> list:
    """Per layer the (B, 1, 1, 2C) class bias, or (B, H, W, 2C) with the
    spatial term (class + map @ W, then + bias: the JAX sampler's order),
    NHWC; the map is cast with the weights."""
    cond = []
    for lw in wts.layers:
        c = lw["class"][label.long()][:, None, None, :]
        if lw["spatial"] is not None:
            if cond_map is None:
                raise ValueError("spatial_cond model requires cond_map")
            w, b = lw["spatial"]
            c = c + cond_map.to(w.dtype) @ w + b
        cond.append(c)
    return cond


def _vertical_pass(wts: _Weights, emb: torch.Tensor, cond: list) -> list:
    """All layers' vertical stacks over the whole grid: per layer the
    (B, H, W, 2C) vertical-to-horizontal map, NHWC. Row i is final once
    rows < i of ``emb`` (B, C, H, W) are."""
    x_v = emb
    v2h_all = []
    for lw, c in zip(wts.layers, cond):
        k = lw["layer"].kernel // 2
        h_vert = F.conv2d(F.pad(x_v, (k, k, k, 0)), lw["vk"]) + lw["vb"][:, None, None]
        h_nhwc = h_vert.permute(0, 2, 3, 1)
        v2h_all.append(_affine(h_nhwc, *lw["v2h"]))
        x_v = gate(h_nhwc + c, -1).permute(0, 3, 1, 2)
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
    table = wts.table
    c_dim = table.shape[1]
    fused = table.dtype == torch.float32
    cond = _conditioning(wts, label, None if cond_map is None else cond_map.to(device))
    x = (torch.zeros(batch, h, w, dtype=torch.int32, device=device) if forced is None
         else forced.to(device=device, dtype=torch.int32))
    logits_all = None if forced is None else torch.empty(
        batch, h, w, model.input_dim, dtype=torch.float32, device=device)
    first, rest = wts.layers[0], wts.layers[1:]
    pad0 = model.layers[0].kernel // 2  # the mask-A horizontal conv's unmasked taps
    for i in range(h):
        emb = table[x.long()].permute(0, 3, 1, 2)
        v2h = _vertical_pass(wts, emb, cond)
        # per layer and column the vertical term and the conditioning (B, W
        # or 1, 2C); in float32 summed once a row with the horizontal bias
        v_row = [v[:, i] for v in v2h]
        c_row = [c[:, i] if c.shape[1] > 1 else c[:, 0] for c in cond]
        if fused:
            base = [v + c + lw["h_b"] for v, c, lw in zip(v_row, c_row, wts.layers)]

        def pre(layer_i: int, j: int, horiz: torch.Tensor) -> torch.Tensor:
            """The gate's input: vertical term + horizontal + conditioning."""
            c = c_row[layer_i]
            return (v_row[layer_i][:, j] + horiz) + c[:, j if c.shape[1] > 1 else 0]

        emb_row = torch.zeros(batch, w + pad0, c_dim, dtype=table.dtype, device=device)
        prev = [torch.zeros(batch, c_dim, dtype=table.dtype, device=device) for _ in rest]
        for j in range(w):
            window = emb_row[:, j:j + pad0].reshape(batch, -1)
            if fused:
                out = gate(torch.addmm(base[0][:, j], window, first["h_prev"]), -1)
            else:
                out = gate(pre(0, j, window @ first["h_prev"] + first["h_b"]), -1)
            cur = _affine(out, *first["res"])
            for layer_i, lw in enumerate(rest, start=1):
                if fused:
                    hh = torch.addmm(base[layer_i][:, j], prev[layer_i - 1], lw["h_prev"])
                    out = gate(torch.addmm(hh, cur, lw["h_cur"]), -1)
                else:
                    horiz = prev[layer_i - 1] @ lw["h_prev"] + cur @ lw["h_cur"] + lw["h_b"]
                    out = gate(pre(layer_i, j, horiz), -1)
                prev[layer_i - 1] = cur
                cur = _affine(out, *lw["res"]) + cur
            logits = _affine(torch.relu(_affine(cur, *wts.hid)), *wts.out).float()
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

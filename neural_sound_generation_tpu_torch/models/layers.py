"""Shared model layers, as PyTorch modules.

Counterpart of ``neural_sound_generation_tpu/models/layers.py``. Inside the
port the modules run NCHW, PyTorch's native layout; the models convert at
their public functions, which keep the JAX package's NHWC. Submodules carry
the JAX package's flax names (``Conv_0``, ``BatchNorm_0``, ...), so the
weight bridge in ``convert.py`` maps one tree onto the other by name.

Only the stock convolution math is ported. The JAX package's ``edge`` and
``phased`` lowerings of the stride-2 convolutions are TPU layout choices
with the same numerics.

Compute dtype (``dtype``, flax's per-module ``dtype``; bfloat16 under
``--bf16``): parameters stay float32. A convolution casts its input, kernel
and bias to the compute dtype (flax's ``promote_dtype``), convolves with
float32 accumulation rounded once, then adds the rounded bias, so its output
is in the compute dtype. A norm takes its statistics and normalizes in
float32 and rounds once to the compute dtype; BatchNorm's running averages
stay float32. The casts are explicit: ``torch.autocast`` would choose the
bf16 ops by its own list, which is not flax's. ``Linear`` is flax's
``Dense`` under the same rule: input, weight and bias cast, the product
rounded once, then the rounded bias added (a bf16 ``F.linear`` with its bias
folds it into the product and rounds once instead of twice). Elementwise
bf16 functions round after every operation, as XLA lowers them: ``gelu``
and ``sigmoid`` spell out flax's formulas op by op in bf16.

Tensor parallelism (the mesh's model axis, ``training.sharding``): a
column-split ``Conv2d``, ``ConvTranspose2d``, ``Conv1d`` or
``ConvTranspose1dSame`` (``model_split``) holds its rank's slice of the
output channels, with their biases, and computes it from the whole input,
taken through ``Mesh.copy_to_model`` so that the input's gradient is
summed over the model group; the norm after it holds the same channels.
The model gathers the whole channels after the layer (and its norm and
ReLU) with ``gather_split``; a layer whose output channels are a gate's
two halves holds its slice of each (``model_groups`` 2), and the gather
puts them back in the layer's order. A ``Linear`` is split the
same way by output features (``model_split`` "columns") or by input
features ("rows": it holds its rank's slice of the inputs and the whole
bias, sums the model group's partial products with
``Mesh.reduce_from_model`` and adds the bias once, after the sum, where
the one-rank layer adds it to its one product). The casts stay as above.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from neural_sound_generation_tpu_torch.parallel.mesh import current_mesh, model_axis

# flax's nn.BatchNorm: epsilon 1e-5, running average kept as
# 0.99 * old + 0.01 * batch (PyTorch's momentum is the weight of the batch).
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.01
# flax's nn.GroupNorm(group_size=8): epsilon 1e-6, not PyTorch's 1e-5.
GROUP_SIZE = 8
GROUP_NORM_EPS = 1e-6


def norm_name(norm: str, i: int) -> str:
    """The flax auto-name of the i-th norm layer of a module."""
    if norm == "batch":
        return f"BatchNorm_{i}"
    if norm == "group":
        return f"GroupNorm_{i}"
    raise ValueError(f"unknown norm: {norm!r}")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with flax's ``nn.BatchNorm`` semantics.

    Eval mode normalizes with the running statistics, as ``BatchNorm2d``
    does. Train mode normalizes with the batch mean and the *biased* batch
    variance, and updates the running averages as 0.99 * old + 0.01 *
    batch with that biased variance, where ``BatchNorm2d`` would store the
    unbiased one. ``num_batches_tracked`` is not used (flax has no
    counter). Under a compute ``dtype`` other than float32 the input is
    taken to float32 first and the output rounded once to ``dtype``. The
    variance is the two-pass one, not flax's float32 E[x^2] - E[x]^2: that
    formula cancels as (|mean| / std)^2 grows, and the two-pass one stays
    within 1e-5 of the exact statistics where flax drifts 5e-2 away at
    |mean| / std = 100 (tests/test_torch_norm_stats.py).

    Inside a data-parallel step (``parallel.mesh.current_mesh()``) the
    statistics are the global batch's, as the JAX package's are under
    GSPMD: the same two-pass rule over every rank's rows, each sum taken
    over the data group by a differentiable all-reduce (mean = sum x / N,
    then var = sum (x - mean)^2 / N, N the global count), so every rank
    normalizes, and updates its running averages, with the same values.
    Under the model axis it holds the channels of the column-split layer
    before it, whose statistics need no other rank's."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=BATCH_NORM_EPS, momentum=BATCH_NORM_MOMENTUM)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if not self.training:
            return super().forward(x32).to(self.compute_dtype)
        mesh = current_mesh()
        if mesh is not None and mesh.n_data > 1:
            return self._global_forward(x32, mesh).to(self.compute_dtype)
        with torch.no_grad():
            # every axis but the channels': (B, H, W), or (B, T) in 1-D
            dims = (0, *range(2, x32.dim()))
            var, mean = torch.var_mean(x32, dim=dims, unbiased=False)
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.compute_dtype)

    def _global_forward(self, x32: torch.Tensor, mesh) -> torch.Tensor:
        dims = (0, *range(2, x32.dim()))
        shape = (1, -1) + (1,) * (x32.dim() - 2)
        n = mesh.n_data * (x32.numel() // x32.shape[1])  # equal rows on every rank
        mean = mesh.sum(x32.sum(dim=dims)) / n
        xc = x32 - mean.view(shape)
        var = mesh.sum((xc * xc).sum(dim=dims)) / n
        with torch.no_grad():
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return xc * scale.view(shape) + self.bias.view(shape)


class BatchNorm1d(BatchNorm):
    """``BatchNorm`` over (B, C, T): flax's ``nn.BatchNorm`` on the JAX
    package's (B, T, C), its statistics over (B, T). A subclass, so every
    BatchNorm rule (the bridge, ``batch_stats_discarded``, checkpoints)
    covers it."""

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() != 3:
            raise ValueError(f"expected a (B, C, T) input, got {x.dim()}-D")


class GroupNorm(nn.GroupNorm):
    """flax's ``nn.GroupNorm(group_size=8)``: statistics and normalization in
    float32, the output rounded once to the compute ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        if dim % GROUP_SIZE:
            raise ValueError(f"group norm needs channels divisible by {GROUP_SIZE}")
        super().__init__(dim // GROUP_SIZE, dim, eps=GROUP_NORM_EPS)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(torch.float32)).to(self.compute_dtype)


@contextlib.contextmanager
def batch_stats_discarded(module: nn.Module) -> Iterator[None]:
    """Train-mode passes inside leave every BatchNorm's running statistics
    as they were (flax's ``mutable=["batch_stats"]`` with the update
    dropped)."""
    norms = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    saved = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    try:
        yield
    finally:
        with torch.no_grad():
            for m, (mean, var) in zip(norms, saved):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)


def make_norm(norm: str, dim: int, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Normalization layer by name: ``batch`` (reference parity) or
    ``group`` (per-sample statistics, groups of 8 channels), with the
    compute ``dtype`` of its output."""
    if norm == "batch":
        return BatchNorm(dim, dtype)
    if norm == "group":
        return GroupNorm(dim, dtype)
    raise ValueError(f"unknown norm: {norm!r}")


def split_mesh():
    """The mesh a split layer runs on: the current one with a model axis."""
    mesh = model_axis()
    if mesh is None:
        raise RuntimeError("a split layer runs inside a step on a mesh with a model axis")
    return mesh


def _model_input(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A column-split layer's whole input, its gradient summed over the
    model group (``Mesh.copy_to_model``); ``x`` itself for a whole layer."""
    if not layer.model_split:
        return x
    return split_mesh().copy_to_model(x)


def gather_split(h: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """The whole channels (dim 1) of a column-split ``layer``'s output
    slice ``h``, gathered over the model group in the layer's own channel
    order (a gate's pre-activation is split in ``model_groups`` blocks);
    ``h`` itself after a whole layer."""
    if not getattr(layer, "model_split", False):
        return h
    return model_axis().gather_channels(h, groups=getattr(layer, "model_groups", 1))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's compute ``dtype`` (see the module
    docstring); float32 runs the stock convolution unchanged."""

    #: set by ``training.sharding``: this rank holds a slice of the outputs
    model_split = False

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _model_input(self, x)
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt)[:, None, None]


class Linear(nn.Linear):
    """``nn.Linear`` with flax's compute ``dtype`` (``nn.Dense(dtype=...)``);
    float32 runs the stock product unchanged. Under the model axis (see
    the module docstring) a "columns" split computes its output slice from
    the whole input, a "rows" split the whole output from its input slice."""

    #: set by ``training.sharding``: None, "columns" or "rows"
    model_split = None

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.model_split == "rows":
            partial = F.linear(x.to(dt), self.weight.to(dt))
            return split_mesh().reduce_from_model(partial) + self.bias.to(dt)
        if self.model_split == "columns":
            x = _model_input(self, x)
        if dt == torch.float32:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


#: flax's tanh-approximate gelu constants, sqrt(2 / pi) and the cubic term's
_GELU_C, _GELU_K = 0.7978845608028654, 0.044715


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (the tanh approximation). In bf16 it runs
    ``jax.nn.gelu``'s formula op by op, each rounded, with its constants
    rounded to bf16 first; ``F.gelu`` rounds once and differs from it in a
    bf16 ulp at about 45% of inputs."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    c, k = (torch.tensor(v, dtype=x.dtype, device=x.device) for v in (_GELU_C, _GELU_K))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: in bf16 1 / (1 + exp(-x)) with every op rounded,
    as XLA lowers it; ``torch.sigmoid`` rounds once and differs from it in
    a bf16 ulp at about 30% of inputs."""
    return 1.0 / (1.0 + torch.exp(-x)) if x.dtype == torch.bfloat16 else torch.sigmoid(x)


def gate(z: torch.Tensor, dim: int) -> torch.Tensor:
    """The gated activation tanh(a) * sigmoid(b) over the two halves of z
    along ``dim``."""
    a, b = z.chunk(2, dim=dim)
    return torch.tanh(a) * sigmoid(b)


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` with flax's compute ``dtype``, as ``Conv2d``. A caller
    that feeds one whole input to several split layers takes it through
    ``copy_to_model`` once and passes ``copied`` (one all-reduce of the
    summed input gradient instead of one a layer)."""

    model_split = False

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, copied: bool = False) -> torch.Tensor:
        if not copied:
            x = _model_input(self, x)
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y if self.bias is None else y + self.bias.to(dt)[:, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with flax's compute ``dtype``, as ``Conv2d``."""

    model_split = False

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _model_input(self, x)
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding,
                               self.output_padding, self.groups, self.dilation)
        return y + self.bias.to(dt)[:, None, None]


def conv_down(in_dim: int, dim: int, dtype: torch.dtype = torch.float32) -> Conv2d:
    """Stride-2 4x4 downsampling conv (torch Conv2d(k=4, s=2, p=1))."""
    return Conv2d(in_dim, dim, 4, stride=2, padding=1, dtype=dtype)


def conv_up(in_dim: int, dim: int, dtype: torch.dtype = torch.float32) -> ConvTranspose2d:
    """Stride-2 4x4 upsampling transpose conv, output 2H.

    The JAX package's flax ``ConvTranspose`` with padding "SAME" and no
    kernel flip computes the same function as ``ConvTranspose2d(4, 2, 1)``
    with a spatially flipped kernel whose in/out axes are swapped;
    ``convert.py`` applies that mapping."""
    return ConvTranspose2d(in_dim, dim, 4, stride=2, padding=1, dtype=dtype)


def conv1d_down(in_dim: int, dim: int) -> Conv1d:
    """Stride-2 width-4 downsampling conv over (B, C, T), output T/2: the
    JAX package's 1-D ``Conv(dim, (4,), strides=(2,), padding=((1, 1),))``,
    whose ``_s2d_conv`` lowering computes the same function."""
    return Conv1d(in_dim, dim, 4, stride=2, padding=1)


class ConvTranspose1dSame(nn.ConvTranspose1d):
    """flax's 1-D ``ConvTranspose(features, (k,), strides=(s,),
    padding="SAME")`` (no kernel flip): output length T * s.

    ``lax.conv_transpose`` pads the stride-dilated input with pad_a =
    ceil((k + s - 2) / 2) on the left (for k > s - 1) and correlates with the
    unflipped kernel. ``ConvTranspose1d`` with padding k - 1 - pad_a and the
    kernel flipped computes the same sums; for odd s it gives one sample
    more on the right, which is dropped. ``convert.py`` flips the kernel and
    swaps its in/out axes."""

    model_split = False

    def __init__(self, in_dim: int, dim: int, kernel_size: int, stride: int):
        pad_a = -(-(kernel_size + stride - 2) // 2)
        if stride > kernel_size - 1 or kernel_size - 1 - pad_a < 0:
            raise ValueError(f"unsupported SAME transpose conv k={kernel_size} s={stride}")
        super().__init__(in_dim, dim, kernel_size, stride=stride,
                         padding=kernel_size - 1 - pad_a)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(_model_input(self, x))[..., : x.shape[-1] * self.stride[0]]


class ResBlock(nn.Module):
    """Pre-activation residual block (models.py:145-158):
    ReLU -> 3x3 conv -> norm -> ReLU -> 1x1 conv -> norm, plus skip. The
    skip sum promotes as jnp does: a float32 input and a bf16 branch give a
    float32 output."""

    def __init__(self, dim: int, norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Conv_0 = Conv2d(dim, dim, 3, padding=1, dtype=dtype)
        self.add_module(norm_name(norm, 0), make_norm(norm, dim, dtype))
        self.Conv_1 = Conv2d(dim, dim, 1, dtype=dtype)
        self.add_module(norm_name(norm, 1), make_norm(norm, dim, dtype))
        self._norms = (norm_name(norm, 0), norm_name(norm, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x)
        h = getattr(self, self._norms[0])(self.Conv_0(h))
        h = gather_split(torch.relu(h), self.Conv_0)
        h = getattr(self, self._norms[1])(self.Conv_1(h))
        return x + gather_split(h, self.Conv_1)


def init_weights(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """The JAX package's initializers: Xavier-uniform kernels and zero
    biases for convolutions and dense layers (the reference's weights_init,
    models.py:25-32), unit scale and zero shift for norms. The same seed
    gives the same weights on every device."""
    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d,
                          nn.Linear)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()

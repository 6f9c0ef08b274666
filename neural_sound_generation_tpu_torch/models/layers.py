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
bf16 ops by its own list, which is not flax's.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

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
    |mean| / std = 100 (tests/test_torch_norm_stats.py)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim, eps=BATCH_NORM_EPS, momentum=BATCH_NORM_MOMENTUM)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        if not self.training:
            return super().forward(x32).to(self.compute_dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
        y = F.batch_norm(x32, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return y.to(self.compute_dtype)


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


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's compute ``dtype`` (see the module
    docstring); float32 runs the stock convolution unchanged."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return y + self.bias.to(dt)[:, None, None]


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with flax's compute ``dtype``, as ``Conv2d``."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


class ConvTranspose1dSame(nn.ConvTranspose1d):
    """flax's 1-D ``ConvTranspose(features, (k,), strides=(s,),
    padding="SAME")`` (no kernel flip): output length T * s.

    ``lax.conv_transpose`` pads the stride-dilated input with pad_a =
    ceil((k + s - 2) / 2) on the left (for k > s - 1) and correlates with the
    unflipped kernel. ``ConvTranspose1d`` with padding k - 1 - pad_a and the
    kernel flipped computes the same sums; for odd s it gives one sample
    more on the right, which is dropped. ``convert.py`` flips the kernel and
    swaps its in/out axes."""

    def __init__(self, in_dim: int, dim: int, kernel_size: int, stride: int):
        pad_a = -(-(kernel_size + stride - 2) // 2)
        if stride > kernel_size - 1 or kernel_size - 1 - pad_a < 0:
            raise ValueError(f"unsupported SAME transpose conv k={kernel_size} s={stride}")
        super().__init__(in_dim, dim, kernel_size, stride=stride,
                         padding=kernel_size - 1 - pad_a)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[..., : x.shape[-1] * self.stride[0]]


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
        h = torch.relu(h)
        h = getattr(self, self._norms[1])(self.Conv_1(h))
        return x + h


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

"""The port's train-mode norm statistics held against the float64 exact
answer, and their gap to flax recorded, on the CPU.

flax 0.12.3's ``BatchNorm``, ``GroupNorm`` and ``LayerNorm`` take the
variance as E[x^2] - E[x]^2 in float32 (``use_fast_variance=True``). That
formula cancels: its error grows with (|mean| / std)^2. The port takes the
two-pass variance (``torch.var_mean``, ``nn.GroupNorm``, ``nn.LayerNorm``),
whose error grows only with the rounding of |mean| itself. So the port
stays near the exact statistics where flax drifts, and matching flax more
closely would mean copying XLA's CPU summation order, which no card run
keeps and which is less accurate. These tests pin both facts.

Inputs are m + N(0, 1) from ``default_rng(0)`` at |mean| / std = m in
{0, 4.3, 10, 100} (4.3 is what the flagship's first BatchNorm sees on a
uniform [0, 1] mel batch), with seeded scale and bias and a seeded
cotangent. The exact answer is computed in float64 with numpy: mean, biased
variance, normalized output, the input gradient in closed form and, for
BatchNorm, the running averages after one step from (0, 1).

Measured largest absolute differences over the three norms (output and
input gradient), from which the limits below were set at 2-4x:

| m | port vs exact | flax vs port |
|---|---|---|
| 0 | 5.9e-7 | 3.3e-6 |
| 4.3 | 1.4e-6 | 8.1e-5 |
| 10 | 2.1e-6 | 3.1e-4 |
| 100 | 1.6e-5 | 5.2e-2 |

BatchNorm's running mean and variance are within 8.5e-8 of exact at every
m (the variance's 0.99 + 0.01 * var rounds at 1's half ulp); flax's running
variance is 2.8e-4 off at m = 100.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from neural_sound_generation_tpu_torch.models import layers
from neural_sound_generation_tpu_torch.models.transformer_prior import LAYER_NORM_EPS

torch.set_num_threads(1)

MEANS = (0.0, 4.3, 10.0, 100.0)
#: port vs the float64 exact output and input gradient
PORT_LIMIT = {0.0: 2e-6, 4.3: 4e-6, 10.0: 6e-6, 100.0: 4e-5}
#: BatchNorm's running mean and variance after one step, port vs exact
RUNNING_LIMIT = 2e-7
#: flax vs port: output, input gradient and running statistics
FLAX_GAP_LIMIT = {0.0: 1e-5, 4.3: 2e-4, 10.0: 1e-3, 100.0: 1.5e-1}
#: from |mean| / std = 4.3 on, flax's error is over 5x the port's
FLAX_WORSE_FROM = 4.3
FLAX_WORSE_FACTOR = 5.0
NORMS = ("batch", "group", "layer")
SHAPES = {"batch": (16, 10, 7, 8), "group": (4, 10, 7, 16), "layer": (8, 20, 64)}


def _inputs(kind, m):
    rng = np.random.default_rng(0)
    shape = SHAPES[kind]
    c = shape[-1]
    x = (m + rng.standard_normal(shape)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, g, scale, bias


def _exact(kind, x, g, scale, bias):
    """float64 output, input gradient of sum(g * y), mean and biased
    variance (over what each norm normalizes)."""
    x = x.astype(np.float64)
    gs = g.astype(np.float64) * scale  # the cotangent of the normalized x
    shape = x.shape
    if kind == "batch":
        axes, eps = (0, 1, 2), layers.BATCH_NORM_EPS
    elif kind == "group":  # (N, H, W, G, 8): per sample and group of 8 channels
        x = x.reshape(*shape[:-1], -1, layers.GROUP_SIZE)
        gs = gs.reshape(x.shape)
        axes, eps = (1, 2, 4), layers.GROUP_NORM_EPS
    else:
        axes, eps = (-1,), LAYER_NORM_EPS
    mean = x.mean(axis=axes, keepdims=True)
    var = ((x - mean) ** 2).mean(axis=axes, keepdims=True)
    sigma = np.sqrt(var + eps)
    xhat = (x - mean) / sigma
    dx = (gs - gs.mean(axis=axes, keepdims=True)
          - xhat * (gs * xhat).mean(axis=axes, keepdims=True)) / sigma
    y = xhat.reshape(shape) * scale + bias
    return y, dx.reshape(shape), mean.squeeze(), var.squeeze()


def _port(kind, x, g, scale, bias):
    """The port's train-mode norm: output, input gradient and, for
    BatchNorm, the running mean and variance after the step."""
    c = x.shape[-1]
    if kind == "batch":
        mod = layers.BatchNorm(c)
    elif kind == "group":
        mod = layers.GroupNorm(c)
    else:
        mod = torch.nn.LayerNorm(c, eps=LAYER_NORM_EPS)  # as the prior builds it
    mod.train()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
    channels_first = kind != "layer"
    xt = torch.from_numpy(x)
    gt = torch.from_numpy(g)
    if channels_first:  # NHWC -> the port's NCHW
        xt, gt = xt.permute(0, 3, 1, 2).contiguous(), gt.permute(0, 3, 1, 2)
    xt.requires_grad_(True)
    y = mod(xt)
    (y * gt).sum().backward()
    y, dx = y.detach(), xt.grad
    if channels_first:
        y, dx = y.permute(0, 2, 3, 1), dx.permute(0, 2, 3, 1)
    running = None
    if kind == "batch":
        running = (mod.running_mean.numpy(), mod.running_var.numpy())
    return y.numpy(), dx.numpy(), running


def _flax(kind, x, g, scale, bias):
    """flax 0.12.3's norm on its defaults, as the JAX package builds it."""
    c = x.shape[-1]
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    if kind == "batch":
        mod = fnn.BatchNorm(use_running_average=False)
        variables["batch_stats"] = {"mean": jnp.zeros(c), "var": jnp.ones(c)}

        def apply(v):
            return mod.apply(variables, v, mutable=["batch_stats"])
    else:
        mod = fnn.GroupNorm(num_groups=None, group_size=layers.GROUP_SIZE) \
            if kind == "group" else fnn.LayerNorm()

        def apply(v):
            return mod.apply(variables, v), None

    y, updated = apply(jnp.asarray(x))
    dx = jax.grad(lambda v: jnp.sum(apply(v)[0] * jnp.asarray(g)))(jnp.asarray(x))
    running = None
    if updated is not None:
        stats = updated["batch_stats"]
        running = (np.asarray(stats["mean"]), np.asarray(stats["var"]))
    return np.asarray(y), np.asarray(dx), running


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.parametrize("m", MEANS)
@pytest.mark.parametrize("kind", NORMS)
def test_port_norm_is_within_its_limit_of_the_exact_statistics(kind, m):
    x, g, scale, bias = _inputs(kind, m)
    y64, dx64, mean64, var64 = _exact(kind, x, g, scale, bias)
    y, dx, running = _port(kind, x, g, scale, bias)
    assert _max_abs(y, y64) <= PORT_LIMIT[m]
    assert _max_abs(dx, dx64) <= PORT_LIMIT[m]
    if kind == "batch":
        keep = 1.0 - layers.BATCH_NORM_MOMENTUM
        assert _max_abs(running[0], layers.BATCH_NORM_MOMENTUM * mean64) <= RUNNING_LIMIT
        assert _max_abs(running[1], keep + layers.BATCH_NORM_MOMENTUM * var64) <= RUNNING_LIMIT


@pytest.mark.parametrize("m", MEANS)
@pytest.mark.parametrize("kind", NORMS)
def test_gap_to_flax_is_flax_rounding(kind, m):
    """The port sits within the recorded gap of flax and, from |mean| / std
    = 4.3 on, much nearer the exact answer than flax is."""
    x, g, scale, bias = _inputs(kind, m)
    y64, dx64, _, var64 = _exact(kind, x, g, scale, bias)
    y, dx, running = _port(kind, x, g, scale, bias)
    fy, fdx, frunning = _flax(kind, x, g, scale, bias)
    assert _max_abs(y, fy) <= FLAX_GAP_LIMIT[m]
    assert _max_abs(dx, fdx) <= FLAX_GAP_LIMIT[m]
    if kind == "batch":
        assert _max_abs(running[0], frunning[0]) <= FLAX_GAP_LIMIT[m]
        assert _max_abs(running[1], frunning[1]) <= FLAX_GAP_LIMIT[m]
    if m >= FLAX_WORSE_FROM:
        assert FLAX_WORSE_FACTOR * _max_abs(y, y64) < _max_abs(fy, y64)
        assert FLAX_WORSE_FACTOR * _max_abs(dx, dx64) < _max_abs(fdx, dx64)

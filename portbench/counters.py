"""Operations and bytes counted from shapes, and the chip's peaks.

Every count is the work the algorithm needs: a multiply-add is two
operations, an input is read once and an output written once, whatever a
kernel reads again. Elementwise work (activations, norms, the loss) is left
out of the model counts, so a share of the peak computed from them is a
lower bound of the device's real rate.
"""

from __future__ import annotations

import math

#: NVIDIA H100 SXM, dense, at the full 700 W (NVIDIA's data sheet). A
#: float32 cell is held against the TF32 tensor-core rate, which no correct
#: float32 implementation can pass (a 3xTF32 product passes the 67 TFLOP/s
#: float32 SIMT rate); a bfloat16 cell against the bfloat16 rate.
PEAK_FLOPS = {"f32": 495e12, "bf16": 989e12}
PEAK_BYTES_PER_S = 3.35e12


def conv_flops(out_positions: int, cin: int, cout: int, taps: int) -> int:
    """A convolution's operations: 2 x (inputs a tap) x taps x outputs."""
    return 2 * out_positions * cin * cout * taps


def conv_transpose_flops(in_positions: int, cin: int, cout: int, taps: int) -> int:
    """A transposed convolution scatters every input through every tap."""
    return 2 * in_positions * cin * cout * taps


def vq_nearest_flops(n: int, k: int, d: int) -> int:
    """The nearest-code search's dot products: 2 N K D."""
    return 2 * n * k * d


def vq_nearest_bytes(n: int, k: int, d: int) -> int:
    """float32 rows and codes read once, one int32 index written a row."""
    return 4 * (n * d + k * d) + 4 * n


def fused_adam_bytes(n: int, moment_bytes: int = 4, ema: bool = True) -> int:
    """One fused Adam(+EMA) pass over n parameters: the gradient, the
    parameters, both moments and the EMA read; all but the gradient
    written."""
    per = 4 + 4 + 2 * moment_bytes + (4 if ema else 0)  # read
    per += 4 + 2 * moment_bytes + (4 if ema else 0)  # written
    return n * per


def roofline_seconds(flops: float, nbytes: float, precision: str) -> float:
    """The least time the chip needs: the larger of operations over the
    peak rate and bytes over the peak bandwidth."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES_PER_S)


def training_flops(forward_convs, first_layer: str) -> int:
    """Forward and backward operations of one step, no recompute: every
    convolution's forward, its weight gradient (as many operations) and its
    input gradient (as many again) except the first layer's, whose input
    needs none. ``forward_convs`` maps a layer name to its forward
    operations; ``first_layer`` names the layer that reads the input."""
    total = sum(forward_convs.values())
    return 3 * total - forward_convs[first_layer]


def vqvae_forward_convs(batch: int, mels: int, frames: int, dim: int, input_dim: int = 1):
    """The mel VQ-VAE's convolutions at a batch of (mels, frames) crops."""
    h1, w1 = mels // 2, frames // 2
    h2, w2 = mels // 4, frames // 4
    p1, p2 = batch * h1 * w1, batch * h2 * w2
    convs = {
        "encoder.Conv_0": conv_flops(p1, input_dim, dim, 16),
        "encoder.Conv_1": conv_flops(p2, dim, dim, 16),
        "decoder.ConvTranspose_0": conv_transpose_flops(p2, dim, dim, 16),
        "decoder.ConvTranspose_1": conv_transpose_flops(p1, dim, input_dim, 16),
    }
    for side in ("encoder", "decoder"):
        for r in range(2):
            convs[f"{side}.ResBlock_{r}.Conv_0"] = conv_flops(p2, dim, dim, 9)
            convs[f"{side}.ResBlock_{r}.Conv_1"] = conv_flops(p2, dim, dim, 1)
    return convs


def vqvae_step_flops(batch: int, mels: int, frames: int, dim: int, codes: int) -> int:
    """A training step of the mel VQ-VAE: its convolutions forward and
    backward and one nearest-code search (no gradient)."""
    convs = vqvae_forward_convs(batch, mels, frames, dim)
    rows = batch * (mels // 4) * (frames // 4)
    return training_flops(convs, "encoder.Conv_0") + vq_nearest_flops(rows, codes, dim)


def wavenet_forward_convs(batch: int, samples: int, frames: int, layers: int, residual: int,
                          gate: int, skip: int, cin: int, out: int, scales=(4, 4, 4, 4)):
    """The WaveNet's convolutions at a batch of ``samples``-sample crops
    conditioned on ``frames`` mel frames."""
    pos = batch * samples
    convs = {"first_conv": conv_flops(pos, 1, residual, 1)}
    length = frames
    for j, s in enumerate(scales):
        convs[f"upsampler.ConvTranspose_{j}"] = conv_transpose_flops(batch * length, cin, cin,
                                                                     2 * s)
        length *= s
    for i in range(layers):
        convs[f"dilated_{i}"] = conv_flops(pos, residual, gate, 3)
        convs[f"cond_{i}"] = conv_flops(pos, cin, gate, 1)
        convs[f"res_{i}"] = conv_flops(pos, gate // 2, residual, 1)
        convs[f"skip_{i}"] = conv_flops(pos, gate // 2, skip, 1)
    convs["post1"] = conv_flops(pos, skip, skip, 1)
    convs["post2"] = conv_flops(pos, skip, out, 1)
    return convs


def wavenet_step_flops(batch: int, samples: int, frames: int, layers: int, residual: int,
                       gate: int, skip: int, cin: int, out: int) -> int:
    """A teacher-forced training step of the WaveNet, forward and backward.
    The mel is an input too, so the upsampler's first layer needs no input
    gradient either."""
    convs = wavenet_forward_convs(batch, samples, frames, layers, residual, gate, skip, cin, out)
    return training_flops(convs, "first_conv") - convs["upsampler.ConvTranspose_0"]


def kernel_share(flops: float, nbytes: float, seconds: float, precision: str) -> float | None:
    """Percent of the roofline a kernel reached, or None where it did not run."""
    if seconds <= 0 or not math.isfinite(seconds):
        return None
    return 100.0 * roofline_seconds(flops, nbytes, precision) / seconds

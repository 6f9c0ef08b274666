"""The operation and byte counters against counts made by hand."""

import pytest

from portbench import counters


def test_conv_counts_by_hand():
    # a 3x3 convolution 2 -> 3 channels at 4 output positions: 4*3 outputs,
    # each 2*9 multiply-adds
    assert counters.conv_flops(4, 2, 3, 9) == 2 * 4 * 3 * 2 * 9
    assert counters.conv_transpose_flops(5, 2, 1, 16) == 2 * 5 * 2 * 16


def test_vq_counts_by_hand():
    assert counters.vq_nearest_flops(10, 4, 3) == 240
    assert counters.vq_nearest_bytes(10, 4, 3) == 4 * (30 + 12) + 40


@pytest.mark.parametrize("moment_bytes, ema, per", [(4, True, 36), (4, False, 28), (2, True, 28)])
def test_fused_adam_bytes_by_hand(moment_bytes, ema, per):
    # read g, p, m, v (and ema); write p, m, v (and ema)
    assert counters.fused_adam_bytes(1000, moment_bytes, ema) == 1000 * per


def test_vqvae_step_by_hand():
    # batch 1 of 8 x 8 crops, dim 2, 3 codes: positions 16 after the first
    # stride, 4 after the second
    b, d = 1, 2
    enc0 = 2 * 16 * 1 * d * 16
    enc1 = 2 * 4 * d * d * 16
    res = 2 * 4 * d * d * 9 + 2 * 4 * d * d
    dec0 = 2 * 4 * d * d * 16
    dec1 = 2 * 16 * d * 1 * 16
    forward = enc0 + enc1 + 4 * res + dec0 + dec1
    vq = 2 * 4 * 3 * d
    expected = 3 * forward - enc0 + vq
    assert counters.vqvae_step_flops(b, 8, 8, d, 3) == expected


def test_wavenet_step_by_hand():
    # batch 1, 256 samples from 1 frame (x4 four times), 1 layer, R = G = 4,
    # S = 2, 3 mel channels, 6 outputs
    p = 256
    first = 2 * p * 1 * 4
    ups = [2 * n * 3 * 3 * 8 for n in (1, 4, 16, 64)]
    layer = 2 * p * 4 * 4 * 3 + 2 * p * 3 * 4 + 2 * p * 2 * 4 + 2 * p * 2 * 2
    head = 2 * p * 2 * 2 + 2 * p * 2 * 6
    forward = first + sum(ups) + layer + head
    # no input gradient into the samples or the mel
    expected = 3 * forward - first - ups[0]
    assert counters.wavenet_step_flops(1, 256, 1, 1, 4, 4, 2, 3, 6) == expected


def test_roofline_takes_the_binding_side():
    assert counters.roofline_seconds(495e12, 0, "f32") == pytest.approx(1.0)
    assert counters.roofline_seconds(0, 3.35e12, "bf16") == pytest.approx(1.0)
    assert counters.kernel_share(495e9, 0, 0.002, "f32") == pytest.approx(50.0)
    assert counters.kernel_share(1.0, 1.0, 0.0, "f32") is None

"""The 3x3 bf16 convolution of ops/cuda/conv3x3.py held against the JAX A/B
script's three functions (``scripts/ab_conv3x3.py``: ``xla_conv`` and the
Pallas ``pallas_conv`` and ``pallas_conv_im2col`` in interpret mode), on the
CPU.

The script is loaded as a module and sized through its globals (``B, H, W,
C`` and the Pallas batch tiles ``BT, BT2``); the file itself is not edited.
All four sum the same bf16 x bf16 products (each exact in float32) in
float32 and round once to bf16, but the float32 sums run in another order
inside each dot (PyTorch's CPU matmul against XLA's): a few float32 ulps
apart, they round to neighbouring bf16 values on about one output in
1000-2000 at these sizes (0 to 4 of 672-3584 outputs over six seeds). So
every output is within 1 bf16 ulp and at least 99.5% are bit-equal. On the
CPU the kernels' wrappers run the plain version; the kernels are held
against it on the card by ``chip_smoke.py`` and
``scripts/torch_ab_conv3x3.py``.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_sound_generation_tpu_torch.ops.cuda import conv3x3

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ab():
    spec = importlib.util.spec_from_file_location(
        "jax_ab_conv3x3", os.path.join(REPO, "scripts", "ab_conv3x3.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _inputs(b, h, w, c, seed=0):
    """x and w as the A/B scripts draw them, rounded to bf16 once."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, c, c)) * 0.02).astype(np.float32)
    return (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(wt).to(torch.bfloat16))


def _jax(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


# (B, H, W, C, BT, BT2): odd W, C 32 and 64; each shape distinct, so each
# traces the script's jitted functions anew with its globals. The last four
# are the ends of the kernels' contract that chip_smoke.py's CONV_SHAPES
# holds the kernels to on the card: C = 16 (the least, under one
# 128-channel tile), C = 512, W > 66 (the taps route's halo in three
# segments), and H = 1 with 150 pixels (not a multiple of 64) and C = 48 (a
# partial 64-channel chunk)
@pytest.mark.parametrize("b,h,w,c,bt,bt2", [
    (4, 5, 3, 32, 2, 2),
    (2, 3, 5, 64, 1, 1),
    (3, 7, 1, 32, 3, 1),
    (2, 4, 7, 64, 2, 2),
    (2, 5, 3, 16, 2, 1),
    (4, 9, 11, 512, 2, 4),
    (1, 3, 70, 32, 1, 1),
    (3, 1, 50, 48, 3, 1),
])
def test_plain_matches_xla_and_both_pallas_kernels_within_one_ulp(ab, b, h, w, c, bt, bt2):
    ab.B, ab.H, ab.W, ab.C, ab.BT, ab.BT2 = b, h, w, c, bt, bt2
    x, wt = _inputs(b, h, w, c, seed=c + w)
    got = conv3x3.conv3x3_plain(x, wt)
    assert got.dtype == torch.bfloat16 and got.shape == (b, h, w, c)
    want = {
        "xla": ab.xla_conv(_jax(x), _jax(wt)),
        "pallas_taps": ab.pallas_conv(_jax(x), _jax(wt), interpret=True),
        "pallas_im2col": ab.pallas_conv_im2col(_jax(x), _jax(wt), interpret=True),
    }
    for name, ref in want.items():
        ref = torch.from_numpy(np.asarray(ref, np.float32)).to(torch.bfloat16)
        ulps = conv3x3.bf16_ulp_error(got, ref)
        assert float(ulps.max()) <= 1, name
        assert float((ulps == 0).float().mean()) >= 0.995, name
    # the wrappers take the plain version for CPU tensors
    for name in conv3x3.KERNELS:
        assert torch.equal(getattr(conv3x3, name)(x, wt), got), name


def test_plain_sums_every_tap_with_zero_padding():
    """One-hot inputs: each output pixel collects exactly the taps that see
    an input pixel inside the image."""
    x = torch.zeros(1, 3, 4, 16, dtype=torch.bfloat16)
    x[0, 0, 0, 0] = 1.0  # a corner pixel reaches four outputs
    wt = torch.zeros(3, 3, 16, 16, dtype=torch.bfloat16)
    for tap in range(9):
        wt[tap // 3, tap % 3, 0, 0] = float(tap + 1)
    out = conv3x3.conv3x3_plain(x, wt)[0, :, :, 0].float()
    want = torch.zeros(3, 4)
    # output (h, w) reads input (h + dy - 1, w + dx - 1): the corner is tap
    # (1 - h, 1 - w) of outputs (0, 0), (0, 1), (1, 0), (1, 1)
    want[0, 0], want[0, 1], want[1, 0], want[1, 1] = 5.0, 4.0, 2.0, 1.0
    assert torch.equal(out, want)


def test_bf16_ulp_error():
    want = torch.tensor([1.0, 1.0, -1.0, 3.0, 0.0, 2.0**-12, 256.0], dtype=torch.bfloat16)
    got = torch.tensor([1.0, 1.0078125, -1.0078125, 3.046875, 0.0, -(2.0**-12), 254.0],
                       dtype=torch.bfloat16)
    err = conv3x3.bf16_ulp_error(got, want)
    # ulps of 2**-7 at [1, 2), 2**-6 at [2, 4), 2 at 256; below the floor
    # 256 * 2**-8 = 1 the ulp is 2**-7
    assert err.tolist() == [0.0, 1.0, 1.0, 3.0, 0.0, 2.0**-11 / 2.0**-7, 1.0]
    zeros = torch.zeros(3, dtype=torch.bfloat16)
    assert float(conv3x3.bf16_ulp_error(zeros, zeros).max()) == 0.0


def test_wrappers_reject_what_the_kernels_do_not_take():
    x, wt = _inputs(1, 2, 3, 32)
    bad = [
        (x.float(), wt.float()),                       # dtype
        (x, wt[:, :, :16]),                            # w not (3, 3, C, C)
        (x[..., :24].contiguous(), wt[:, :, :24, :24].contiguous()),  # C % 16
        (torch.zeros(1, 1, 1, 528, dtype=torch.bfloat16),
         torch.zeros(3, 3, 528, 528, dtype=torch.bfloat16)),  # C > 512
        (x.transpose(1, 2), wt),                       # not contiguous
        (x[0], wt),                                    # not 4-D
        (x.to("meta"), wt.to("meta")),                 # neither CPU nor CUDA
    ]
    for name in conv3x3.KERNELS:
        for a, b in bad:
            with pytest.raises(ValueError):
                getattr(conv3x3, name)(a, b)


@pytest.mark.parametrize("name", conv3x3.KERNELS)
def test_launch_plan_refuses_without_a_card(name):
    """launch_plan reports a launch only for CUDA tensors the kernels take:
    it checks the name, the shapes and the device before it loads the
    library."""
    x, wt = _inputs(1, 2, 3, 32)
    with pytest.raises(ValueError, match="unknown kernel"):
        conv3x3.launch_plan("conv3x3_" + name, x, wt)
    with pytest.raises(ValueError, match="CUDA"):
        conv3x3.launch_plan(name, x, wt)
    with pytest.raises(ValueError):
        conv3x3.launch_plan(name, x, wt[:, :, :16])
    with pytest.raises(ValueError):
        conv3x3.launch_plan(name, x.float(), wt.float())


def test_cuda_route_raises_without_cuda(monkeypatch):
    """The kernels' loader refuses rather than falling back to the CPU."""
    from neural_sound_generation_tpu_torch.ops.cuda import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(conv3x3, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        conv3x3.load()


def test_ab_script_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_ab_conv3x3.py"), "--iters", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "summary" not in out.stdout


def _phase_script():
    spec = importlib.util.spec_from_file_location(
        "torch_conv3x3_phases", os.path.join(REPO, "scripts", "torch_conv3x3_phases.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_phase_profile_instruments_the_current_mainloop():
    """The phase profile's insertions each find exactly one place in the
    kernel source, so a change to the mainloop stops the script instead of
    timing the wrong phases."""
    script = _phase_script()
    src = conv3x3.SOURCE.read_text()
    out = script.instrumented_source(src)
    assert out.count("clock64()") == 10  # start, eight per step, end
    assert "int conv3x3_phases(" in out
    with pytest.raises(RuntimeError, match="mainloop changed"):
        script.instrumented_source(src.replace("wgmma_wait<1>();  // block 0 is done", ""))


def test_phase_profile_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_conv3x3_phases.py")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "warp0" not in out.stdout

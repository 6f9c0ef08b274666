"""The whole-loop generation kernel's plain versions
(ops/cuda/wavenet_gen.py) held against the JAX package's Pallas kernel in
interpret mode and against the float32 incremental path, on the CPU; its
shape predicate; ``make_generate_fn``'s dispatch; and the wrapper's refusal
to serve a non-CPU tensor without the kernel.

Tolerances: teacher logits within 2e-2 of Pallas interpret mode and of the
f32 ``incremental_forward``: the same bf16 rounding points as the Pallas
kernel, float32 sums in another order, and a rounding that lands on the
other side of a bf16 step moves that value by 2**-8 relative (the JAX
package's own kernel test holds its kernel to 2e-2). The plain sampler
against the plain teacher on the sampler's own trajectory: 1e-3 at every
step but Gumbel-max near-ties (top-2 gap below 1e-3).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.models import wavenet as jwn
from neural_sound_generation_tpu.ops.pallas import wavenet_gen as jgen
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.models import wavenet as wn
from neural_sound_generation_tpu_torch.ops.cuda import build, wavenet_gen

torch.set_num_threads(1)

# the JAX kernel test's configuration (tests/test_wavenet.py:335-350)
CFG = dict(out_channels=30, layers=4, stacks=2, residual_channels=128, gate_channels=256,
           skip_out_channels=128, cin_channels=80, upsample_scales=(2, 2), scalar_input=True)
T, HOP = 64, 4
TOL = 2e-2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    c = rng.standard_normal((1, T // HOP, 80)).astype(np.float32)
    x = (rng.standard_normal((1, T, 1)) * 0.3).astype(np.float32)
    xs = np.array(jwn.WaveNet.shift_inputs(jnp.asarray(x), True))
    jm = jwn.WaveNet(**CFG)
    v = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0), jnp.asarray(xs),
                                                 c=jnp.asarray(c)))
    tm = wn.WaveNet(**CFG)
    tm.load_state_dict(convert.flax_to_state_dict(v))
    tm.eval()
    with torch.no_grad():
        c_up = wn._upsample_cond(tm, torch.from_numpy(c))[0]
    return jm, v, tm, c, xs, c_up, wavenet_gen.pack_weights(tm)


def test_teacher_plain_matches_pallas_interpret(setup):
    jm, v, tm, c, xs, c_up, packed = setup
    jc_up = jwn._upsample_cond(jm, v, jnp.asarray(c))[0]
    np.testing.assert_allclose(c_up.numpy(), np.asarray(jc_up), atol=1e-5)
    want = np.asarray(jgen.pallas_teacher_logits(jm, v, jc_up, jnp.asarray(xs[0, :, 0]),
                                                 interpret=True))
    got = wavenet_gen.wavenet_teacher_logits(packed, c_up, torch.from_numpy(xs[0, :, 0]))
    assert got.shape == want.shape == (T, 30)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_teacher_plain_matches_f32_incremental(setup):
    _, _, tm, c, xs, c_up, packed = setup
    ref = wn.incremental_forward(tm, torch.from_numpy(xs), torch.from_numpy(c))[0]
    got = wavenet_gen.wavenet_teacher_logits(packed, c_up, torch.from_numpy(xs[0, :, 0]))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL, rtol=0)


def test_sampler_reproduces_itself_through_the_teacher(setup):
    """The plain sampler's samples, fed back shifted through the plain
    teacher and sampled with the same noise, come back: the card check's
    one-step consistency, here on the CPU."""
    _, _, tm, _, _, c_up, packed = setup
    gum, unif = wn.draw_noise(tm, torch.Generator().manual_seed(3), T, 1)
    samples = wavenet_gen.wavenet_generate(packed, c_up, gum[:, 0], unif[:, 0], T)
    assert samples.shape == (T,) and samples.abs().max() <= 1.0
    # random init clips many samples to +-1; enough stay inside to test
    assert int((samples.abs() < 1.0).sum()) > T // 4
    x_in = torch.nn.functional.pad(samples[:-1], (1, 0))
    logits = wavenet_gen.wavenet_teacher_logits(packed, c_up, x_in)
    again = wn.sample_mol(logits, gum[:, 0], unif[:, 0])
    top2 = torch.topk(logits[:, :10] + gum[:, 0], 2).values
    near_tie = (top2[:, 0] - top2[:, 1]) < 1e-3
    off = (again - samples).abs() > 1e-3
    assert not bool((off & ~near_tie).any()), torch.nonzero(off & ~near_tie)


def test_sampler_matches_the_scan_sampler_in_f32(setup):
    """The kernel's sampling function against the f32 scan sampler on the
    same noise: equal within bf16 noise at every step (random init keeps
    the mixture choice far from ties over these steps, or the check says
    where it stopped)."""
    _, _, tm, c, _, c_up, packed = setup
    n = 24
    gum, unif = wn.draw_noise(tm, torch.Generator().manual_seed(4), n, 1)
    kern = wavenet_gen.wavenet_generate(packed, c_up, gum[:, 0], unif[:, 0], n)
    scan = wn.make_generate_fn(tm, n)(torch.from_numpy(c), noise=(gum, unif))[0]
    np.testing.assert_allclose(kern[:8].numpy(), scan[:8].numpy(), atol=5e-2)


GOOD = dict(out_channels=30, layers=24, stacks=4, residual_channels=128, gate_channels=256,
            skip_out_channels=128, kernel_size=3, cin_channels=80, gin_channels=-1,
            scalar_input=True)


def _shape(**kw):
    """The attributes the predicate reads, without building weights."""
    return types.SimpleNamespace(**{**GOOD, **kw})


@pytest.mark.parametrize("kw,ok", [
    (dict(), True),  # the production configuration of the kernel's docstring
    (dict(scalar_input=False, out_channels=256), False),  # categorical
    (dict(cin_channels=-1), False),  # unconditioned
    (dict(gin_channels=16), False),  # speaker-conditioned
    (dict(residual_channels=96, gate_channels=192), False),  # misaligned
    (dict(residual_channels=512, gate_channels=1024, skip_out_channels=512), False),
    # the CLI's default vocoder: R = G = 512, S = 256 is past the 10 MB cap
    (dict(residual_channels=512, gate_channels=512, skip_out_channels=256), False),
    (dict(layers=8, stacks=2), True),
    (dict(cin_channels=130), False),
])
def test_supported_predicate(kw, ok):
    """The cases of tests/test_wavenet.py:353-380, and the same answer as
    the Pallas predicate."""
    assert wavenet_gen.generate_supported(_shape(**kw), 1) is ok
    assert jgen.pallas_generate_supported(jwn.WaveNet(**{**GOOD, **kw}), 1) is ok
    assert not wavenet_gen.generate_supported(_shape(**kw), 2)


def test_production_weight_bytes():
    assert wavenet_gen._weight_bytes(_shape()) == 7_274_496  # about 7.3 MB of bf16


def test_dispatch(setup, monkeypatch):
    """Batch 1 with mels and no speaker goes to the kernel's wrapper; batch
    2, a speaker id or no mels take the scan; the assertion guards shapes
    the kernel does not take."""
    _, _, tm, c, _, _, _ = setup
    calls = []
    real = wavenet_gen.wavenet_generate

    def spy(*a, **k):
        calls.append(a[-1])
        return real(*a, **k)

    monkeypatch.setattr(wavenet_gen, "wavenet_generate", spy)
    gen = wn.make_generate_fn(tm, 8, use_kernel=True)
    ct = torch.from_numpy(c)
    out = gen(ct, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 8) and calls == [8]
    assert gen(ct.repeat(2, 1, 1), generator=torch.Generator(), batch_size=2).shape == (2, 8)
    assert gen(ct, torch.zeros(1, dtype=torch.long), torch.Generator()).shape == (1, 8)
    assert gen(None, generator=torch.Generator()).shape == (1, 8)
    assert calls == [8]
    with pytest.raises(AssertionError, match="qualify"):
        wn.make_generate_fn(wn.WaveNet(**{**CFG, "residual_channels": 96}), 8, use_kernel=True)
    # the same noise gives the same samples through the dispatch and the wrapper
    noise = wn.draw_noise(tm, torch.Generator().manual_seed(9), 8, 1)
    a = gen(ct, noise=noise)[0]
    with torch.no_grad():
        b = real(wavenet_gen.pack_weights(tm), wn._upsample_cond(tm, ct)[0],
                 noise[0][:, 0], noise[1][:, 0], 8)
    assert torch.equal(a, b)


def test_wrapper_refuses_non_cpu_tensors(setup, monkeypatch):
    """A tensor off the CPU is never served by the plain version: the
    kernel's loader refuses without CUDA, and other devices raise."""
    _, _, tm, _, xs, c_up, packed = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(wavenet_gen, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        wavenet_gen.load()
    meta = wavenet_gen.PackedWeights(
        **{f.name: (getattr(packed, f.name).to("meta")
                    if isinstance(getattr(packed, f.name), torch.Tensor)
                    else getattr(packed, f.name))
           for f in dataclasses.fields(packed)})
    with pytest.raises(ValueError, match="CUDA"):
        wavenet_gen.wavenet_teacher_logits(meta, c_up.to("meta"),
                                           torch.zeros(T, device="meta"))
    with pytest.raises(ValueError):  # weights on another device than the input
        wavenet_gen.wavenet_teacher_logits(packed, c_up.to("meta"), torch.zeros(T))
    with pytest.raises(ValueError):  # too little conditioning
        wavenet_gen.wavenet_teacher_logits(packed, c_up[:10], torch.zeros(T))


def test_kernel_order_matvec_is_a_matvec():
    """_matvec sums in the kernel's slice order and still computes x @ w
    (float64 reference, ragged slices included)."""
    g = torch.Generator().manual_seed(0)
    for rows, cols in ((384, 256), (80, 6144), (100, 32), (7, 1024)):
        x = torch.randn(3, rows, generator=g).to(torch.bfloat16).float()
        w = torch.randn(rows, cols, generator=g).to(torch.bfloat16)
        got = wavenet_gen._matvec(x, w)
        want = (x.double() @ w.double()).float()
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)


def test_shared_memory_fits_at_the_production_configuration():
    prod = wn.WaveNet(out_channels=30, layers=24, stacks=4, residual_channels=128,
                      gate_channels=256, skip_out_channels=128, cin_channels=80)
    packed = wavenet_gen.pack_weights(prod)
    assert packed.dims["RD"] == 65 and packed.dims["OUTP"] == 32
    assert wavenet_gen.smem_bytes(packed) <= wavenet_gen.SMEM_LIMIT

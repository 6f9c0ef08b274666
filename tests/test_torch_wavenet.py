"""The port's WaveNet vocoder (models/wavenet.py, the 1-D transpose conv of
models/layers.py, the WaveNet rows of convert.py and the mu-law functions
of ops/dsp.py) held against the JAX package on the CPU, with the same
weights through the bridge.

Tolerances: float32 forward, upsampler and incremental logits within 1e-5
(convolutions and products summed in another order); sampled audio within
1e-4 at every step before the first Gumbel-max near-tie (a top-2 score gap
below 1e-4, where the two frameworks may pick another mixture and the
trajectories part); chunked and monolithic sampling bit-identical; the
weight round trip bit-exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.models import wavenet as jwn
from neural_sound_generation_tpu.ops import dsp as jdsp
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.models import wavenet as wn
from neural_sound_generation_tpu_torch.ops import dsp

torch.set_num_threads(1)

# the JAX tests' TINY configuration (tests/test_wavenet.py:23)
TINY = dict(out_channels=12, layers=4, stacks=2, residual_channels=8, gate_channels=8,
            skip_out_channels=8, kernel_size=3, cin_channels=-1, gin_channels=-1)
COND = {**TINY, "cin_channels": 8, "gin_channels": 4, "n_speakers": 3,
        "upsample_scales": (4, 4)}
CATEGORICAL = {**TINY, "scalar_input": False, "out_channels": 32, "quantize_channels": 32}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _pair(cfg, x, c=None, g=None):
    jm = jwn.WaveNet(**cfg)
    v = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                    None if c is None else jnp.asarray(c),
                    None if g is None else jnp.asarray(g)))
    # non-zero biases, so that every bias's layout is exercised
    rng = np.random.default_rng(5)
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if p[-1].key == "bias" else a, v)
    tm = wn.WaveNet(**cfg)
    tm.load_state_dict(convert.flax_to_state_dict(v))
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def cond_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 1)).astype(np.float32)
    c = rng.standard_normal((2, 8, 8)).astype(np.float32)
    g = np.array([0, 2], np.int32)
    jm, v, tm = _pair(COND, x, c, g)
    return jm, v, tm, x, c, g


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def test_module_names_are_the_flax_tree(cond_pair):
    _, v, tm, *_ = cond_pair
    assert set(convert.flax_to_state_dict(v)) == set(tm.state_dict())
    assert "upsampler.ConvTranspose_1.weight" in tm.state_dict()


def test_forward_matches_jax(cond_pair):
    jm, v, tm, x, c, g = cond_pair
    want = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(c), jnp.asarray(g)))
    with torch.no_grad():
        got = tm(_t(x), _t(c), _t(g, torch.long)).numpy()
    assert got.shape == (2, 32, 12) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("scales", [(4, 4), (3, 2), (5,)])
def test_upsampler_matches_jax(scales):
    """SAME transpose convs of kernel 2s, stride s: odd s drops the extra
    sample ConvTranspose1d gives."""
    c = np.random.default_rng(1).standard_normal((2, 5, 6)).astype(np.float32)
    ju = jwn.ConditionUpsampler(scales=scales, channels=6)
    v = _np(ju.init(jax.random.PRNGKey(3), jnp.asarray(c)))
    tu = wn.ConditionUpsampler(scales, 6)
    tu.load_state_dict(convert.flax_to_state_dict(v))
    want = np.asarray(ju.apply(v, jnp.asarray(c)))
    with torch.no_grad():
        got = tu(_t(c)).numpy()
    assert got.shape == want.shape == (2, 5 * int(np.prod(scales)), 6)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_incremental_matches_jax_and_parallel(cond_pair):
    jm, v, tm, x, c, g = cond_pair
    want = np.asarray(jwn.incremental_forward(jm, v, jnp.asarray(x), jnp.asarray(c),
                                              jnp.asarray(g)))
    got = wn.incremental_forward(tm, _t(x), _t(c), _t(g, torch.long)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with torch.no_grad():
        parallel = tm(_t(x), _t(c), _t(g, torch.long)).numpy()
    np.testing.assert_allclose(got, parallel, atol=1e-5, rtol=0)


def test_categorical_variant_matches_jax():
    x = np.random.default_rng(2).integers(0, 32, (2, 24)).astype(np.int32)
    jm, v, tm = _pair(CATEGORICAL, x)
    assert "input_embed.weight" in tm.state_dict()
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_t(x, torch.long)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    inc = wn.incremental_forward(tm, _t(x, torch.long)).numpy()
    np.testing.assert_allclose(inc, want, atol=1e-5, rtol=0)
    gen = wn.make_generate_fn(tm, 16)
    out = gen(None, generator=torch.Generator().manual_seed(0), batch_size=2)
    assert out.shape == (2, 16) and out.dtype == torch.long
    assert int(out.min()) >= 0 and int(out.max()) < 32


def _agree_until_near_tie(tm, got, want, noise, c, g, tol=1e-4):
    """Steps agree within tol up to the first near-tie of the Gumbel-max
    choice on want's trajectory; returns that prefix length."""
    gum = noise[0].numpy()
    n_mix = tm.out_channels // 3
    x_in = wn.WaveNet.shift_inputs(_t(want)[..., None], True)
    logits = wn.incremental_forward(tm, x_in, c, g).numpy()[..., :n_mix]
    scores = np.sort(logits + gum.transpose(1, 0, 2), axis=-1)
    gap = scores[..., -1] - scores[..., -2]  # (B, T)
    for b in range(want.shape[0]):
        ties = np.nonzero(gap[b] < tol)[0]
        end = int(ties[0]) if len(ties) else want.shape[1]
        np.testing.assert_allclose(got[b, :end], want[b, :end], atol=tol, rtol=0)
        yield end


def test_generate_matches_jax_with_injected_noise(cond_pair):
    """The scan sampler with JAX's own noise (the same key's draw) gives
    JAX's samples, speaker and mel conditioned, batch 2."""
    jm, v, tm, x, c, g = cond_pair
    length, key = 32, jax.random.PRNGKey(7)
    want = np.asarray(jwn.make_generate_fn(jm, length, use_pallas=False, unroll=1)(
        v, jnp.asarray(c), jnp.asarray(g), key, batch_size=2))
    gum, unif = jwn._draw_noise(jm, key, length, 2)
    noise = (_t(gum), _t(unif))
    got = wn.make_generate_fn(tm, length)(_t(c), _t(g, torch.long), batch_size=2,
                                          noise=noise).numpy()
    assert got.shape == (2, length) and np.abs(got).max() <= 1.0
    prefixes = list(_agree_until_near_tie(tm, got, want, noise, _t(c), _t(g, torch.long)))
    assert min(prefixes) >= length // 2, prefixes


def test_generate_is_deterministic_per_generator(cond_pair):
    _, _, tm, _, c, g = cond_pair
    gen = wn.make_generate_fn(tm, 24, dtype=torch.bfloat16)

    def run(seed):
        return gen(_t(c), _t(g, torch.long), torch.Generator().manual_seed(seed), 2)

    a, b, other = run(1), run(1), run(2)
    assert a.shape == (2, 24) and a.dtype == torch.float32
    assert torch.isfinite(a).all() and a.abs().max() <= 1.0
    assert torch.equal(a, b) and not torch.equal(a, other)


def test_draw_noise_layout():
    tm = wn.WaveNet(**TINY)
    gum, unif = wn.draw_noise(tm, torch.Generator().manual_seed(0), 50, 3)
    assert gum.shape == (50, 3, 4) and unif.shape == (50, 3)
    assert float(unif.min()) >= 1e-5 and float(unif.max()) <= 1 - 1e-5
    assert torch.isfinite(gum).all()
    again = wn.draw_noise(tm, torch.Generator().manual_seed(0), 50, 3)
    assert torch.equal(gum, again[0]) and torch.equal(unif, again[1])


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_chunked_stream_equals_monolithic(dtype):
    """Bit-identical to the one-shot sampler with the same noise, including
    a trimmed final chunk (40 = 16 + 16 + 8)."""
    cfg = {**TINY, "cin_channels": 6, "upsample_scales": (2, 2)}
    tm = wn.WaveNet(**cfg, generator=torch.Generator().manual_seed(0)).eval()
    frames, length = 10, 40
    c = torch.from_numpy(np.random.default_rng(3).standard_normal((2, frames, 6))
                         .astype(np.float32))
    noise = wn.draw_noise(tm, torch.Generator().manual_seed(7), length, 2)
    want = wn.make_generate_fn(tm, length, dtype=dtype)(c, batch_size=2, noise=noise)
    _, _, stream = wn.make_chunked_generate_fn(tm, chunk=16, dtype=dtype)
    chunks = list(stream(c, batch_size=2, noise=noise))
    assert [blk.shape[1] for blk in chunks] == [16, 16, 8]
    assert torch.equal(torch.cat(chunks, dim=1), want)
    # the generator route draws the same noise
    chunks = list(stream(c, None, torch.Generator().manual_seed(7), 2))
    assert torch.equal(torch.cat(chunks, dim=1), want)


def test_stream_needs_conditioning():
    tm = wn.WaveNet(**TINY)
    _, _, stream = wn.make_chunked_generate_fn(tm, chunk=8)
    with pytest.raises(ValueError, match="conditioning"):
        next(stream(None, generator=torch.Generator()))


@pytest.mark.parametrize("cfg", [COND, CATEGORICAL], ids=["cond_speaker", "categorical"])
def test_convert_round_trip_is_bit_exact(cfg):
    x = (np.zeros((1, 8), np.int32) if not cfg.get("scalar_input", True)
         else np.zeros((1, 8, 1), np.float32))
    c = np.zeros((1, 2, 8), np.float32) if cfg.get("cin_channels", -1) > 0 else None
    g = np.zeros((1,), np.int32) if cfg.get("gin_channels", -1) > 0 else None
    jm, v, tm = _pair(cfg, x, c, g)
    back = convert.module_to_flax(tm)
    flat_a = dict(jax.tree_util.tree_leaves_with_path(v["params"]))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_a[k].shape == flat_b[k].shape, k
        np.testing.assert_array_equal(flat_a[k], flat_b[k])


@pytest.mark.parametrize("mu", [256, 65536])
def test_mulaw_matches_jax(mu):
    x = np.linspace(-1, 1, 101).astype(np.float32)
    np.testing.assert_allclose(dsp.mulaw(_t(x), mu).numpy(),
                               np.asarray(jdsp.mulaw(jnp.asarray(x), mu)), atol=1e-6)
    np.testing.assert_allclose(dsp.inv_mulaw(_t(x), mu).numpy(),
                               np.asarray(jdsp.inv_mulaw(jnp.asarray(x), mu)), atol=1e-6)
    q = dsp.mulaw_quantize(_t(x), mu).numpy()
    np.testing.assert_array_equal(q, np.asarray(jdsp.mulaw_quantize(jnp.asarray(x), mu)))
    np.testing.assert_allclose(dsp.inv_mulaw_quantize(_t(q), mu).numpy(),
                               np.asarray(jdsp.inv_mulaw_quantize(jnp.asarray(q), mu)),
                               atol=1e-6)

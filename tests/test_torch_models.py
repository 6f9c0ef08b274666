"""The port's layers and VQ-VAE held against the JAX package on the CPU,
with the JAX weights carried over by the bridge (convert.py).

Everything runs in eval mode, the serving mode, with BatchNorm running
statistics perturbed away from their (0, 1) init so that the statistics
take part. Tolerance 1e-4 absolute: float32 convolutions summed in another
order differ by about 1e-6 per layer at these widths.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

import flax.linen as fnn
import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu.models import layers as jlayers
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.models import layers

torch.set_num_threads(1)

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_stats(variables, seed):
    """Running means drawn from [-0.5, 0.5), variances from [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        low = 0.5 if path[-1].key == "var" else -0.5
        return rng.uniform(low, low + 1.0, a.shape).astype(np.float32)

    out = dict(variables)
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, out["batch_stats"])
    return out


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


class _Holder(nn.Module):
    """A parent that names one child as flax auto-names it."""

    def __init__(self, name, child):
        super().__init__()
        self.add_module(name, child)


@pytest.mark.parametrize("which,ci,co,hw", [
    ("down", 1, 16, (80, 16)),
    ("down", 16, 16, (7, 9)),   # odd sizes
    ("up", 16, 16, (20, 4)),
    ("up", 16, 1, (5, 3)),
])
def test_stride_convs_match_flax(which, ci, co, hw):
    """conv_up maps flax's SAME ConvTranspose (no kernel flip) onto
    ConvTranspose2d(4, 2, 1) with a flipped, in/out-swapped kernel; shown
    here numerically, with a nonzero bias."""
    rng = np.random.default_rng(ci + co)
    x = rng.standard_normal((2, *hw, ci)).astype(np.float32)
    if which == "down":
        fmod, name, tmod = jlayers.conv_down(co), "Conv_0", layers.conv_down(ci, co)
    else:
        fmod, name, tmod = jlayers.conv_up(co), "ConvTranspose_0", layers.conv_up(ci, co)
    v = _np_tree(fmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["bias"] = rng.standard_normal(co).astype(np.float32)
    want = np.asarray(fmod.apply(v, jnp.asarray(x)))
    holder = _Holder(name, tmod)
    holder.load_state_dict(convert.flax_to_state_dict({"params": {name: v["params"]}}))
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_resblock_and_norms_match_flax(norm):
    dim = 16
    x = np.random.default_rng(1).standard_normal((2, 6, 5, dim)).astype(np.float32)
    fmod = jlayers.ResBlock(dim, norm=norm)
    v = _perturb_stats(_np_tree(fmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)), 2)
    rng = np.random.default_rng(3)
    v["params"] = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), v["params"])
    want = np.asarray(fmod.apply(v, jnp.asarray(x), train=False))
    tmod = layers.ResBlock(dim, norm)
    holder = _Holder("ResBlock_0", tmod)
    tree = {"params": {"ResBlock_0": v["params"]}}
    if "batch_stats" in v:
        tree["batch_stats"] = {"ResBlock_0": v["batch_stats"]}
    holder.load_state_dict(convert.flax_to_state_dict(tree))
    holder.eval()
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(x))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_norm_constants_match_flax():
    bn, gn = layers.make_norm("batch", 16), layers.make_norm("group", 16)
    assert bn.eps == fnn.BatchNorm().epsilon
    assert bn.momentum == pytest.approx(1 - fnn.BatchNorm().momentum)
    assert gn.eps == fnn.GroupNorm().epsilon and gn.num_groups == 2
    with pytest.raises(ValueError):
        layers.make_norm("layer", 16)
    with pytest.raises(ValueError):
        layers.make_norm("group", 12)


def _pair(norm="batch", n_speakers=0, gin=-1, dim=32, z_dim=64, seed=0):
    """A JAX VQ-VAE with perturbed statistics and a codebook on the scale of
    the encoder's output (so codes vary), and the port's copy of it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 80, 16, 1)).astype(np.float32)
    kw = {"g": jnp.zeros((1,), jnp.int32)} if n_speakers else {}
    jm = JaxVQVAE(input_dim=1, dim=dim, z_dim=z_dim, n_speakers=n_speakers,
                  gin_channels=gin, norm=norm)
    v = _perturb_stats(_np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]),
                                        train=False, **kw)), seed + 1)
    ze = np.asarray(jm.apply(v, jnp.asarray(x), train=False)[1])
    pick = rng.choice(ze.reshape(-1, dim).shape[0], z_dim, replace=False)
    v["params"]["codebook"] = ze.reshape(-1, dim)[pick] + 0.01 * rng.standard_normal(
        (z_dim, dim)).astype(np.float32)
    tm = VQVAE(1, dim, z_dim, n_speakers, gin, norm=norm)
    tm.load_state_dict(convert.flax_to_state_dict(v))
    tm.eval()
    return jm, v, tm, x


@pytest.mark.parametrize("norm,n_speakers,gin", [
    ("batch", 0, -1),
    ("batch", 3, 8),   # speaker conditioning (multispeaker presets)
    ("group", 0, -1),
])
def test_vqvae_matches_jax(norm, n_speakers, gin):
    jm, v, tm, x = _pair(norm, n_speakers, gin)
    g = np.array([2, 0], np.int32) if n_speakers else None
    jg = jnp.asarray(g) if n_speakers else None
    tg = torch.from_numpy(g) if n_speakers else None
    xt, ze, zq = jm.apply(v, jnp.asarray(x), train=False, g=jg)
    codes = np.array(jm.apply(v, jnp.asarray(x), train=False, method=JaxVQVAE.encode))
    dec = jm.apply(v, jnp.asarray(codes), g=jg, train=False, method=JaxVQVAE.decode)
    with torch.no_grad():
        txt, tze, tzq = tm(torch.from_numpy(x), tg)
        tcodes = tm.encode(torch.from_numpy(x))
        tdec = tm.decode(torch.from_numpy(codes), tg)
    assert len(np.unique(codes)) > 8  # the codebook is exercised
    np.testing.assert_array_equal(tcodes.numpy(), codes)
    np.testing.assert_allclose(tze.numpy(), np.asarray(ze), atol=ATOL)
    np.testing.assert_allclose(tzq.numpy(), np.asarray(zq), atol=ATOL)
    np.testing.assert_allclose(txt.numpy(), np.asarray(xt), atol=ATOL)
    np.testing.assert_allclose(tdec.numpy(), np.asarray(dec), atol=ATOL)
    assert 0.05 < float(np.std(np.asarray(xt))) and float(np.abs(np.asarray(xt)).max()) < 0.999


def test_vqvae_matches_golden():
    """tests/golden/models_golden.npz holds the JAX VQ-VAE's outputs at
    dim 8, 16 codes, init PRNGKey(7): the same init through the bridge
    reproduces them."""
    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "models_golden.npz"))
    jm = JaxVQVAE(input_dim=1, dim=8, z_dim=16)
    v = _np_tree(jm.init(jax.random.PRNGKey(7), jnp.asarray(g["vqvae_in"]), train=False))
    tm = VQVAE(1, 8, 16)
    tm.load_state_dict(convert.flax_to_state_dict(v))
    tm.eval()
    with torch.no_grad():
        xt, ze, zq = tm(torch.from_numpy(g["vqvae_in"]))
    np.testing.assert_allclose(xt.numpy(), g["vqvae_xt"], atol=ATOL)
    np.testing.assert_allclose(ze.numpy(), g["vqvae_ze"], atol=ATOL)
    np.testing.assert_allclose(zq.numpy(), g["vqvae_zq"], atol=ATOL)


def test_vqvae_init_is_seeded_and_follows_the_jax_distributions():
    a = VQVAE(1, 16, 32, n_speakers=2, gin_channels=4,
              generator=torch.Generator().manual_seed(0))
    b = VQVAE(1, 16, 32, n_speakers=2, gin_channels=4,
              generator=torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert float(a.codebook.detach().abs().max()) <= 1 / 32
    w = a.encoder.Conv_1.weight.detach()
    bound = (6 / (16 * 16 + 16 * 16)) ** 0.5  # xavier, fan_in + fan_out
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert float(a.encoder.Conv_1.bias.detach().abs().max()) == 0.0


def test_vqvae_gradients_reach_codebook_and_encoder():
    _, _, tm, x = _pair()
    tm.train()
    xt, ze, zq = tm(torch.from_numpy(x))
    loss = ((xt - torch.from_numpy(x)) ** 2).mean() + ((ze.detach() - zq) ** 2).mean()
    loss.backward()
    assert tm.codebook.grad.abs().sum() > 0
    assert tm.encoder.Conv_0.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("shape", [(4, 9, 7, 16), (2, 3, 5, 16)])
def test_train_mode_batchnorm_matches_flax_over_three_steps(shape):
    """Train mode normalizes with the biased batch variance and keeps
    0.99 * old + 0.01 * batch running averages of that biased variance (the
    unbiased one would differ by n/(n-1)); three steps from perturbed
    statistics, each output and the statistics after each step. Tolerance
    1e-5: the two sides take the variance by different formulas (flax
    E[x^2] - E[x]^2, the port a two-pass reduction)."""
    rng = np.random.default_rng(5)
    xs = rng.standard_normal((3, *shape)).astype(np.float32) * 2.0 + 0.5
    fmod = fnn.BatchNorm(use_running_average=False)
    v = _perturb_stats(_np_tree(fmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))), 6)
    v["params"] = {"scale": rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32),
                   "bias": rng.standard_normal(shape[-1]).astype(np.float32)}
    tmod = layers.make_norm("batch", shape[-1])
    holder = _Holder("BatchNorm_0", tmod)
    holder.load_state_dict(convert.flax_to_state_dict(
        {"params": {"BatchNorm_0": v["params"]}, "batch_stats": {"BatchNorm_0": v["batch_stats"]}}))
    tmod.train()
    for x in xs:
        want, mut = fmod.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": _np_tree(mut["batch_stats"])}
        with torch.no_grad():
            got = _nhwc(tmod(_nchw(x))).numpy()
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(tmod.running_mean.numpy(), v["batch_stats"]["mean"], atol=1e-5)
        np.testing.assert_allclose(tmod.running_var.numpy(), v["batch_stats"]["var"], atol=1e-5)


def test_discarded_train_pass_leaves_the_statistics():
    _, _, tm, x = _pair()
    before = {k: b.clone() for k, b in tm.named_buffers()}
    tm.train()
    with torch.no_grad(), layers.batch_stats_discarded(tm):
        tm(torch.from_numpy(x))
        moved = any(not torch.equal(b, before[k]) for k, b in tm.named_buffers())
    assert moved  # the pass did update them inside
    for k, b in tm.named_buffers():
        assert torch.equal(b, before[k]), k


def _stagewise_codebook(ze, num_quantizers, z_dim, rng):
    """A (Q, K, D) stack seeded stage by stage from what the stages before
    leave of ``ze`` (N, D), so every stage's codes vary."""
    books, residual = [], ze.copy()
    for _ in range(num_quantizers):
        pick = rng.choice(residual.shape[0], z_dim, replace=False)
        book = (residual[pick] + 0.01 * rng.standard_normal(
            (z_dim, ze.shape[1]))).astype(np.float32)
        books.append(book)
        residual = residual - book[((residual[:, None] - book[None]) ** 2).sum(-1).argmin(1)]
    return np.stack(books)


def _rvq_pair(num_quantizers, bf16=False, dim=32, z_dim=64, seed=0):
    """A JAX residual-VQ (or bf16) VQ-VAE with perturbed statistics and a
    codebook seeded from its own encoder outputs, and the port's copy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 80, 16, 1)).astype(np.float32)
    jm = JaxVQVAE(input_dim=1, dim=dim, z_dim=z_dim, num_quantizers=num_quantizers,
                  dtype=jnp.bfloat16 if bf16 else jnp.float32)
    v = _perturb_stats(_np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]),
                                        train=False)), seed + 1)
    ze = np.asarray(jm.apply(v, jnp.asarray(x), train=False)[1]).reshape(-1, dim)
    cb = _stagewise_codebook(ze, num_quantizers, z_dim, rng)
    v["params"]["codebook"] = cb if num_quantizers > 1 else cb[0]
    tm = VQVAE(1, dim, z_dim, num_quantizers=num_quantizers,
               dtype=torch.bfloat16 if bf16 else torch.float32)
    tm.load_state_dict(convert.flax_to_state_dict(v))
    tm.eval()
    return jm, v, tm, x


@pytest.mark.parametrize("num_quantizers", [2, 3])
def test_rvq_vqvae_matches_jax(num_quantizers):
    """Residual VQ: a (Q, K, D) codebook, codes (Q, B, H', W'), the decoder
    summing the stage lookups; 1e-5 (f32 sums in another order)."""
    jm, v, tm, x = _rvq_pair(num_quantizers)
    assert tuple(tm.codebook.shape) == (num_quantizers, 64, 32)
    xt, ze, zq = jm.apply(v, jnp.asarray(x), train=False)
    codes = np.array(jm.apply(v, jnp.asarray(x), train=False, method=JaxVQVAE.encode))
    dec = jm.apply(v, jnp.asarray(codes), train=False, method=JaxVQVAE.decode)
    with torch.no_grad():
        txt, tze, tzq = tm(torch.from_numpy(x))
        tcodes = tm.encode(torch.from_numpy(x))
        tdec = tm.decode(torch.from_numpy(codes))
    assert codes.shape == (num_quantizers, 2, 20, 4) and tcodes.dtype == torch.int32
    for q in range(num_quantizers):
        assert len(np.unique(codes[q])) > 8, q  # every stage is exercised
    np.testing.assert_array_equal(tcodes.numpy(), codes)
    for got, want in ((tze, ze), (tzq, zq), (txt, xt), (tdec, dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # the port's own init: a (Q, K, D) stack in U(-1/K, 1/K)
    fresh = VQVAE(1, 16, 32, num_quantizers=num_quantizers,
                  generator=torch.Generator().manual_seed(0))
    assert tuple(fresh.codebook.shape) == (num_quantizers, 32, 16)
    assert float(fresh.codebook.detach().abs().max()) <= 1 / 32
    with pytest.raises(ValueError):
        VQVAE(1, 16, 32, num_quantizers=0)


@pytest.mark.parametrize("num_quantizers", [1, 2])
def test_bf16_vqvae_matches_jax_bf16(num_quantizers):
    """bf16 compute (flax's per-module dtype) in eval mode: float32
    parameters, convs in bf16 with the bias added after rounding, norms in
    float32 rounded once, the encoder output to float32 before the VQ, tanh
    in float32. Both sides round at the same points; where a float32 sum in
    another order flips a bf16 rounding, the flip travels: within 2e-2 of
    the largest |x_tilde|, >= 99% of the codes equal."""
    jm, v, tm, x = _rvq_pair(num_quantizers, bf16=True)
    xt, _, _ = jm.apply(v, jnp.asarray(x), train=False)
    codes = np.array(jm.apply(v, jnp.asarray(x), train=False, method=JaxVQVAE.encode))
    with torch.no_grad():
        txt, tze, _ = tm(torch.from_numpy(x))
        tcodes = tm.encode(torch.from_numpy(x))
    assert txt.dtype == torch.float32 and tze.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    scale = float(np.abs(np.asarray(xt)).max())
    assert float(np.abs(txt.numpy() - np.asarray(xt)).max()) <= 2e-2 * scale
    assert float((tcodes.numpy() == codes).mean()) >= 0.99
    assert len(np.unique(codes)) > 8


@pytest.mark.parametrize("shape", [(4, 9, 7, 16), (2, 3, 5, 16)])
def test_bf16_train_mode_batchnorm_matches_flax(shape):
    """flax's BatchNorm(dtype=bfloat16) on a bf16 input: batch statistics and
    the normalization in float32, one rounding to bf16, float32 running
    averages of the biased variance. The two sides take the variance by
    different formulas (flax E[x^2] - E[x]^2, the port two passes), a few
    float32 ulps apart, which flips a bf16 rounding now and then: outputs
    within 1 bf16 ulp, >= 99% bit-equal; statistics within 1e-5."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    fmod = fnn.BatchNorm(use_running_average=False, dtype=jnp.bfloat16)
    v = _perturb_stats(_np_tree(fmod.init(jax.random.PRNGKey(0), xb)), 9)
    v["params"] = {"scale": rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32),
                   "bias": rng.standard_normal(shape[-1]).astype(np.float32)}
    want, mut = fmod.apply(v, xb, mutable=["batch_stats"])
    tmod = layers.make_norm("batch", shape[-1], torch.bfloat16)
    holder = _Holder("BatchNorm_0", tmod)
    holder.load_state_dict(convert.flax_to_state_dict(
        {"params": {"BatchNorm_0": v["params"]}, "batch_stats": {"BatchNorm_0": v["batch_stats"]}}))
    tmod.train()
    with torch.no_grad():
        got = _nhwc(tmod(_nchw(np.asarray(xb, np.float32)).bfloat16()))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    from neural_sound_generation_tpu_torch.ops.cuda.conv3x3 import bf16_ulp_error
    ulps = bf16_ulp_error(got, torch.from_numpy(np.asarray(want, np.float32)))
    assert float(ulps.max()) <= 1 and float((ulps == 0).float().mean()) >= 0.99
    stats = _np_tree(mut["batch_stats"])
    assert tmod.running_mean.dtype == torch.float32
    np.testing.assert_allclose(tmod.running_mean.numpy(), stats["mean"], atol=1e-5)
    np.testing.assert_allclose(tmod.running_var.numpy(), stats["var"], atol=1e-5)


def test_bf16_layers_round_where_flax_does():
    """A bf16 conv's output is bf16 (the bias added in bf16 after the
    convolution is rounded); a bf16 norm normalizes the float32 view of its
    input and rounds once; a ResBlock's skip keeps a float32 input's dtype."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 16, 5, 6)).astype(np.float32))
    conv = layers.Conv2d(16, 16, 3, padding=1, dtype=torch.bfloat16)
    nn.init.normal_(conv.bias)
    with torch.no_grad():
        y = conv(x)
        raw = torch.nn.functional.conv2d(x.bfloat16(), conv.weight.bfloat16(), None, padding=1)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, raw + conv.bias.bfloat16()[:, None, None])
        for norm in ("batch", "group"):
            f32, bf = layers.make_norm(norm, 16), layers.make_norm(norm, 16, torch.bfloat16)
            for m in (f32, bf):
                m.train()
            out = bf(y)
            assert out.dtype == torch.bfloat16
            assert torch.equal(out, f32(y.float()).bfloat16()), norm
        block = layers.ResBlock(16, dtype=torch.bfloat16)
        block.eval()
        assert block(x).dtype == torch.float32
        assert block(x.bfloat16()).dtype == torch.bfloat16

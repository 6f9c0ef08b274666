"""The port's attention backend switch and its two plain PyTorch paths
(``ops/attention.py``: ``set_backend``, ``stock_causal_attention``,
``chunked_causal_attention``) held against the JAX package's
``set_backend``, ``_xla_causal_attention`` and ``chunked_causal_attention``
on the CPU: seeded (2, 2, T, 16) inputs at the JAX test's (T, block) pairs
(``tests/test_flash_attention.py:144``), values and the gradients of a
seeded linear functional, in float32 and in bf16.

Tolerances, with their reasons:
  * float32: JAX's own, values 2e-5 absolute and 1e-5 relative, gradients
    3e-5 absolute and 1e-4 relative (the same online softmax summed in
    another order);
  * bf16, the same function (the port's chunked path against JAX's, the
    stock path against ``_xla_causal_attention``): values within one bf16
    ulp of the largest magnitude and at least 99% of elements within one
    bf16 ulp of JAX's (the same rounding points; a float32 sum in another
    order flips a rounding now and then; measured 100%); gradients within
    BF16_REL = 2e-2 of the largest magnitude (autograd rounds the
    backward's bf16 intermediates where XLA's fused backward keeps float32;
    measured <= 6.2e-3, 96-100% within one ulp);
  * bf16, the chunked path against JAX's stock one: values and gradients
    within BF16_REL of the largest (the chunked path rounds each block's
    unnormalised P to bf16, the stock path the normalised P; measured
    <= 7.1e-3).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu_torch.models import TransformerPrior
from neural_sound_generation_tpu_torch.ops import attention
from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa

jfa = importlib.import_module("neural_sound_generation_tpu.ops.pallas.attention")

torch.set_num_threads(1)

SHAPES = [(37, 16), (64, 32), (300, 128)]
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
B, HEADS, D = 2, 2, 16
BF16_ULP_SHARE, BF16_REL = 0.99, 2e-2


def _inputs(seed, t, dtype):
    """q, k, v and the cotangent, numpy float32 rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((B, HEADS, t, D)).astype(np.float32) for _ in range(4)]
    jdt = DTYPES[dtype][1]
    return [np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32)) for x in out]


def _jax(fn, arrays, dtype):
    """fn's output and the gradients of sum(fn(q, k, v) * co), float32."""
    jdt = DTYPES[dtype][1]
    q, k, v, co = (jnp.asarray(x).astype(jdt) for x in arrays)
    out, vjp = jax.vjp(fn, q, k, v)
    grads = vjp(co.astype(out.dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _port(fn, arrays, dtype):
    tdt = DTYPES[dtype][0]
    q, k, v, co = (torch.from_numpy(x).to(tdt) for x in arrays)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    assert out.dtype == tdt and out.shape == q.shape
    grads = torch.autograd.grad(out, leaves, co)
    return [x.detach().float().numpy() for x in (out, *grads)]


def ulp_share(got, want) -> float:
    mag = np.maximum(np.abs(want), np.float32(2.0**-126))
    return float((np.abs(got - want) <= 2.0 ** (np.floor(np.log2(mag)) - 7)).mean())


def _assert_match(got, want, dtype, what, same_rounding=True):
    names = ("out", "dq", "dk", "dv")
    for name, g, w in zip(names, got, want):
        if dtype == "f32":
            atol, rtol = (2e-5, 1e-5) if name == "out" else (3e-5, 1e-4)
            np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=f"{what} {name}")
        elif name == "out" and same_rounding:
            np.testing.assert_allclose(g, w, atol=2.0**-8 * np.abs(w).max(), rtol=0,
                                       err_msg=f"{what} {name}")
            assert ulp_share(g, w) >= BF16_ULP_SHARE, (what, ulp_share(g, w))
        else:
            np.testing.assert_allclose(g, w, atol=BF16_REL * np.abs(w).max(), rtol=0,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,block", SHAPES)
def test_chunked_matches_jax(t, block, dtype):
    """Against JAX's chunked function and its stock XLA path, values and
    gradients, a T that no block divides among them (padding masked)."""
    arrays = _inputs(t, t, dtype)
    scale = 1.0 / np.sqrt(D)
    got = _port(lambda q, k, v: attention.chunked_causal_attention(q, k, v, scale, block),
                arrays, dtype)
    _assert_match(got, _jax(lambda q, k, v: jfa.chunked_causal_attention(
        q, k, v, scale, block=block), arrays, dtype), dtype, "vs JAX chunked")
    _assert_match(got, _jax(lambda q, k, v: jfa._xla_causal_attention(q, k, v, scale),
                            arrays, dtype), dtype, "vs JAX stock", same_rounding=False)


@pytest.mark.parametrize("dtype", DTYPES)
def test_stock_path_matches_jax_xla(dtype):
    """The stock masked softmax against ``_xla_causal_attention``."""
    arrays = _inputs(5, 50, dtype)
    got = _port(lambda q, k, v: attention.stock_causal_attention(q, k, v, 0.3), arrays, dtype)
    _assert_match(got, _jax(lambda q, k, v: jfa._xla_causal_attention(q, k, v, 0.3),
                            arrays, dtype), dtype, "stock")


def test_chunked_stores_no_t_by_t_tensor():
    """Each q-block runs under ``torch.utils.checkpoint``: what autograd
    keeps for the backward is a few (B, H, T, D) tensors, never the (T, T)
    logits or probabilities, nor their blocks (which, kept, would sum to
    (T, T))."""
    t, block = 300, 128
    q, k, v = (torch.randn(B, HEADS, t, D, requires_grad=True) for _ in range(3))
    saved = {}

    def pack(x):
        saved[(x.data_ptr(), x.numel())] = x.numel()
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = attention.chunked_causal_attention(q, k, v, 0.25, block)
    assert sum(saved.values()) < B * HEADS * t * t // 4, sorted(saved.values())
    out.sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        attention.stock_causal_attention(q, k, v, 0.25)
    assert max(saved.values()) >= B * HEADS * t * t  # the stock path keeps P


def test_set_backend_dispatch_and_guard():
    """``auto`` (and ``flash``) run the kernels' wrapper, whose CPU path is
    the plain pair (no launch); ``xla`` the stock path and ``chunked`` the
    chunked one, each bit for bit; the guard refuses an unknown name and
    leaves the setting as it was. JAX's switch refuses it too."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, 50, 8)).astype(np.float32))
               for _ in range(3))
    scale = 8**-0.5
    fa.reset_launch_count()
    plain = fa.flash_causal_attention(*(x.reshape(2, 50, 8) for x in (q, k, v)), scale)
    want = {"auto": plain.reshape(1, 2, 50, 8), "flash": plain.reshape(1, 2, 50, 8),
            "xla": attention.stock_causal_attention(q, k, v, scale),
            "chunked": attention.chunked_causal_attention(q, k, v, scale)}
    try:
        for name in attention.BACKENDS:
            attention.set_backend(name)
            assert torch.equal(attention.causal_attention(q, k, v), want[name]), name
        with pytest.raises(ValueError, match="unknown attention backend"):
            attention.set_backend("nope")
        assert torch.equal(attention.causal_attention(q, k, v), want["chunked"])
    finally:
        attention.set_backend("auto")
    assert fa.launch_counts() == fa.bf16_launch_counts() == dict.fromkeys(fa.KERNELS, 0)
    np.testing.assert_allclose(want["chunked"].numpy(), want["xla"].numpy(), atol=2e-5)
    with pytest.raises(AssertionError):
        jfa.set_backend("nope")


@pytest.mark.parametrize("name", ["xla", "chunked"])
def test_transformer_prior_runs_through_the_switch(name):
    """A transformer prior's logits and gradients through each plain path
    agree with the default path's (float32)."""
    model = TransformerPrior(16, 32, 2, 2, 3, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 16, (2, 4, 5)).astype(np.int32))
    labels = torch.tensor([0, 2], dtype=torch.int32)

    def run():
        model.zero_grad()
        logits = model(codes, labels)
        logits.square().mean().backward()
        return logits.detach(), [p.grad.clone() for p in model.parameters()]

    ref, ref_grads = run()
    attention.set_backend(name)
    try:
        got, grads = run()
    finally:
        attention.set_backend("auto")
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5)
    for g, w in zip(grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=3e-5 * max(1.0, float(w.abs().max())))

"""The port's causal attention (ops/cuda/flash_attention.py, ops/attention.py)
held against the JAX package on the CPU: the plain forward against
``_xla_causal_attention`` and against ``flash_causal_attention`` run in the
Pallas interpreter, the plain dq, dk and dv against ``jax.vjp`` of the
interpreted kernel, bf16 inputs against the float32 oracle.

Tolerances, with their reasons:
  * float32 outputs and gradients 2e-6 of the largest magnitude, absolute:
    the same float32 math summed in another order (about 1e-7 relative per
    product, over sums of up to 40 terms);
  * bf16 outputs 3e-2 absolute against the float32 oracle (the JAX test's
    own bound: P is rounded to bf16 before P V), and 1e-2 against the
    interpreted bf16 kernel (the same roundings, sums in another order flip
    a few bf16 roundings of O).
The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them against the plain pair at the main path's shapes.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu_torch.ops import attention
from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa

jfa = importlib.import_module("neural_sound_generation_tpu.ops.pallas.attention")

torch.set_num_threads(1)

F32_FRAC = 2e-6


def _qkv(seed, bh=3, t=37, d=8, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, t, d)).astype(np.float32) for _ in range(n)]


def _close(got, want, frac=F32_FRAC, err_msg=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=frac * np.abs(want).max(), rtol=0, err_msg=err_msg)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x)).to(dtype)


def _jax_interpret(q, k, v, scale, bq):
    return jfa.flash_causal_attention(q, k, v, scale, bq, True)


@pytest.mark.parametrize("t,bq", [(37, 16), (20, 32), (5, 16), (1, 16)])
def test_plain_forward_matches_both_jax_oracles(t, bq):
    q, k, v = _qkv(t, t=t)
    scale = 0.3
    o, lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), scale)
    want_xla = jfa._xla_causal_attention(*(jnp.asarray(x)[None] for x in (q, k, v)), scale)[0]
    want_pallas = _jax_interpret(*map(jnp.asarray, (q, k, v)), scale, bq)
    _close(o.numpy(), want_xla)
    _close(o.numpy(), want_pallas)
    # the saved LSE is the row's log-sum-exp over its visible keys
    s = np.einsum("bqd,bkd->bqk", q, k) * scale
    s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5)


@pytest.mark.parametrize("t,bq", [(37, 16), (24, 32)])
def test_plain_backward_matches_vjp_of_the_interpreted_kernel(t, bq):
    q, k, v, do = _qkv(100 + t, t=t, n=4)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o_j, vjp = jax.vjp(lambda a, b, c: _jax_interpret(a, b, c, scale, bq),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    o, _ = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), scale)
    got = fa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), o, _t(do), scale)
    _close(o.numpy(), o_j)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, err_msg=name)


def test_autograd_function_runs_the_plain_pair_on_the_cpu():
    q, k, v, do = _qkv(7, t=30, n=4)
    scale = 0.25
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    fa.reset_launch_count()
    o = fa.flash_causal_attention(*leaves, scale)
    o.backward(_t(do))
    want_o, _ = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), scale)
    want = fa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), want_o, _t(do), scale)
    assert torch.equal(o.detach(), want_o)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)


def test_bf16_inputs_against_the_float32_oracle():
    q, k, v = _qkv(3, t=33, d=16)
    scale = 0.25
    bf = [_t(x, torch.bfloat16) for x in (q, k, v)]
    o, lse = fa.flash_attention_fwd_plain(*bf, scale)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    exact = [x.float().numpy() for x in bf]  # the bf16 inputs, exactly
    want = jfa._xla_causal_attention(*(jnp.asarray(x)[None] for x in exact), scale)[0]
    np.testing.assert_allclose(o.float().numpy(), np.asarray(want), atol=3e-2)
    got_pallas = _jax_interpret(*(jnp.asarray(x, jnp.bfloat16) for x in exact), scale, 16)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(got_pallas, np.float32), atol=1e-2)
    do = _t(_qkv(4, t=33, d=16, n=1)[0], torch.bfloat16)
    grads = fa.flash_attention_bwd_plain(*bf, o, do, scale)
    ref = fa.flash_attention_bwd_plain(*(x.float() for x in bf), o.float(), do.float(), scale)
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), r.numpy(),
                                   atol=3e-2 * float(r.abs().max()))


def test_causality():
    """Output row i and the gradients of keys and values past i depend on
    nothing after position i."""
    q, k, v = _qkv(5, t=24)
    base, _ = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), 0.5)
    k2, v2 = k.copy(), v.copy()
    k2[:, 10:] += 5.0
    v2[:, 10:] -= 3.0
    moved, _ = fa.flash_attention_fwd_plain(_t(q), _t(k2), _t(v2), 0.5)
    assert torch.equal(moved[:, :10], base[:, :10])
    assert not torch.equal(moved[:, 10:], base[:, 10:])
    do = np.zeros_like(q)
    do[:, :10] = 1.0  # a loss on the first 10 rows only
    _, dk, dv = fa.flash_attention_bwd_plain(_t(q), _t(k), _t(v), base, _t(do), 0.5)
    assert float(dk[:, 10:].abs().max()) == 0.0 and float(dv[:, 10:].abs().max()) == 0.0


@pytest.mark.parametrize("t,d", [(21, 16), (1, 8)])
def test_dispatcher_matches_jax_and_leaves_the_counters_at_zero(t, d):
    rng = np.random.default_rng(9 + t)
    q, k, v, do = (rng.standard_normal((2, 2, t, d)).astype(np.float32) for _ in range(4))
    scale = 0.25
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    fa.reset_launch_count()
    o = attention.causal_attention(*leaves, scale)
    o.backward(_t(do))
    want_o, vjp = jax.vjp(lambda a, b, c: jfa._xla_causal_attention(a, b, c, scale),
                          *map(jnp.asarray, (q, k, v)))
    _close(o.detach().numpy(), want_o)
    for leaf, w in zip(leaves, vjp(jnp.asarray(do))):
        _close(leaf.grad.numpy(), w)
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)


def test_default_scale_is_one_over_sqrt_d():
    q, k, v = (_t(x)[None] for x in _qkv(11, bh=2, t=9, d=16))
    torch.testing.assert_close(attention.causal_attention(q, k, v),
                               attention.causal_attention(q, k, v, 0.25), rtol=0, atol=0)


@pytest.mark.parametrize("make,match", [
    (lambda: [torch.zeros(2, 5, 129)] * 3, "D <= 128"),
    (lambda: [torch.zeros(2, 0, 8)] * 3, "T >= 1"),
    (lambda: [torch.zeros(2, 5, 8), torch.zeros(2, 5, 8, dtype=torch.bfloat16),
              torch.zeros(2, 5, 8)], "dtypes differ"),
    (lambda: [torch.zeros(2, 5, 8, dtype=torch.float64)] * 3, "float32 or bfloat16"),
    (lambda: [torch.zeros(2, 8, 5).transpose(1, 2)] * 3, "contiguous"),
    (lambda: [torch.zeros(2, 5, 8), torch.zeros(2, 6, 8), torch.zeros(2, 5, 8)], "shapes differ"),
])
def test_unsupported_inputs_raise(make, match):
    with pytest.raises(ValueError, match=match):
        fa.flash_causal_attention(*make(), 0.5)


def test_kernels_refuse_cpu_tensors():
    q = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.launch_fwd(q, q, q, 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.launch_bwd(q, q, q, q, q, torch.zeros(1, 4), 0.5)


def _as_inputs(arrays, bf16):
    """(torch tensors, jax arrays) of the same values: bf16-rounded when bf16."""
    if not bf16:
        return [_t(x) for x in arrays], [jnp.asarray(x) for x in arrays]
    j = [jnp.asarray(x, jnp.bfloat16) for x in arrays]
    return [_t(np.array(x.astype(jnp.float32)), torch.bfloat16) for x in j], j


# the ends of the kernels' contract that chip_smoke.ATTN_SHAPES holds them
# at: one row (T = 1; dQ and dK are zero up to rounding, so the float32
# limit is taken of max(|want|, 1)), and bf16 rows of 40 bytes (D = 20),
# which TMA cannot stage. bf16 tolerances: 3e-2 absolute against the float32
# oracle, 1e-2 of the largest magnitude against the interpreted bf16 kernel
# (the same roundings of P and dS; sums in another order flip a few bf16
# roundings).
@pytest.mark.parametrize("t,d,bf16,bq", [(1, 64, False, 16), (300, 20, True, 64)])
def test_plain_pair_at_the_contract_edges_matches_jax(t, d, bf16, bq):
    arrays = _qkv(200 + t, bh=2, t=t, d=d, n=4)
    (q, k, v, do), (jq, jk, jv, jdo) = _as_inputs(arrays, bf16)
    scale = d**-0.5
    o, lse = fa.flash_attention_fwd_plain(q, k, v, scale)
    grads = fa.flash_attention_bwd_plain(q, k, v, o, do, scale)
    exact = [np.asarray(x.float()) for x in (q, k, v)]
    want_xla = jfa._xla_causal_attention(*(jnp.asarray(x)[None] for x in exact), scale)[0]
    want_o, vjp = jax.vjp(lambda a, b, c: _jax_interpret(a, b, c, scale, bq), jq, jk, jv)
    want_grads = vjp(jdo)
    assert o.dtype == q.dtype and lse.dtype == torch.float32 and lse.shape == (2, t)
    got_o = o.float().numpy()
    if bf16:
        np.testing.assert_allclose(got_o, np.asarray(want_xla), atol=3e-2, rtol=0)
        _close(got_o, want_o.astype(jnp.float32), frac=1e-2)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
            assert g.dtype == torch.bfloat16
            _close(g.float().numpy(), w.astype(jnp.float32), frac=1e-2, err_msg=name)
    else:
        _close(got_o, want_xla)
        _close(got_o, want_o)
        for name, g, w in zip(("dq", "dk", "dv"), grads, want_grads):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=name,
                                       atol=F32_FRAC * max(float(np.abs(w).max()), 1.0))


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 in torch: float32 rounded to 10 mantissa bits, to
    nearest with ties away from zero (adding half of the dropped 13 bits'
    range to the magnitude, then clearing them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _three_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T as the kernels form an f32 product on the tensor cores:
    hi.hi + hi.lo + lo.hi with hi = tf32(x), lo = tf32(x - hi). Each product
    of two TF32 values is exact in float32."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # the TF32 ulp at 1
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-11 + 2.0**-20, 1.0 + 2.0**-12,
                      -(1.0 + 2.0**-11), one + 2.0**-11], dtype=torch.float32)
    want = torch.tensor([one, one, 1.0, -one, 1.0 + 2.0**-9], dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)


# The premise of the kernels' float32 route: three TF32 products per
# element pair stay within 1e-5 of float64, relative to the largest
# magnitude, where one TF32 product does not. Rows of S = Q K^T at D = 128
# (the widest head) and of P V over a 64-key tile (P in [0, 1], as the
# online softmax feeds it).
@pytest.mark.parametrize("what", ["qk_d128", "pv_64keys"])
def test_three_tf32_products_are_float32_accurate(what):
    rng = np.random.default_rng(17)
    if what == "qk_d128":
        a = rng.standard_normal((64, 128)).astype(np.float32)
        b = rng.standard_normal((64, 128)).astype(np.float32)
    else:
        s = rng.standard_normal((64, 64)).astype(np.float32) * 3
        a = np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
        b = rng.standard_normal((64, 64)).astype(np.float32).T.copy()  # V^T: (D, keys)
    want = torch.from_numpy(a).double() @ torch.from_numpy(b).double().T
    top = float(want.abs().max())
    got = _three_tf32(torch.from_numpy(a), torch.from_numpy(b)).double()
    assert float((got - want).abs().max()) <= 1e-5 * top
    one = (_tf32_rna(torch.from_numpy(a)) @ _tf32_rna(torch.from_numpy(b)).T).double()
    assert float((one - want).abs().max()) > 1e-5 * top


def test_launch_plan_refuses_without_a_card():
    q = torch.zeros(2, 16, 64)
    for name in fa.KERNELS:
        with pytest.raises(ValueError, match="CUDA tensors"):
            fa.launch_plan(name, q)
    with pytest.raises(ValueError, match="unknown kernel"):
        fa.launch_plan("flash_bwd", q)
    with pytest.raises(ValueError, match="D <= 128"):
        fa.launch_plan("flash_fwd", torch.zeros(2, 16, 129))

"""The port's residual VQ (ops/vq.py) held against the JAX package, on the
CPU: ``residual_vq``'s forward and gradients, the per-stage EMA update with
its stage residuals, per-stage dead-code restarts and data init of (Q, K, D)
codebooks.

Indices must agree exactly (normal inputs keep the top-2 distance gap far
above float32 rounding); values and gradients within 1e-5, sums of a few
float32 values taken in another order. ``jax.random`` cannot be reproduced
in torch, so the draws of restarts and data init are JAX's, injected.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu_torch.ops import vq

jvq = importlib.import_module("neural_sound_generation_tpu.ops.vq")

torch.set_num_threads(1)

TOL = 1e-5


def _rvq_data(n, q, k, d, seed):
    """Inputs and a codebook stack whose stages each fit what the stages
    before them leave, so every stage's assignments vary."""
    rng = np.random.default_rng(seed)
    x = (2.0 * rng.standard_normal((n, d))).astype(np.float32)
    books, residual = [], x.copy()
    for _ in range(q):
        book = residual[rng.choice(n, k, replace=False)] + 0.05 * rng.standard_normal((k, d))
        book = book.astype(np.float32)
        books.append(book)
        dist = ((residual[:, None] - book[None]) ** 2).sum(-1)
        residual = residual - book[dist.argmin(1)]
    return x, np.stack(books)


def test_residual_vq_forward_and_gradients_match_jax():
    x, cbs = _rvq_data(6 * 5, 3, 16, 8, seed=0)
    x = x.reshape(2, 3, 5, 8)
    rng = np.random.default_rng(1)
    up_st = rng.standard_normal(x.shape).astype(np.float32)
    up_sum = rng.standard_normal(x.shape).astype(np.float32)

    (j_st, j_sum, j_idx), vjp = jax.vjp(
        lambda a, b: jvq.residual_vq(a, b), jnp.asarray(x), jnp.asarray(cbs))
    j_gx, j_gcb = vjp((jnp.asarray(up_st), jnp.asarray(up_sum),
                       np.zeros(j_idx.shape, jax.dtypes.float0)))

    tx = torch.from_numpy(x).requires_grad_()
    tcb = torch.from_numpy(cbs).requires_grad_()
    st, total, idx = vq.residual_vq(tx, tcb)
    (torch.sum(st * torch.from_numpy(up_st)) + torch.sum(total * torch.from_numpy(up_sum))
     ).backward()

    assert idx.shape == (3, 30) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    for stage in range(3):  # every stage's codes are in use
        assert len(np.unique(idx[stage].numpy())) > 4
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(j_st), atol=TOL)
    np.testing.assert_allclose(total.detach().numpy(), np.asarray(j_sum), atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx), atol=TOL)
    for stage in range(3):
        np.testing.assert_allclose(tcb.grad[stage].numpy(), np.asarray(j_gcb[stage]),
                                   atol=TOL, err_msg=f"stage {stage}")
    # the encoder sees the straight-through sum once: its gradient is the
    # upstream gradient of quantized_st alone
    np.testing.assert_array_equal(tx.grad.numpy(), up_st)


@pytest.mark.parametrize("return_residuals", [False, True])
def test_residual_codebook_ema_update_matches_jax(return_residuals):
    """Stage q's statistics against the residual it saw, rebuilt with the
    pre-update codebooks."""
    x, cbs = _rvq_data(200, 3, 12, 6, seed=2)
    rng = np.random.default_rng(3)
    cluster = rng.uniform(0.0, 3.0, (3, 12)).astype(np.float32)
    esum = rng.standard_normal((3, 12, 6)).astype(np.float32)
    _, _, j_idx = jvq.residual_vq(jnp.asarray(x), jnp.asarray(cbs))
    want = jvq.residual_codebook_ema_update(
        *map(jnp.asarray, (cbs, cluster, esum, x)), j_idx, decay=0.9,
        return_residuals=return_residuals)
    _, _, idx = vq.residual_vq(torch.from_numpy(x), torch.from_numpy(cbs))
    got = vq.residual_codebook_ema_update(
        *map(torch.from_numpy, (cbs, cluster, esum, x)), idx, decay=0.9,
        return_residuals=return_residuals)
    assert len(got) == (4 if return_residuals else 3)
    for name, a, b in zip(("codebooks", "cluster", "embed_sum", "residuals"), got, want):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL, err_msg=name)


def test_rvq_restart_candidates_are_stage_residuals():
    """Mirrors tests/test_vq.py::test_rvq_restart_candidates_are_stage_residuals:
    a stage-1 restart draws from stage 1's own residual inputs (raw encoder
    outputs are 1000x larger here). With JAX's drawn rows injected the
    restarted stage agrees exactly."""
    rng = np.random.default_rng(0)
    n, dim, k = 32, 4, 8
    cb0 = (rng.standard_normal((k, dim)) * 100.0).astype(np.float32)
    flat = (cb0[rng.integers(0, k, n)]
            + (rng.standard_normal((n, dim)) * 0.1).astype(np.float32))
    cb1 = (rng.standard_normal((k, dim)) * 0.1).astype(np.float32)
    cbs = np.stack([cb0, cb1])
    _, _, j_idx = jvq.residual_vq(jnp.asarray(flat), jnp.asarray(cbs))
    j_out = jvq.residual_codebook_ema_update(
        jnp.asarray(cbs), jnp.zeros((2, k)), jnp.zeros((2, k, dim)), jnp.asarray(flat), j_idx,
        decay=0.0, return_residuals=True)
    _, _, idx = vq.residual_vq(torch.from_numpy(flat), torch.from_numpy(cbs))
    _, cluster, esum, residuals = vq.residual_codebook_ema_update(
        torch.from_numpy(cbs), torch.zeros(2, k), torch.zeros(2, k, dim), torch.from_numpy(flat),
        idx, decay=0.0, return_residuals=True)
    assert residuals.shape == (2, n, dim)
    assert float(residuals[1].abs().max()) < float(np.abs(flat).max()) / 5
    np.testing.assert_allclose(residuals.numpy(), np.asarray(j_out[3]), atol=TOL)

    key = jax.random.PRNGKey(1)
    want = jvq.restart_dead_codes(jnp.asarray(cbs[1]), jnp.zeros((k,)), j_out[3][1], key,
                                  threshold=0.5, cluster=j_out[1][1], embed_sum=j_out[2][1])
    drawn = np.array(jax.random.randint(key, (k,), 0, n))
    got = vq.restart_rows(torch.from_numpy(cbs[1]), torch.zeros(k), residuals[1][drawn],
                          threshold=0.5, cluster=cluster[1], embed_sum=esum[1])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    assert float(got[0].abs().max()) < 60.0
    # the port's own draw: every restarted row is a residual-scale row
    mine = vq.restart_dead_codes(torch.from_numpy(cbs[1]), torch.zeros(k), residuals[1],
                                 torch.Generator().manual_seed(0), threshold=0.5)
    assert float(mine.abs().max()) < 60.0


def _jax_rvq_draws(key, q, n, k, d):
    """The idx and noise JAX's data_codebook_init draws for stage q."""
    k_idx, k_noise = jax.random.split(jax.random.fold_in(key, q))
    idx = np.array(jax.random.choice(k_idx, n, (k,), replace=n < k))
    noise = np.array(jax.random.normal(k_noise, (k, d)))
    return torch.from_numpy(idx), torch.from_numpy(noise)


@pytest.mark.parametrize("n", [300, 12])  # without and with replacement
def test_rvq_data_codebook_init_matches_jax_with_the_same_draws(n):
    """Stage q > 0 is drawn from the residual after greedy assignment to the
    stages already seeded; JAX's draws injected stage by stage."""
    rng = np.random.default_rng(4)
    z_e = (3.0 + 2.0 * rng.standard_normal((n, 8))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jvq.data_codebook_init(jnp.asarray(z_e), (3, 16, 8), key))
    got = vq.data_codebook_init(
        torch.from_numpy(z_e), (3, 16, 8), torch.Generator(),
        draws=lambda q, rows, k: _jax_rvq_draws(key, q, rows, k, 8))
    assert got.shape == (3, 16, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_rvq_data_codebook_init_draws_from_successive_residuals():
    """The port's own draws (tests/test_vq.py's shape check): stage 0 within
    the data, stage 1 seeded from residuals well below stage 0's scale;
    reproducible from the generator."""
    rng = np.random.default_rng(6)
    z_e = torch.from_numpy((rng.standard_normal((4, 50, 8)) * 2.0 + 5.0).astype(np.float32))
    cb = vq.data_codebook_init(z_e, (2, 16, 8), torch.Generator().manual_seed(0))
    assert cb.shape == (2, 16, 8)
    assert abs(float(cb[0].mean()) - 5.0) < 1.0
    n0, n1 = (float(cb[q].norm(dim=-1).mean()) for q in range(2))
    assert n1 < 0.6 * n0, (n0, n1)
    again = vq.data_codebook_init(z_e, (2, 16, 8), torch.Generator().manual_seed(0))
    assert torch.equal(cb, again)

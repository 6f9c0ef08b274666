"""The port's vector quantization (ops/vq.py and the nearest-code search of
ops/cuda/vq_kernel.py) held against the JAX package, on the CPU.

On the CPU the kernel's wrapper runs its plain version; the kernel itself is
held against that plain version on the card by ``chip_smoke.py``. The JAX
side runs both of its paths: the Pallas kernel in interpret mode (as
tests/test_vq.py runs it) and the XLA expansion. Indices must agree
exactly: with normal inputs the top-2 distance gap is far above float32
rounding. Gradients agree to 1e-5: they are sums of a few float32 values.
"""

import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.ops.pallas.vq_kernel import (
    nearest_codebook_indices as jax_pallas_nearest,
)
from neural_sound_generation_tpu_torch.ops import vq
from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel

# the JAX package's ops/__init__ re-exports the function vq under the
# module's name, so the module is fetched by its full name
jvq = importlib.import_module("neural_sound_generation_tpu.ops.vq")

torch.set_num_threads(1)


def _data(n, k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((k, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,d", [
    (700, 256, 128),   # ragged N; the single-pass Pallas kernel
    (700, 1536, 128),  # K past VMEM: the K-tiled Pallas kernel
])
def test_plain_nearest_matches_both_jax_paths(n, k, d):
    x, cb = _data(n, k, d, seed=k)
    got = vq_kernel.nearest_codebook_indices_plain(torch.from_numpy(x), torch.from_numpy(cb))
    assert got.dtype == torch.int32 and got.shape == (n,)
    pallas = np.asarray(jax_pallas_nearest(jnp.asarray(x), jnp.asarray(cb), interpret=True))
    xla = np.asarray(jvq._nearest_indices_xla(jnp.asarray(x), jnp.asarray(cb)))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    # the wrapper takes the plain version for CPU tensors
    wrapped = vq_kernel.nearest_codebook_indices(torch.from_numpy(x), torch.from_numpy(cb))
    np.testing.assert_array_equal(wrapped.numpy(), xla)


def test_duplicate_codes_pick_the_first():
    x, cb = _data(64, 96, 16, seed=1)
    for j in (40, 95):
        cb[j] = cb[3]
    x = cb[3][None] + 1e-3 * x
    got = vq_kernel.nearest_codebook_indices(torch.from_numpy(x), torch.from_numpy(cb)).numpy()
    want = np.asarray(jvq._nearest_indices_xla(jnp.asarray(x), jnp.asarray(cb)))
    np.testing.assert_array_equal(got, 3)
    np.testing.assert_array_equal(want, 3)


def test_golden_indices():
    g = np.load(os.path.join(os.path.dirname(__file__), "golden", "dsp_golden.npz"))
    got = vq.vq(torch.from_numpy(g["vq_x"]), torch.from_numpy(g["vq_cb"]))
    np.testing.assert_array_equal(got.numpy(), g["vq_idx"])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, cb = torch.zeros(4, 8), torch.zeros(5, 8)
    bad = [
        (x.double(), cb.double()),        # dtype
        (x.T, cb),                        # shape mismatch
        (torch.zeros(4, 16)[:, ::2], cb),  # not contiguous
        (torch.zeros(4, 2000), torch.zeros(5, 2000)),  # D > MAX_D
        (x, torch.zeros(0, 8)),           # empty codebook
        (x[0], cb),                       # not 2-D
        (x.to("meta"), cb.to("meta")),    # neither CPU nor CUDA
    ]
    for a, b in bad:
        with pytest.raises(ValueError):
            vq_kernel.nearest_codebook_indices(a, b)


def test_cuda_route_raises_without_cuda(monkeypatch):
    """The kernel's loader refuses rather than falling back to the CPU."""
    from neural_sound_generation_tpu_torch.ops.cuda import build

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="CUDA"):
        vq_kernel.load()


def test_vq_shape_and_backends():
    x, cb = _data(2 * 5 * 3, 32, 8, seed=2)
    inputs = torch.from_numpy(x).reshape(2, 5, 3, 8)
    want = np.asarray(jvq.vq(jnp.asarray(x).reshape(2, 5, 3, 8), jnp.asarray(cb)))
    try:
        for backend in ("auto", "torch"):
            vq.set_vq_backend(backend)
            got = vq.vq(inputs, torch.from_numpy(cb))
            assert got.shape == (2, 5, 3)
            np.testing.assert_array_equal(got.numpy(), want)
        # 'kernel' pins the CUDA kernel: a CPU tensor is refused, not served
        # by the plain version
        vq.set_vq_backend("kernel")
        with pytest.raises(ValueError, match="CUDA"):
            vq.vq(inputs, torch.from_numpy(cb))
        with pytest.raises(ValueError):
            vq.set_vq_backend("pallas")
    finally:
        vq.set_vq_backend("auto")


def test_vq_st_forward_and_grads_match_jax():
    x, cb = _data(3 * 4 * 5, 16, 8, seed=3)
    x = x.reshape(3, 4, 5, 8)
    upstream = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jax_loss(inputs, codebook):
        codes, _ = jvq.vq_st(inputs, codebook)
        return jnp.sum(codes * upstream) + jnp.sum(codes**2)

    j_codes, j_idx = jvq.vq_st(jnp.asarray(x), jnp.asarray(cb))
    j_gx, j_gcb = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(cb))

    tx = torch.from_numpy(x).requires_grad_()
    tcb = torch.from_numpy(cb).requires_grad_()
    codes, idx = vq.vq_st(tx, tcb)
    (torch.sum(codes * torch.from_numpy(upstream)) + torch.sum(codes**2)).backward()

    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(codes.detach().numpy(), np.asarray(j_codes))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(j_gx), atol=1e-5)
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(j_gcb), atol=1e-5)
    assert not idx.requires_grad


def test_codebook_lookup_grad_is_index_add():
    cb = torch.randn(6, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    idx = torch.tensor([[1, 1, 5], [0, 1, 5]], dtype=torch.int32)
    out = vq.codebook_lookup(cb, idx)
    assert out.shape == (2, 3, 4)
    out.sum().backward()
    counts = torch.bincount(idx.flatten().long(), minlength=6).float()
    torch.testing.assert_close(cb.grad, counts[:, None].expand(6, 4))
    j = jax.grad(lambda c: jnp.sum(jvq.codebook_lookup(c, jnp.asarray(idx.numpy()))))(
        jnp.asarray(cb.detach().numpy()))
    np.testing.assert_allclose(cb.grad.numpy(), np.asarray(j), atol=1e-6)


def test_codebook_ema_update_matches_jax():
    """Counts and sums per code, then the smoothed means; sums of a few
    float32 values in another order: 1e-5 relative."""
    x, cb = _data(300, 24, 8, seed=5)
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 24, 300).astype(np.int32)
    idx[idx == 5] = 6  # a code with no assignment this step
    cluster = rng.uniform(0.0, 3.0, 24).astype(np.float32)
    esum = rng.standard_normal((24, 8)).astype(np.float32)
    want = jvq.codebook_ema_update(*map(jnp.asarray, (cb, cluster, esum, x, idx)), decay=0.9)
    got = vq.codebook_ema_update(*map(torch.from_numpy, (cb, cluster, esum, x, idx)), decay=0.9)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_stats", [False, True])
def test_restart_dead_codes_matches_jax_with_the_same_draws(with_stats):
    """jax.random cannot be reproduced in torch: JAX's drawn rows are
    injected into ``restart_rows``, which must then agree exactly."""
    x, cb = _data(50, 16, 4, seed=7)
    usage = np.random.default_rng(8).uniform(0.0, 2.0, 16).astype(np.float32)
    cluster, esum = usage.copy(), cb * 2.0
    key = jax.random.PRNGKey(3)
    kw = dict(cluster=jnp.asarray(cluster), embed_sum=jnp.asarray(esum)) if with_stats else {}
    want = jvq.restart_dead_codes(jnp.asarray(cb), jnp.asarray(usage), jnp.asarray(x), key,
                                  threshold=1.0, **kw)
    drawn = np.array(jax.random.randint(key, (16,), 0, 50))
    tkw = dict(cluster=torch.from_numpy(cluster), embed_sum=torch.from_numpy(esum)) if with_stats else {}
    got = vq.restart_rows(torch.from_numpy(cb), torch.from_numpy(usage),
                          torch.from_numpy(x[drawn]), threshold=1.0, **tkw)
    for a, b in zip(got if with_stats else [got], want if with_stats else [want]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_restart_dead_codes_draws_rows_of_the_batch():
    x, cb = _data(50, 16, 4, seed=9)
    usage = torch.linspace(0.0, 2.0, 16)
    gen = torch.Generator().manual_seed(0)
    new_cb, cluster, esum = vq.restart_dead_codes(
        torch.from_numpy(cb), usage, torch.from_numpy(x), gen, threshold=1.0,
        cluster=usage.clone(), embed_sum=torch.from_numpy(cb).clone())
    dead = usage < 1.0
    rows = {tuple(r) for r in x.tolist()}
    assert all(tuple(r) in rows for r in new_cb[dead].tolist())
    assert torch.equal(new_cb[~dead], torch.from_numpy(cb)[~dead])
    assert torch.equal(cluster[dead], torch.ones(int(dead.sum())))
    assert torch.equal(esum[dead], new_cb[dead])
    again = vq.restart_dead_codes(torch.from_numpy(cb), usage, torch.from_numpy(x),
                                  torch.Generator().manual_seed(0), threshold=1.0)
    assert torch.equal(again, new_cb)  # seeded: reproducible


@pytest.mark.parametrize("n", [200, 10])  # without and with replacement
def test_data_codebook_init_matches_jax_with_the_same_draws(n):
    """JAX's drawn rows and noise are injected into ``codebook_from_rows``:
    1e-6 relative (the standard deviation is a float32 reduction)."""
    rng = np.random.default_rng(10)
    z_e = (3.0 + rng.standard_normal((n, 8))).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jvq.data_codebook_init(jnp.asarray(z_e), (16, 8), key))
    k_idx, k_noise = jax.random.split(key)
    idx = np.array(jax.random.choice(k_idx, n, (16,), replace=n < 16))
    noise = np.array(jax.random.normal(k_noise, (16, 8)))
    got = vq.codebook_from_rows(torch.from_numpy(z_e), torch.from_numpy(idx),
                                torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the port's own draws: rows of z_e plus a small jitter, distinct rows
    # when there are enough, reproducible from the generator
    mine = vq.data_codebook_init(torch.from_numpy(z_e), (16, 8), torch.Generator().manual_seed(1))
    dist = torch.cdist(mine, torch.from_numpy(z_e)).min(dim=1).values
    assert float(dist.max()) < 0.2 and mine.shape == (16, 8)
    # a residual-VQ shape seeds a (Q, K, D) stack (tests/test_torch_rvq.py
    # holds it against JAX)
    stack = vq.data_codebook_init(torch.from_numpy(z_e), (2, 16, 8), torch.Generator())
    assert stack.shape == (2, 16, 8)

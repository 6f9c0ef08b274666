"""The port's fused Adam(+EMA) update held against the JAX package on the CPU.

On the CPU ``fused_adam_update`` runs the kernel's plain version; the CUDA
kernel itself is held against that plain version on the card by
``chip_smoke.py`` (bit for bit there). Here the port's
``training.train_state.fused_flat_update`` is held against the JAX
``fused_flat_update`` (its XLA branch) and against the Pallas kernel in
interpret mode, as ``tests/test_fused_adam.py`` runs it.

Tolerances: parameters, EMA and float32 moments within 2e-6 relative plus
4 float32 ulps of the vector's largest magnitude (where a sum cancels to
near zero): both sides round every operation to float32, but XLA may fuse
a multiply and an add into one rounding. bf16 moments within one bf16 ulp
(2**-7 relative) plus the same absolute term (an f32 difference of one
rounding can move the bf16 rounding by an ulp, and by more where a sum
cancels to near zero).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.ops.pallas.fused_adam import (
    fused_adam_update as jax_pallas_update,
)
from neural_sound_generation_tpu.training import train_state as jts
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.ops.cuda import build, fused_adam
from neural_sound_generation_tpu_torch.training import train_state as tts

torch.set_num_threads(1)

N = 100_003  # a multiple of no block size, vector width or tile
COUNT = 7

SCHEDULES = {
    "constant": ("constant", {}),
    "noam": ("noam_learning_rate_decay", {"warmup_steps": 5}),
    "step": ("step_learning_rate_decay", {"anneal_rate": 0.5, "anneal_interval": 4}),
}


def _cfgs(bf16=False, clip=None, wd=0.0, schedule="constant", ema_warmup=False):
    name, kwargs = SCHEDULES[schedule]
    fields = dict(bf16_moments=bf16, clip_thresh=clip, weight_decay=wd, lr_schedule=name,
                  lr_schedule_kwargs=kwargs, ema_warmup=ema_warmup, ema_decay=0.99)
    return (dataclasses.replace(JaxConfig().train, **fields),
            dataclasses.replace(Config().train, **fields))


def _inputs(bf16):
    rng = np.random.default_rng(0)
    g = rng.standard_normal(N).astype(np.float32)
    p = rng.standard_normal(N).astype(np.float32)
    m = (0.01 * rng.standard_normal(N)).astype(np.float32)
    v = rng.uniform(1e-4, 2e-3, N).astype(np.float32)
    ema = (0.9 * p).astype(np.float32)
    if bf16:  # both sides start from the same bf16 values
        m = np.asarray(jnp.asarray(m, jnp.bfloat16).astype(jnp.float32))
        v = np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    return g, p, m, v, ema


def _port_update(tcfg, g, p, m, v, ema, use_schedule):
    mdt = torch.bfloat16 if tcfg.bf16_moments else torch.float32
    s = tts.FusedOptState(
        count=torch.tensor(COUNT, dtype=torch.int32),
        m=torch.from_numpy(m.copy()).to(mdt), v=torch.from_numpy(v.copy()).to(mdt),
        lr=tts.make_lr_schedule(tcfg) if use_schedule else tcfg.initial_learning_rate,
        b1=tcfg.adam_beta1, b2=tcfg.adam_beta2, eps=tcfg.adam_eps,
        clip=float(tcfg.clip_thresh or -1.0), wd=float(tcfg.weight_decay or 0.0),
    )
    tp = torch.from_numpy(p.copy())
    tema = None if ema is None else torch.from_numpy(ema.copy())
    gnorm = tts.fused_flat_update(s, tp, torch.from_numpy(g), tema, tcfg.ema_decay,
                                  tcfg.ema_warmup, torch.tensor(COUNT, dtype=torch.int32))
    assert int(s.count) == COUNT + 1
    return tp, s.m, s.v, tema, gnorm


def _close(got, want, name="", rtol=2e-6):
    want = np.asarray(want, np.float32)
    atol = 4 * float(np.spacing(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=atol, err_msg=name)


def _assert_moment(got: torch.Tensor, want, name):
    if got.dtype == torch.bfloat16:
        _close(got.float().numpy(), np.asarray(want, np.float32), name, rtol=2**-7)
    else:
        _close(got.numpy(), want, name)


def _assert_all(port, want):
    tp, tm, tv, tema, gnorm = port
    _close(tp.numpy(), want[0], "p")
    _assert_moment(tm, want[1], "m")
    _assert_moment(tv, want[2], "v")
    if tema is None:
        assert want[3] is None
    else:
        _close(tema.numpy(), want[3], "ema")
    np.testing.assert_allclose(float(gnorm), float(want[5]), rtol=1e-6)


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("clip,wd,has_ema,warmup", [
    (None, 0.0, True, False),
    (100.0, 0.01, True, True),   # clip threshold above the norm: scale 1
    (5.0, 0.01, False, False),   # the norm is about 316: clipped
])
def test_plain_update_matches_jax_xla_branch(schedule, bf16, clip, wd, has_ema, warmup):
    jcfg, tcfg = _cfgs(bf16, clip, wd, schedule, warmup)
    g, p, m, v, ema = _inputs(bf16)
    if not has_ema:
        ema = None
    mdt = jnp.bfloat16 if bf16 else jnp.float32
    s = jts._fused_opt_init({"w": jnp.zeros(N)}, jcfg, use_schedule=True)
    want = jts.fused_flat_update(
        s, jnp.asarray(COUNT, jnp.int32), jnp.asarray(m, mdt), jnp.asarray(v, mdt),
        jnp.asarray(p), jnp.asarray(g), None if ema is None else jnp.asarray(ema),
        jcfg.ema_decay, warmup, jnp.asarray(COUNT, jnp.int32),
    )
    _assert_all(_port_update(tcfg, g, p, m, v, ema, use_schedule=True), want)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("clip,wd,has_ema", [(None, 0.0, True), (5.0, 0.01, False)])
def test_plain_update_matches_pallas_interpret(bf16, clip, wd, has_ema):
    jcfg, tcfg = _cfgs(bf16, clip, wd)
    g, p, m, v, ema = _inputs(bf16)
    mdt = jnp.bfloat16 if bf16 else jnp.float32
    gnorm = jnp.linalg.norm(jnp.asarray(g))
    gscale = jnp.minimum(1.0, clip / jnp.maximum(gnorm, 1e-12)) if clip else 1.0
    got = jax_pallas_update(
        jnp.asarray(g), jnp.asarray(p), jnp.asarray(m, mdt), jnp.asarray(v, mdt),
        jnp.asarray(ema), gscale, jcfg.initial_learning_rate, float(COUNT + 1),
        jnp.float32(jcfg.ema_decay),
        b1=jcfg.adam_beta1, b2=jcfg.adam_beta2, eps=jcfg.adam_eps, clip=bool(clip),
        wd=wd, has_ema=has_ema, interpret=True,
    )
    port = _port_update(tcfg, g, p, m, v, ema if has_ema else None, use_schedule=False)
    _assert_all(port, (*got, None, gnorm))


def _scalars(**kw):
    return torch.tensor([kw.get("gscale", 1.0), 1e-3, 0.1, 0.001, 0.9], dtype=torch.float32)


def _vectors(n=1000, dtype=torch.float32):
    gen = torch.Generator().manual_seed(1)
    return [torch.randn(n, generator=gen) for _ in range(2)] + [
        torch.zeros(n, dtype=dtype), torch.full((n,), 1e-3, dtype=dtype),
        torch.randn(n, generator=gen)]


KW = dict(b1=0.9, b2=0.999, eps=1e-8, clip=True, wd=0.01)


def test_cpu_tensors_run_the_plain_version():
    g, p, m, v, e = _vectors()
    want = [t.clone() for t in (p, m, v, e)]
    fused_adam.fused_adam_plain(g, *want, _scalars(gscale=0.5), **KW)
    before = fused_adam.launch_count()
    fused_adam.fused_adam_update(g, p, m, v, e, _scalars(gscale=0.5), **KW)
    for a, b in zip((p, m, v, e), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fused_adam.launch_count() == before  # no kernel ran


def test_kernel_request_on_cpu_raises_and_does_not_fall_back():
    g, p, m, v, e = _vectors()
    p0 = p.clone()
    with pytest.raises(ValueError, match="CUDA"):
        fused_adam.launch(g, p, m, v, e, _scalars(), **KW)
    assert torch.equal(p, p0)


def test_loader_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(fused_adam, "_lib", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_adam.load()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    g, p, m, v, e = _vectors()
    bad = [
        (g.double(), p, m, v, e, _scalars()),                 # dtype of g
        (g[:-1], p, m, v, e, _scalars()),                     # length
        (g, p, m.half(), v.half(), e, _scalars()),            # moment dtype
        (g, p, m, v.bfloat16(), e, _scalars()),               # mixed moments
        (g, p, m, v, p, _scalars()),                          # ema aliases p
        (g, p, m, v, e, _scalars()[:4]),                      # scalars
        (torch.randn(2000)[::2], p, m, v, e, _scalars()),     # not contiguous
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fused_adam.fused_adam_update(*args, **KW)


def test_global_norm_is_float64_accurate_at_the_flagship_size():
    """grad_norm and the clip factor come from a cascaded float32 sum of
    squares: within 1e-6 of the float64 norm at the flagship VQ-VAE's
    4,865,793 parameters (a single running float32 sum misses by far
    more at this length)."""
    n = 4_865_793
    rng = np.random.default_rng(3)
    g = (rng.standard_normal(n) * rng.uniform(0, 1, n) ** 8 * 1e-3).astype(np.float32)
    s = tts.FusedOptState(count=torch.tensor(0, dtype=torch.int32), m=torch.zeros(n),
                          v=torch.zeros(n), clip=1e-3)
    gnorm = tts.fused_flat_update(s, torch.zeros(n), torch.from_numpy(g), None, 0.0, False,
                                  torch.tensor(0, dtype=torch.int32))
    want = np.linalg.norm(g.astype(np.float64))
    assert abs(float(gnorm) - want) / want < 1e-6

"""The per-leaf optimizer (``TrainConfig.fused_optimizer`` off) against JAX's optax chain.

``create_train_state(fused=False)`` builds the JAX ``make_optimizer``
chain's state (clip by the global norm -> weight decay -> Adam, a moment
tensor a parameter). Three updates from the same parameters and gradients
(drawn from a seed, their norm above the clip) are held against the JAX
state's ``apply_gradients`` with its optax chain: parameters, moments and
the EMA shadow within 1e-6 of each one's largest magnitude (float32
elementwise math in the same order; XLA fuses it and rounds an element
near 0 a few ulps of the largest otherwise); the global norm 1e-6. A
checkpoint written under one optimizer restores into the other with its
moments, count, step and EMA bit-exact (the JAX ``_adapt_fused_layout``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu.training import train_state as jts
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.training import checkpoint, train_state

DIM, Z_DIM = 8, 16
TRAIN = dict(clip_thresh=0.5, weight_decay=1e-2, ema_decay=0.9, initial_learning_rate=1e-2)
RTOL = 1e-6


def _cfgs(**train):
    jc, tc = JaxConfig(), Config()
    return (dataclasses.replace(jc, train=dataclasses.replace(jc.train, **TRAIN, **train)),
            dataclasses.replace(tc, train=dataclasses.replace(tc.train, **TRAIN, **train)))


@pytest.mark.parametrize("schedule", [False, True])
def test_leaf_updates_match_the_optax_chain(schedule):
    jcfg, tcfg = _cfgs(lr_schedule="noam_learning_rate_decay",
                       lr_schedule_kwargs={"warmup_steps": 2}) if schedule else _cfgs()
    v = jax.tree_util.tree_map(np.asarray, JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)), train=False))
    model = VQVAE(1, DIM, Z_DIM)
    model.load_state_dict(convert.flax_to_state_dict(v))
    ts = train_state.create_train_state(model, tcfg.train, use_schedule=schedule, fused=False)
    js = jts.create_train_state(v, jcfg.train, use_schedule=schedule, fused=False)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), v["params"])
        sd = convert.flax_to_state_dict({"params": grads}, model)
        for name, g in ts.flat.named(ts.flat.grad).items():
            g.copy_(sd[name])
        gnorm = ts.apply_gradients()
        ts.step.add_(1)
        js = js.apply_gradients(jax.tree_util.tree_map(jnp.asarray, grads))
        want_norm = float(jnp.sqrt(sum(jnp.sum(jnp.asarray(g) ** 2)
                                       for g in jax.tree_util.tree_leaves(grads))))
        assert float(gnorm) == pytest.approx(want_norm, rel=RTOL)
        assert want_norm > TRAIN["clip_thresh"]  # the clip acts
    adam = next(s for s in jax.tree_util.tree_leaves(
        js.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    pairs = {"params": (ts.flat.named(ts.flat.flat), js.params),
             "mu": (ts.opt_state.m, adam.mu), "nu": (ts.opt_state.v, adam.nu),
             "ema": (ts.flat.named(ts.ema_params), js.ema_params)}
    for what, (port, jtree) in pairs.items():
        got = convert.ravel_flax(convert.module_to_flax(model, port)["params"])
        want = convert.ravel_flax(jax.tree_util.tree_map(np.asarray, jtree))
        np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max(),
                                   err_msg=what)
    assert int(ts.opt_state.count) == int(adam.count) == 3


@pytest.mark.parametrize("saved,restored", [(True, False), (False, True)])
def test_checkpoints_cross_between_the_optimizers(tmp_path, saved, restored):
    """fused -> per-leaf and per-leaf -> fused: the moments by name, the
    count, the step and the EMA shadow survive (bf16 moments cast)."""
    _, tcfg = _cfgs(bf16_moments=True)
    a = train_state.create_train_state(VQVAE(1, DIM, Z_DIM), tcfg.train, fused=saved)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in (*a.opt_state.moments(), a.ema_params):
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
        a.opt_state.count.fill_(7)
        a.step.fill_(7)
    checkpoint.save(str(tmp_path), a, step=7)
    b = train_state.create_train_state(VQVAE(1, DIM, Z_DIM), tcfg.train, fused=restored)
    checkpoint.restore(str(tmp_path), b)
    assert isinstance(b.opt_state, train_state.LeafOptState) == (not restored)
    for key in ("m", "v"):
        got, want = (s.opt_state.named_moments(s.flat, key) for s in (b, a))
        for name in want:
            assert torch.equal(got[name], want[name].to(got[name].dtype)), (key, name)
    assert torch.equal(b.ema_params, a.ema_params)
    assert int(b.opt_state.count) == int(b.step) == 7

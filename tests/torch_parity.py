"""Shared helpers of the tests that hold the port's autoencoders against the
JAX package on the CPU: numpy trees, perturbed BatchNorm statistics, and a
pair of train states (JAX and port) with the same weights, warm Adam moments
and EMA shadow.

Tolerances of one train step (those of ``tests/test_torch_training.py``,
whose reasons hold here): loss terms 1e-5 relative, grad_norm 1e-4
relative, gradients 2e-4 of the largest, parameters, EMA and BatchNorm
statistics 2e-5 absolute, Adam moments 1e-3 of the vector's largest.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.training import train_state as jts
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.training import train_state

ATOL = 1e-4
COUNT = 100
LOSS_RTOL, GNORM_RTOL, GRAD_FRAC, PARAM_ATOL, MOMENT_FRAC = 1e-5, 1e-4, 2e-4, 2e-5, 1e-3
TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, ema_warmup=True,
             initial_learning_rate=1e-3)


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def perturb_stats(variables, seed):
    """Running means drawn from [-0.5, 0.5), variances from [0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        low = 0.5 if path[-1].key == "var" else -0.5
        return rng.uniform(low, low + 1.0, a.shape).astype(np.float32)

    out = dict(variables)
    if "batch_stats" in out:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, out["batch_stats"])
    return out


def perturb_params(variables, seed, scale=0.1):
    """Every parameter moved by ``scale`` x N(0, 1): nonzero biases and norm
    shifts take part."""
    rng = np.random.default_rng(seed)
    out = dict(variables)
    out["params"] = jax.tree_util.tree_map(
        lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32), out["params"])
    return out


def cfgs(**model):
    """(JAX Config, port Config) with the same train settings and ``model``
    fields."""
    out = []
    for base in (JaxConfig(), Config()):
        out.append(dataclasses.replace(
            base, train=dataclasses.replace(base.train, **TRAIN),
            model=dataclasses.replace(base.model, **model)))
    return out


class TrainPair:
    """A JAX train state and the port's over the same weights (``variables``
    already loaded into ``tm``), with warm moments (count COUNT) and a
    perturbed EMA shadow; ``ema_codebook`` adds the codebook statistics."""

    def __init__(self, jm, variables, tm, jcfg, tcfg, ema_codebook=False, seed=0):
        self.jm, self.tm, self.jcfg, self.tcfg = jm, tm, jcfg, tcfg
        self.variables = variables
        rng = np.random.default_rng(seed + 1000)
        flat_p = np.asarray(ravel_pytree(variables["params"])[0])
        n = flat_p.size
        m0 = (1e-3 * rng.standard_normal(n)).astype(np.float32)
        v0 = rng.uniform(1e-6, 1e-5, n).astype(np.float32)
        ema0 = (flat_p + 0.01 * rng.standard_normal(n)).astype(np.float32)
        js = jts.create_train_state(variables, jcfg.train, ema_codebook=ema_codebook)
        self.jstate = js.replace(
            step=jnp.asarray(COUNT, jnp.int32),
            opt_state=js.opt_state.replace(count=jnp.asarray(COUNT, jnp.int32),
                                           m=jnp.asarray(m0), v=jnp.asarray(v0)),
            ema_params=jnp.asarray(ema0),
        )
        ts = train_state.create_train_state(tm, tcfg.train, ema_codebook=ema_codebook)
        names = ts.flat.names
        with torch.no_grad():
            ts.step.fill_(COUNT)
            ts.opt_state.count.fill_(COUNT)
            for dst, src in ((ts.opt_state.m, m0), (ts.opt_state.v, v0), (ts.ema_params, ema0)):
                dst.copy_(convert.flax_flat_to_port(src, variables["params"], names, tm))
        self.tstate = ts

    def to_jax_order(self, vector):
        return convert.port_flat_to_flax(vector, self.tm, self.tstate.flat)

    def assert_grads_match(self, jgrads):
        want = np.asarray(ravel_pytree(jgrads)[0])
        got = self.to_jax_order(self.tstate.flat.grad)
        np.testing.assert_allclose(got, want, atol=GRAD_FRAC * np.abs(want).max())

    def assert_states_match(self, jstate):
        ts = self.tstate
        np.testing.assert_allclose(self.to_jax_order(ts.flat.flat),
                                   np.asarray(ravel_pytree(jstate.params)[0]), atol=PARAM_ATOL)
        np.testing.assert_allclose(self.to_jax_order(ts.ema_params),
                                   np.asarray(jstate.ema_params), atol=PARAM_ATOL)
        for key in ("m", "v"):
            want = np.asarray(getattr(jstate.opt_state, key))
            np.testing.assert_allclose(
                self.to_jax_order(getattr(ts.opt_state, key)), want,
                atol=MOMENT_FRAC * np.abs(want).max(), err_msg=key)
        stats = convert.module_to_flax(self.tm).get("batch_stats")
        if stats is not None:
            np.testing.assert_allclose(ravel_pytree(stats)[0],
                                       np.asarray(ravel_pytree(jstate.batch_stats)[0]),
                                       atol=PARAM_ATOL)
        assert int(ts.step) == int(jstate.step)
        assert int(ts.opt_state.count) == int(jstate.opt_state.count)


def assert_metrics(tm, jm, keys):
    for k in keys:
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(np.asarray(tm["grad_norm"]), np.asarray(jm["grad_norm"]),
                               rtol=GNORM_RTOL)


def assert_round_trip(variables, tm):
    """flax -> port -> flax is bit-exact, and a flat vector in JAX order
    comes back through the port's flat order unchanged."""
    tm.load_state_dict(convert.flax_to_state_dict(variables, tm))
    back = convert.module_to_flax(tm)
    for want, got in ((variables["params"], back["params"]),
                      (variables.get("batch_stats", {}), back.get("batch_stats", {}))):
        w, _ = ravel_pytree(want)
        g, _ = ravel_pytree(got)
        assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    flat = train_state.FlatParams(tm)
    jflat = np.asarray(ravel_pytree(variables["params"])[0])
    rng = np.random.default_rng(0)
    vec = rng.standard_normal(jflat.size).astype(np.float32)
    port = convert.flax_flat_to_port(vec, variables["params"], flat.names, tm)
    np.testing.assert_array_equal(convert.port_flat_to_flax(port, tm, flat), vec)

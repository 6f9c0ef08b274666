"""The port's TransformerPrior and its training step held against the JAX
package on the CPU, with the same weights (through the bridge), codes and
optimizer state: dim 32, 2 heads, 2 layers, 4 x 5 code grids. Cases named
``moe`` route the MLPs through 2 experts (``models/moe.py``; capacity
factor 1.25, and 0.5 for the cached decode, where tokens are dropped); the
routed train step adds 0.01 times the load-balance term to the loss.

Tolerances, with their reasons (float32 matrix products and LayerNorm
statistics summed in another order, about 1e-7 relative per operation):
  * logits 1e-5 of their largest magnitude, absolute;
  * the NLL 1e-6 relative; grad_norm 1e-5 relative;
  * gradients 1e-5 of the largest gradient, absolute;
  * parameters and the EMA after one step 2e-6 absolute (steps of about
    lr = 1e-3 from warm moments); Adam moments 1e-4 of the vector's largest
    magnitude;
  * the load-balance term 1e-6 relative;
  * KV-cached logits against the teacher-forced forward 1e-5 absolute;
  * sampled codes equal where the top two Gumbel-perturbed logits differ
    by more than 1e-4 (a near-tie may go either way).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import transformer_prior as jtp
from neural_sound_generation_tpu.training import train_state as jts
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import TransformerPrior
from neural_sound_generation_tpu_torch.models import transformer_prior as tp
from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
from neural_sound_generation_tpu_torch.training import losses, train_state, trainer

torch.set_num_threads(1)

K, DIM, HEADS, LAYERS, CLASSES = 64, 32, 2, 2, 10
B, H, W = 3, 4, 5
COUNT = 100
TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, ema_warmup=True,
             initial_learning_rate=1e-3)


def _codes(seed, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, K, (b, h, w)).astype(np.int32),
            rng.integers(0, CLASSES, b).astype(np.int32))


#: the parametrised cases: dense MLPs, or 2 routed experts
ARCHS = {"dense": 0, "moe": 2}


class Pair:
    """The JAX prior and the port's, with the same weights; ``n_experts``
    > 0 routes the MLPs."""

    def __init__(self, seed=0, n_experts=0, capacity_factor=1.25):
        codes, labels = _codes(seed)
        self.jm = jtp.TransformerPrior(input_dim=K, dim=DIM, n_layers=LAYERS, n_heads=HEADS,
                                       n_classes=CLASSES, n_experts=n_experts,
                                       capacity_factor=capacity_factor)
        v = self.jm.init(jax.random.PRNGKey(seed), jnp.asarray(codes), jnp.asarray(labels))
        # params only: the routed init also sows its load-balance terms
        self.variables = {"params": jax.tree_util.tree_map(np.asarray, v["params"])}
        self.tm = TransformerPrior(K, DIM, LAYERS, HEADS, CLASSES, n_experts=n_experts,
                                   capacity_factor=capacity_factor)
        self.tm.load_state_dict(convert.flax_to_state_dict(self.variables))

    def jlogits(self, codes, labels):
        return np.asarray(self.jm.apply(self.variables, jnp.asarray(codes), jnp.asarray(labels)))


def _close(got, want, frac, err_msg=""):
    np.testing.assert_allclose(got, want, atol=frac * np.abs(want).max(), rtol=0,
                               err_msg=err_msg)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_the_jax_module(arch):
    pair = Pair(n_experts=ARCHS[arch])
    codes, labels = _codes(1)
    got = pair.tm(torch.from_numpy(codes), torch.from_numpy(labels))
    assert got.shape == (B, H, W, K) and got.dtype == torch.float32
    _close(got.detach().numpy(), pair.jlogits(codes, labels), 1e-5)


def test_loss_and_gradients_match_jax_grad():
    pair = Pair(seed=2)
    codes, labels = _codes(3)
    loss_fn = jtrainer._pixelcnn_loss_fn(pair.jm)
    (jloss, (jmetrics, _, _)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        pair.variables["params"], {}, {"codes": jnp.asarray(codes),
                                       "labels": jnp.asarray(labels)}, None)
    logits = pair.tm(torch.from_numpy(codes), torch.from_numpy(labels))
    total, metrics = losses.prior_nll(logits, torch.from_numpy(codes))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jloss), rtol=1e-6)
    for k in ("loss", "nll_per_code"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-6)
    grads = {n: p.grad for n, p in pair.tm.named_parameters()}
    got = convert.ravel_flax(convert.module_to_flax(pair.tm, grads)["params"])
    _close(got, np.asarray(ravel_pytree(jgrads)[0]), 1e-5)


def _cfgs():
    out = []
    for base in (JaxConfig(), Config()):
        out.append(dataclasses.replace(base, train=dataclasses.replace(base.train, **TRAIN)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi", [1, 2])
def test_fused_train_steps_match_the_jax_trainer(multi, arch):
    """From warm moments (count 100, m and v drawn so Adam's step is a
    smooth function of the gradient), ``multi`` steps of the JAX train step
    (scanned for 2) against the port's, compared through the flat-vector
    bridge; a routed prior's loss carries its load-balance term."""
    pair = Pair(seed=4, n_experts=ARCHS[arch])
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    params = pair.variables["params"]
    flat_p = np.asarray(ravel_pytree(params)[0])
    n = flat_p.size
    m0 = (1e-3 * rng.standard_normal(n)).astype(np.float32)
    v0 = rng.uniform(1e-6, 1e-5, n).astype(np.float32)
    ema0 = (flat_p + 0.01 * rng.standard_normal(n)).astype(np.float32)

    js = jts.create_train_state(pair.variables, jcfg.train)
    js = js.replace(step=jnp.asarray(COUNT, jnp.int32), ema_params=jnp.asarray(ema0),
                    opt_state=js.opt_state.replace(count=jnp.asarray(COUNT, jnp.int32),
                                                   m=jnp.asarray(m0), v=jnp.asarray(v0)))
    ts = train_state.create_train_state(pair.tm, tcfg.train)
    names = ts.flat.names
    with torch.no_grad():
        ts.step.fill_(COUNT)
        ts.opt_state.count.fill_(COUNT)
        ts.opt_state.m.copy_(convert.flax_flat_to_port(m0, params, names))
        ts.opt_state.v.copy_(convert.flax_flat_to_port(v0, params, names))
        ts.ema_params.copy_(convert.flax_flat_to_port(ema0, params, names))

    batches = [_codes(10 + i) for i in range(multi)]
    if multi == 1:
        codes, labels = batches[0]
        js, jm = jtrainer.make_train_step(pair.jm, jcfg, donate=False)(
            js, {"codes": jnp.asarray(codes), "labels": jnp.asarray(labels)},
            jax.random.PRNGKey(0))
        _, tmetrics = trainer.make_train_step(pair.tm, tcfg)(
            ts, {"codes": torch.from_numpy(codes), "labels": torch.from_numpy(labels)})
    else:
        stacked = {"codes": np.stack([c for c, _ in batches]),
                   "labels": np.stack([lab for _, lab in batches])}
        js, jm = jtrainer.make_multistep_train(pair.jm, jcfg, multi, donate=False)(
            js, {k: jnp.asarray(x) for k, x in stacked.items()}, jax.random.PRNGKey(0))
        _, tmetrics = trainer.make_multistep_train(pair.tm, tcfg, multi)(
            ts, {k: torch.from_numpy(x) for k, x in stacked.items()})
    assert sorted(tmetrics) == sorted(jm)
    for k in ("loss", "nll_per_code", "moe_load_balance")[: 3 if ARCHS[arch] else 2]:
        np.testing.assert_allclose(np.asarray(tmetrics[k]), np.asarray(jm[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(np.asarray(tmetrics["grad_norm"]), np.asarray(jm["grad_norm"]),
                               rtol=1e-5)

    def port(vector):
        return convert.port_flat_to_flax(vector, pair.tm, ts.flat)

    np.testing.assert_allclose(port(ts.flat.flat), np.asarray(ravel_pytree(js.params)[0]),
                               atol=2e-6)
    np.testing.assert_allclose(port(ts.ema_params), np.asarray(js.ema_params), atol=2e-6)
    for key in ("m", "v"):
        want = np.asarray(getattr(js.opt_state, key))
        _close(port(getattr(ts.opt_state, key)), want, 1e-4, err_msg=key)
    assert int(ts.step) == int(js.step) == COUNT + multi


def test_eval_step_runs_on_the_ema_shadow():
    pair = Pair(seed=6)
    _, tcfg = _cfgs()
    state = train_state.create_train_state(pair.tm, tcfg.train)
    with torch.no_grad():
        state.ema_params.mul_(0.5)
    codes, labels = (torch.from_numpy(x) for x in _codes(7))
    logits, metrics = trainer.make_eval_step(pair.tm, tcfg)(
        state, {"codes": codes, "labels": labels})
    with state.flat.swapped(state.ema_params):
        want = pair.tm(codes, labels)
    assert torch.equal(logits, want)
    assert torch.equal(metrics["loss"], losses.prior_nll(want, codes)[0])


def dropped_tokens(model: TransformerPrior, codes, labels) -> list[int]:
    """Per routed block, the tokens the teacher-forced forward drops."""
    dropped = []
    hooks = [blk.moe.register_forward_hook(
        lambda m, args, out: dropped.append(int((~m.dispatch(args[0])[-1]).sum())))
        for blk in model.blocks]
    with torch.no_grad():
        model(codes, labels)
    for h in hooks:
        h.remove()
    return dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_logits_match_the_forward_and_jax(arch):
    """The routed case runs at capacity factor 0.5, where the forward drops
    tokens in every block and the cached decode must drop the same ones."""
    pair = Pair(seed=8, n_experts=ARCHS[arch], capacity_factor=0.5 if ARCHS[arch] else 1.25)
    codes, labels = _codes(9)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(labels)
    if ARCHS[arch]:
        assert min(dropped_tokens(pair.tm, tc, tl)) > 0
    inc = tp.incremental_logits(pair.tm, tc, tl)
    np.testing.assert_allclose(inc.numpy(), pair.tm(tc, tl).detach().numpy(), atol=1e-5)
    jinc = np.asarray(jtp.incremental_logits(pair.jm, pair.variables, jnp.asarray(codes),
                                             jnp.asarray(labels)))
    np.testing.assert_allclose(inc.numpy(), jinc, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_with_jax_gumbel_draws_the_jax_codes(arch):
    pair = Pair(seed=10, n_experts=ARCHS[arch])
    labels = np.array([0, 3, 7], np.int32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jtp.generate(pair.jm, pair.variables, jnp.asarray(labels), key,
                                   shape=(H, W), batch_size=B))
    gumbel = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(key, t), (B, K)))
                       for t in range(H * W)])
    got = tp.generate(pair.tm, torch.from_numpy(labels), shape=(H, W), batch_size=B,
                      gumbel=torch.from_numpy(gumbel)).numpy()
    assert got.dtype == np.int32 and got.shape == (B, H, W)
    # where the draws differ, the JAX codes' perturbed logits must be a near-tie
    mismatch = np.argwhere(got.reshape(B, -1) != want.reshape(B, -1))
    if len(mismatch):
        b, t = mismatch[0]
        logits = np.asarray(jtp.incremental_logits(
            pair.jm, pair.variables, jnp.asarray(want), jnp.asarray(labels))).reshape(B, -1, K)
        top2 = np.sort(logits[b, t] + gumbel[t, b])[-2:]
        assert top2[1] - top2[0] <= 1e-4, (b, t, top2)


def test_generate_draws_from_a_generator_reproducibly():
    pair = Pair(seed=12)
    labels = torch.tensor([1, 2], dtype=torch.int32)
    a = tp.generate(pair.tm, labels, torch.Generator().manual_seed(3), (3, 4), 2)
    b = tp.generate(pair.tm, labels, torch.Generator().manual_seed(3), (3, 4), 2)
    c = tp.generate(pair.tm, labels, torch.Generator().manual_seed(4), (3, 4), 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < K
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip_is_bit_exact_and_the_flat_orders_agree(arch):
    pair = Pair(seed=13, n_experts=ARCHS[arch])
    back = convert.module_to_flax(pair.tm)
    assert set(back) == {"params"}
    for path, leaf in jax.tree_util.tree_leaves_with_path(pair.variables["params"]):
        got = back["params"]
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, leaf, err_msg=jax.tree_util.keystr(path))
    assert back["params"]["bos"].shape == (DIM,)
    assert back["params"]["block_1"]["ln2"]["scale"].shape == (DIM,)
    if ARCHS[arch]:
        moe = back["params"]["block_1"]["moe"]
        assert moe["w_in"].shape == (2, DIM, 4 * DIM) and moe["w_out"].shape == (2, 4 * DIM, DIM)
        assert moe["router"]["kernel"].shape == (DIM, 2)
        assert "mlp_in" not in back["params"]["block_1"]
    # a moment or EMA vector in JAX's ravel order maps onto the port's
    # flat buffer and back exactly
    _, tcfg = _cfgs()
    state = train_state.create_train_state(pair.tm, tcfg.train)
    # every parameter, the 3-D expert weights too, is a 16-byte-aligned view
    assert all(p.data_ptr() % 16 == 0 for p in pair.tm.parameters())
    params = pair.variables["params"]
    n = ravel_pytree(params)[0].size  # the flat buffer pads between views
    jflat = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    port = convert.flax_flat_to_port(jflat, params, state.flat.names)
    np.testing.assert_array_equal(convert.port_flat_to_flax(port, pair.tm, state.flat), jflat)
    np.testing.assert_array_equal(
        convert.port_flat_to_flax(state.flat.flat, pair.tm, state.flat),
        np.asarray(ravel_pytree(params)[0]))


def test_unsupported_configurations_raise():
    pair = Pair(seed=14)
    codes = torch.zeros(1, 65, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="exceeds positional tables"):
        pair.tm(codes, torch.zeros(1, dtype=torch.int32))
    # switch-MoE feed-forwards run: logits and one load-balance term a block
    routed = TransformerPrior(K, DIM, LAYERS, HEADS, CLASSES, n_experts=4)
    logits, aux = routed(torch.zeros(1, 2, 3, dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32), return_moe_aux=True)
    assert logits.shape == (1, 2, 3, K) and len(aux) == LAYERS
    assert all(bool(torch.isfinite(a)) for a in aux)
    # spatial conditioning runs (tests/test_torch_hier_prior.py) given its width
    with pytest.raises(ValueError, match="cond_dim"):
        TransformerPrior(K, DIM, LAYERS, HEADS, CLASSES, spatial_cond=True)
    assert TransformerPrior(K, DIM, LAYERS, HEADS, CLASSES, spatial_cond=True,
                            cond_dim=8).cond_proj.weight.shape == (DIM, 8)
    with pytest.raises(ValueError, match="divisible"):
        TransformerPrior(K, DIM, LAYERS, 3, CLASSES)

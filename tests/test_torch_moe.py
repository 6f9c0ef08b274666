"""The port's switch-routed MoE feed-forward (``models/moe.py``) held against
the JAX package's ``SwitchMoE`` on the CPU, with weights converted from the
JAX module through ``convert.py`` and seeded numpy inputs: dim 16, 2-4
experts, sequences of 24 tokens (the 4 x 6 grids of the JAX package's own
``tests/test_moe.py``).

Tolerances, with their reasons (float32 products summed in another order,
about 1e-7 relative per operation):
  * outputs 1e-5 absolute, the load-balance term 1e-6 relative, with 0
    routing differences: the inputs are not near ties (their top-2 router
    probabilities differ by far more than the sums' rounding);
  * gradients of nll + 0.01 * aux 1e-5 of each leaf's largest gradient;
  * the cached ``step`` chained over T against ``forward`` 1e-5 absolute;
  * a fresh expert weight's standard deviation within 5% of flax's
    LeCun-normal scale, 1/sqrt(E * fan) (8,192 or more draws: about 1%
    sampling error).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from neural_sound_generation_tpu.models import moe as jmoe
from neural_sound_generation_tpu.models import transformer_prior as jtp
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import TransformerPrior
from neural_sound_generation_tpu_torch.models.moe import SwitchMoE
from neural_sound_generation_tpu_torch.training import losses, train_state, trainer

torch.set_num_threads(1)

D, B, T = 16, 3, 24
K, CLASSES = 16, 4


def _pair(e, cf, seed=0, mlp_ratio=4):
    """(JAX module, numpy params, port module, input h (B, T, D))."""
    h = np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)
    jm = jmoe.SwitchMoE(dim=D, n_experts=e, mlp_ratio=mlp_ratio, capacity_factor=cf)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(seed), jnp.asarray(h))["params"])
    tm = SwitchMoE(D, e, mlp_ratio, cf)
    tm.load_state_dict(convert.flax_to_state_dict({"params": params}))
    return jm, params, tm, h


def _jax_forward(jm, params, h):
    y, muts = jm.apply({"params": params}, jnp.asarray(h), mutable=["moe_losses"])
    (aux,) = jax.tree_util.tree_leaves(muts["moe_losses"])
    _, expert, _ = jm.apply({"params": params}, jnp.asarray(h), method=jmoe.SwitchMoE._route)
    return np.asarray(y), float(aux), np.asarray(expert)


@pytest.mark.parametrize("e,cf", [(2, 1.25), (4, 1.25), (4, 0.5)])
def test_forward_and_load_balance_match_jax(e, cf):
    jm, params, tm, h = _pair(e, cf)
    want, jaux, jexpert = _jax_forward(jm, params, h)
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(h))
        _, expert, _, _, keep = tm.dispatch(torch.from_numpy(h))
    assert int((expert.numpy() != jexpert).sum()) == 0  # routing decisions
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), jaux, rtol=1e-6)
    # dropped tokens give exactly zero, the kept ones do not
    norms = np.linalg.norm(got.numpy(), axis=-1)
    assert (norms[~keep.numpy()] == 0).all() and (norms[keep.numpy()] > 0).all()
    if cf < 1:
        assert int((~keep).sum()) >= B * (T - e * tm.capacity(T))


def test_single_expert_equals_the_dense_gelu_mlp():
    """E = 1 with room for every token: gate 1, the plain MLP."""
    _, params, tm, h = _pair(1, 2.0)
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(h))
    x = torch.from_numpy(h)
    want = torch.nn.functional.gelu(x @ tm.w_in[0] + tm.b_in[0], approximate="tanh")
    want = want @ tm.w_out[0] + tm.b_out[0]
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), atol=1e-6)
    assert float(aux) == pytest.approx(1.0)


def test_forced_drops_at_capacity_one():
    """A router bias of +-100 sends every token to expert 0, whose capacity
    is 1: the first token of each row gets an output, the rest give zero."""
    _, _, tm, h = _pair(2, 0.01)
    assert tm.capacity(6) == 1
    with torch.no_grad():
        tm.router.bias.copy_(torch.tensor([100.0, -100.0]))
        got, _ = tm(torch.from_numpy(h[:, :6]))
    norms = np.linalg.norm(got.numpy(), axis=-1)
    assert (norms[:, 0] > 1e-6).all()
    assert (norms[:, 1:] == 0).all()


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_step_chained_over_t_equals_forward(cf):
    """The cached form counts dispatched tokens per row and drops at the
    full sequence's capacity: chained over T it equals the forward, drops
    included (at 0.5 every row drops tokens)."""
    _, _, tm, h = _pair(4, cf, seed=1)
    x = torch.from_numpy(h)
    counts = torch.zeros(B, 4, dtype=torch.int32)
    with torch.no_grad():
        want, _ = tm(x)
        got = torch.stack([tm.step(x[:, t], counts, tm.capacity(T)) for t in range(T)], 1)
        keep = tm.dispatch(x)[-1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert counts.sum(1).tolist() == keep.sum(1).tolist()
    assert int(counts.max()) <= tm.capacity(T)
    if cf < 1:
        assert bool((~keep).any(1).all())


def test_fresh_experts_have_flax_lecun_scale():
    """flax's lecun_normal on (E, D, F) counts E as a receptive field:
    std 1/sqrt(E * D) for w_in and 1/sqrt(E * F) for w_out."""
    e, d, f = 4, 64, 256
    model = TransformerPrior(K, d, 1, 1, CLASSES, n_experts=e,
                             generator=torch.Generator().manual_seed(0))
    moe = model.block_0.moe
    for w, fan in ((moe.w_in, e * d), (moe.w_out, e * f)):
        w = w.detach()
        assert float(w.std()) == pytest.approx(fan**-0.5, rel=0.05)
        assert float(w.abs().max()) <= 2 * fan**-0.5 / 0.87962566103423978 + 1e-7
    assert not moe.b_in.detach().any() and not moe.b_out.detach().any()
    # the router is an ordinary Dense: fan-in D
    assert float(moe.router.weight.detach().std()) == pytest.approx(d**-0.5, rel=0.2)


def _prior_pair(n_experts, seed=0, b=16):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, K, (b, 4, 6)).astype(np.int32)
    labels = (np.arange(b) % CLASSES).astype(np.int32)
    jm = jtp.TransformerPrior(input_dim=K, dim=D, n_layers=2, n_heads=2, n_classes=CLASSES,
                              n_experts=n_experts, max_rows=8, max_cols=8)
    params = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(seed), jnp.asarray(codes), jnp.asarray(labels))["params"])
    tm = TransformerPrior(K, D, 2, 2, CLASSES, n_experts=n_experts, max_rows=8, max_cols=8)
    tm.load_state_dict(convert.flax_to_state_dict({"params": params}))
    return jm, params, tm, codes, labels


def test_gradients_of_nll_and_load_balance_match_jax_grad():
    """Every leaf, the router's included, against ``jax.grad`` of the JAX
    prior loss (nll + 0.01 * mean aux); every expert's w_in gets gradient.
    The router learns only through the gate and the aux term's mean
    probabilities."""
    jm, params, tm, codes, labels = _prior_pair(4)
    batch = {"codes": jnp.asarray(codes), "labels": jnp.asarray(labels)}
    (jloss, (jmetrics, _, _)), jgrads = jax.value_and_grad(
        jtrainer._pixelcnn_loss_fn(jm), has_aux=True)(params, {}, batch, None)
    logits, aux = tm(torch.from_numpy(codes), torch.from_numpy(labels), return_moe_aux=True)
    total, metrics = losses.prior_nll(logits, torch.from_numpy(codes), aux)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jloss), rtol=1e-6)
    for k in ("loss", "nll_per_code", "moe_load_balance"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-6,
                                   err_msg=k)
    grads = convert.module_to_flax(tm, {n: p.grad for n, p in tm.named_parameters()})["params"]
    for path, want in jax.tree_util.tree_leaves_with_path(jgrads):
        got = grads
        for p in path:
            got = got[p.key]
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    for i in range(2):
        w_in = grads[f"block_{i}"]["moe"]["w_in"]
        assert (np.abs(w_in).reshape(4, -1).max(1) > 0).all()
        assert np.abs(grads[f"block_{i}"]["moe"]["router"]["kernel"]).max() > 0
    # the routed tree ravels in JAX's order
    want = np.asarray(ravel_pytree(jgrads)[0])
    np.testing.assert_allclose(convert.ravel_flax(grads), want, atol=1e-5 * np.abs(want).max())


def test_eval_step_reports_the_nll_alone():
    """As in JAX, whose eval apply sows nowhere: no load-balance term."""
    _, _, tm, codes, labels = _prior_pair(2, seed=3)
    cfg = Config()
    state = train_state.create_train_state(tm, cfg.train)
    batch = {"codes": torch.from_numpy(codes), "labels": torch.from_numpy(labels)}
    logits, metrics = trainer.make_eval_step(tm, cfg)(state, batch)
    assert sorted(metrics) == ["loss", "nll_per_code"]
    assert torch.equal(metrics["loss"], losses.prior_nll(logits, batch["codes"])[0])


def test_routed_prior_trains_through_the_trainer():
    """The port's counterpart of the JAX ``test_moe_prior_trains_through_
    trainer``: the epoch means carry a finite load-balance term and the
    NLL falls."""
    import dataclasses

    _, _, tm, codes, labels = _prior_pair(4, seed=5, b=8)
    cfg = Config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, initial_learning_rate=3e-3, batch_size=8))
    state = train_state.create_train_state(tm, cfg.train)
    t = trainer.Trainer(tm, cfg, state, log_fn=None)
    batch = {"codes": torch.from_numpy(codes), "labels": torch.from_numpy(labels)}
    first = t.train_epoch([batch] * 4, epoch=0)
    assert np.isfinite(first["moe_load_balance"])
    for ep in range(1, 6):
        means = t.train_epoch([batch] * 4, epoch=ep)
    assert means["loss"] < 0.9 * first["loss"], (first, means)

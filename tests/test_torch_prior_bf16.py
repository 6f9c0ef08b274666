"""The port's priors in bfloat16 (``cli.prior --bf16``) held against the JAX
package's modules built with ``dtype=jnp.bfloat16`` on the CPU, with the same
float32 weights (through the bridge, perturbed so that every bias takes
part), seeded numpy codes, labels and conditioning maps: the transformer at
dim 32, 2 heads, 2 layers, 64 codes, dense and with 2 routed experts, on
4 x 5 grids; the PixelCNN at dim 16, 3 layers, 32 codes, plain and
spatially conditioned (8 channels), on 5 x 6 grids.

The port rounds where flax rounds: measured with XLA's excess precision
off (``XLA_FLAGS=--xla_allow_excess_precision=false``), the port's stock
attention forward, its KV-cached and row-cached logits and its PixelCNN
forward equal the JAX functions bit for bit. The JAX package's eager
forward (``model.apply`` outside ``jit``) rounds every operation; under
``jit`` (its samplers, ``incremental_logits``, the train step) XLA keeps
bf16 intermediates in float32 where it fuses them, which moves logits by a
bf16 ulp or more.

Tolerances, with their reasons:
  * the bf16 layers (``layers.gelu``, ``layers.sigmoid``, ``layers.Linear``)
    against ``jax.nn.gelu``, ``jax.nn.sigmoid`` and flax's bf16 ``Dense``:
    bit-equal (PyTorch's one-rounding functions measured 45%, 32% and 26%
    of outputs apart);
  * bf16 logits: within BF16_REL = 2e-2 of the largest magnitude (the JAX
    package's own bound between its bf16 cached and parallel paths,
    ``tests/test_models.py:393-395``), and at least ULP_SHARE = 99% of
    elements within one bf16 ulp where the rounding points are the same:
    the PixelCNN forward (measured 100%, bit-equal), the transformer through
    the stock attention path (100%, bit-equal), the port's KV-cached logits
    against the JAX eager forward (99.66-100%; LayerNorm's float32
    statistics, summed otherwise, flip a rounding now and then) and the
    row-cached logits against JAX's (100%, within 2.7e-3);
  * the transformer forward through the plain pair (the kernel's CPU
    version, which rounds the unnormalised P to bf16 where XLA's path
    rounds the normalised one): 2e-2 (measured <= 1.0e-2), and at least
    PAIR_ULP_SHARE = 60% of elements within one ulp (measured 68-74%);
  * the jitted JAX functions (excess precision): 2e-2 (the cached logits
    measured <= 9.8e-3, 41-53% within one ulp);
  * one bf16 train step against JAX's jitted step (whose excess precision
    moves the bf16 gradients): the NLL and the load-balance term 2e-3
    relative (measured <= 2.6e-4), grad_norm 5e-3 (measured <= 9.1e-4);
    parameters and the EMA within 5e-5 absolute and 99.9% of parameters
    within 1e-5 (one Adam step of lr 1e-3 from warm moments moves a
    parameter by up to 1e-3, about 9e-5 at the median; measured at most
    2.2e-5 apart, 0.018% of them beyond 1e-5, where a small warm second
    moment magnifies a gradient's difference);
  * routing decisions: equal at every token when the rounding points are
    the same (the stock path); through the plain pair a flip only where the
    JAX router's top-2 probabilities are within ROUTE_GAP = 1e-2 (bf16
    inputs one ulp apart), or in an earlier flip's causal cascade (measured:
    0 flips of 320 decisions).
"""

import contextlib

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from neural_sound_generation_tpu.models import moe as jmoe
from neural_sound_generation_tpu.models import pixelcnn as jpc
from neural_sound_generation_tpu.models import transformer_prior as jtp
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.models import GatedPixelCNN, TransformerPrior
from neural_sound_generation_tpu_torch.models import layers
from neural_sound_generation_tpu_torch.models import pixelcnn as tpc
from neural_sound_generation_tpu_torch.models import transformer_prior as tp
from neural_sound_generation_tpu_torch.models.moe import SwitchMoE
from neural_sound_generation_tpu_torch.ops import attention
from neural_sound_generation_tpu_torch.training import trainer
from torch_parity import TrainPair, cfgs, np_tree, perturb_params

torch.set_num_threads(1)

BF16 = torch.bfloat16
BF16_REL = 2e-2
ULP_SHARE = 0.99
PAIR_ULP_SHARE = 0.6
ROUTE_GAP = 1e-2
LOSS_REL, GNORM_REL = 2e-3, 5e-3
PARAM_ATOL, PARAM_NEAR, PARAM_NEAR_SHARE = 5e-5, 1e-5, 0.999

K, DIM, HEADS, LAYERS, CLASSES = 64, 32, 2, 2, 10
B, H, W = 3, 4, 5
PK, PDIM, PLAYERS, PCLASSES, COND = 32, 16, 3, 4, 8
PB, PH, PW = 2, 5, 6

#: the transformer cases: dense MLPs, or 2 routed experts
ARCHS = {"dense": 0, "moe": 2}


def ulp_share(got, want) -> float:
    """The share of elements of ``got`` within one bf16 ulp of ``want``."""
    mag = np.maximum(np.abs(want), np.float32(2.0**-126))
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return float((np.abs(got - want) <= ulp).mean())


def assert_bf16_close(got, want, share, err_msg=""):
    np.testing.assert_allclose(got, want, atol=BF16_REL * np.abs(want).max(), rtol=0,
                               err_msg=err_msg)
    measured = ulp_share(got, want)
    assert measured >= share, (err_msg, measured)
    return measured


@contextlib.contextmanager
def backend(name):
    attention.set_backend(name)
    try:
        yield
    finally:
        attention.set_backend("auto")


def _codes(seed, b=B, h=H, w=W, k=K, classes=CLASSES):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, k, (b, h, w)).astype(np.int32),
            rng.integers(0, classes, b).astype(np.int32))


class TPair:
    """The JAX transformer prior in bf16 and the port's, the same perturbed
    float32 weights."""

    def __init__(self, seed=0, n_experts=0):
        codes, labels = _codes(seed)
        self.jm = jtp.TransformerPrior(input_dim=K, dim=DIM, n_layers=LAYERS, n_heads=HEADS,
                                       n_classes=CLASSES, n_experts=n_experts,
                                       dtype=jnp.bfloat16)
        v = self.jm.init(jax.random.PRNGKey(seed), jnp.asarray(codes), jnp.asarray(labels))
        self.variables = perturb_params({"params": np_tree(v["params"])}, seed + 1, scale=0.05)
        self.tm = TransformerPrior(K, DIM, LAYERS, HEADS, CLASSES, n_experts=n_experts,
                                   dtype=BF16)
        self.tm.load_state_dict(convert.flax_to_state_dict(self.variables))

    def jlogits(self, codes, labels):
        return np.asarray(self.jm.apply(self.variables, jnp.asarray(codes), jnp.asarray(labels)))

    def tlogits(self, codes, labels):
        with torch.no_grad():
            return self.tm(torch.from_numpy(codes), torch.from_numpy(labels)).numpy()


class PPair:
    """The JAX PixelCNN in bf16 and the port's, the same perturbed weights."""

    def __init__(self, spatial=False, seed=0):
        self.spatial = spatial
        codes, labels, cond = self.inputs(seed)
        self.jm = jpc.GatedPixelCNN(input_dim=PK, dim=PDIM, n_layers=PLAYERS,
                                    n_classes=PCLASSES, spatial_cond=spatial,
                                    dtype=jnp.bfloat16)
        v = self.jm.init(jax.random.PRNGKey(seed), *self.jargs(codes, labels, cond))
        self.variables = perturb_params(np_tree(v), seed + 1, scale=0.05)
        self.jvars = jax.tree_util.tree_map(jnp.asarray, self.variables)
        self.tm = GatedPixelCNN(PK, PDIM, PLAYERS, PCLASSES, spatial_cond=spatial,
                                cond_dim=COND if spatial else 0, dtype=BF16)
        self.tm.load_state_dict(convert.flax_to_state_dict(self.variables, self.tm))

    def inputs(self, seed):
        codes, labels = _codes(seed, PB, PH, PW, PK, PCLASSES)
        rng = np.random.default_rng(seed + 100)
        cond = rng.standard_normal((PB, PH, PW, COND)).astype(np.float32) if self.spatial else None
        return codes, labels, cond

    def jargs(self, codes, labels, cond):
        return (jnp.asarray(codes), jnp.asarray(labels)) + (
            (jnp.asarray(cond),) if self.spatial else ())

    def targs(self, codes, labels, cond):
        return (torch.from_numpy(codes), torch.from_numpy(labels),
                None if cond is None else torch.from_numpy(cond))


# ---------------------------------------------------------------------------
# The rounding points
# ---------------------------------------------------------------------------


def test_bf16_layers_round_where_flax_rounds():
    """``layers.gelu`` and ``layers.sigmoid`` equal ``jax.nn.gelu`` and
    ``jax.nn.sigmoid`` on bf16 inputs bit for bit, and ``layers.Linear``
    equals flax's ``Dense(dtype=bfloat16)``; PyTorch's one-rounding
    ``F.gelu``, ``torch.sigmoid`` and bias-folding bf16 ``F.linear`` do not
    (the shares are their measured disagreement)."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(2 * rng.standard_normal(100_000).astype(np.float32)).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16)

    def apart(got, want):
        return float((got.float().numpy() != np.asarray(want.astype(jnp.float32))).mean())

    assert apart(layers.gelu(t), jax.nn.gelu(x)) == 0
    assert apart(layers.sigmoid(t), jax.nn.sigmoid(x)) == 0
    assert apart(torch.nn.functional.gelu(t, approximate="tanh"), jax.nn.gelu(x)) > 0.4
    assert apart(torch.sigmoid(t), jax.nn.sigmoid(x)) > 0.25
    h = rng.standard_normal((64, 96)).astype(np.float32)
    dense = nn.Dense(128, dtype=jnp.bfloat16)
    params = perturb_params(np_tree(dense.init(jax.random.PRNGKey(0), h)), 1, scale=0.1)
    want = dense.apply(params, h)
    lin = layers.Linear(96, 128, dtype=BF16)
    lin.load_state_dict(convert.flax_to_state_dict(params))
    with torch.no_grad():
        got = lin(torch.from_numpy(h))
        folded = torch.nn.functional.linear(torch.from_numpy(h).to(BF16), lin.weight.to(BF16),
                                            lin.bias.to(BF16))
    assert got.dtype == BF16 and apart(got, want) == 0
    assert apart(folded, want) > 0.1


# ---------------------------------------------------------------------------
# The transformer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_forward_matches_jax(arch):
    """Through the plain pair (the default backend's CPU path) within
    2e-2, and through the stock path, which rounds where JAX's XLA path
    rounds, at 99% of elements within one ulp (bit-equal when measured)."""
    pair = TPair(n_experts=ARCHS[arch])
    codes, labels = _codes(1)
    want = pair.jlogits(codes, labels)
    got = pair.tlogits(codes, labels)
    assert got.dtype == np.float32 and got.shape == (B, H, W, K)
    assert all(p.dtype == torch.float32 for p in pair.tm.parameters())
    assert_bf16_close(got, want, PAIR_ULP_SHARE, "plain pair")
    with backend("xla"):
        stock = pair.tlogits(codes, labels)
    assert_bf16_close(stock, want, ULP_SHARE, "stock path")
    # bf16 is not float32: the same weights in float32 sit far outside 1 ulp
    f32 = TransformerPrior(K, DIM, LAYERS, HEADS, CLASSES, n_experts=ARCHS[arch])
    f32.load_state_dict(pair.tm.state_dict())
    with torch.no_grad():
        full = f32(torch.from_numpy(codes), torch.from_numpy(labels)).numpy()
    assert ulp_share(full, want) < 0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_cached_logits_match_jax(arch):
    """The KV-cached decode in bf16 (caches in bf16, the weights rounded to
    bf16, P V summed in float32) against JAX's eager forward, which rounds
    at the same points (99% within one ulp), and against JAX's jitted
    ``incremental_logits`` (2e-2: XLA's excess precision)."""
    pair = TPair(seed=2, n_experts=ARCHS[arch])
    codes, labels = _codes(3)
    tc, tl = torch.from_numpy(codes), torch.from_numpy(labels)
    caches = tp.init_caches(pair.tm, B, H * W)
    assert all(c.dtype == BF16 for blk in caches for c in blk[:2])
    inc = tp.incremental_logits(pair.tm, tc, tl).numpy()
    assert_bf16_close(inc, pair.jlogits(codes, labels), ULP_SHARE, "vs JAX eager forward")
    jinc = np.asarray(jtp.incremental_logits(pair.jm, pair.variables, jnp.asarray(codes),
                                             jnp.asarray(labels)))
    assert_bf16_close(inc, jinc, 0.0, "vs JAX incremental_logits")
    with backend("xla"):
        assert_bf16_close(inc, pair.tlogits(codes, labels), ULP_SHARE, "vs the stock forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_bf16_sampler_draws_the_jax_codes(arch):
    """The KV-cached sampler with bf16 caches (the JAX regression of
    ``tests/test_transformer_prior.py:143``), on JAX's Gumbel noise: the
    codes of JAX's ``generate`` except where its draw's two best perturbed
    logits lie within the bf16 logits' tolerance."""
    pair = TPair(seed=4, n_experts=ARCHS[arch])
    labels = np.array([0, 3, 7], np.int32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jtp.generate(pair.jm, pair.variables, jnp.asarray(labels), key,
                                   shape=(H, W), batch_size=B))
    gumbel = np.stack([np.asarray(jax.random.gumbel(jax.random.fold_in(key, t), (B, K)))
                       for t in range(H * W)])
    got = tp.generate(pair.tm, torch.from_numpy(labels), shape=(H, W), batch_size=B,
                      gumbel=torch.from_numpy(gumbel)).numpy()
    assert got.dtype == np.int32 and got.shape == (B, H, W)
    logits = pair.jlogits(want, labels).reshape(B, -1, K)
    gap = BF16_REL * np.abs(logits).max()
    for b in range(B):
        diff = np.flatnonzero(got[b].reshape(-1) != want[b].reshape(-1))
        if len(diff):
            t = diff[0]
            top2 = np.sort(logits[b, t] + gumbel[t, b])[-2:]
            assert top2[1] - top2[0] <= gap, (b, t, top2)


def _jax_routes(jm, variables, codes, labels):
    """The JAX model's routing decisions per routed block, from the
    activation each ``SwitchMoE`` receives in the eager forward."""
    routes = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jmoe.SwitchMoE) and context.method_name == "__call__":
            probs, expert, _ = context.module._route(args[0])
            routes.append((np.asarray(probs), np.asarray(expert)))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(record):
        jm.apply(variables, jnp.asarray(codes), jnp.asarray(labels))
    return routes


def _port_routes(tm, codes, labels):
    routes = []

    def hook(moe, args, out):
        routes.append(moe.dispatch(args[0])[1].numpy())

    handles = [m.register_forward_hook(hook) for m in tm.modules() if isinstance(m, SwitchMoE)]
    with torch.no_grad():
        tm(torch.from_numpy(codes), torch.from_numpy(labels))
    for h in handles:
        h.remove()
    return routes


def test_routing_decisions_match_jax():
    """Every routed block's decisions (the router in float32 on the
    bf16-rounded activation): equal at every token through the stock path,
    and through the plain pair a flip only at a near-tie or in a flip's
    causal cascade. Decisions are counted."""
    pair = TPair(seed=6, n_experts=ARCHS["moe"])
    codes, labels = _codes(7, b=8)
    jroutes = _jax_routes(pair.jm, pair.variables, codes, labels)
    assert len(jroutes) == LAYERS
    with backend("xla"):
        stock = _port_routes(pair.tm, codes, labels)
    for (_, jexpert), expert in zip(jroutes, stock):
        np.testing.assert_array_equal(expert, jexpert)
    t_len = H * W
    first = np.full(len(codes), t_len)
    decisions = flips = 0
    for (probs, jexpert), expert in zip(jroutes, _port_routes(pair.tm, codes, labels)):
        decisions += jexpert.size
        top2 = np.sort(probs, axis=-1)[..., -2:]
        for b, t in np.argwhere(expert != jexpert):
            flips += 1
            assert t >= first[b] or top2[b, t, 1] - top2[b, t, 0] <= ROUTE_GAP, (b, t, top2[b, t])
        flipped = np.where(expert != jexpert, np.arange(t_len), t_len).min(axis=1)
        first = np.minimum(first, flipped)
    assert decisions == LAYERS * 8 * t_len and flips <= decisions // 20


# ---------------------------------------------------------------------------
# The PixelCNN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spatial", [False, True])
def test_pixelcnn_forward_matches_jax(spatial):
    """The whole stream in bf16 after the embedding: bit-equal to JAX's when
    measured (99% within one ulp held)."""
    pair = PPair(spatial)
    codes, labels, cond = pair.inputs(1)
    want = np.asarray(pair.jm.apply(pair.jvars, *pair.jargs(codes, labels, cond)))
    with torch.no_grad():
        got = pair.tm(*pair.targs(codes, labels, cond)).numpy()
    assert got.dtype == np.float32 and got.shape == (PB, PH, PW, PK)
    assert_bf16_close(got, want, ULP_SHARE)


@pytest.mark.parametrize("spatial", [False, True])
def test_pixelcnn_row_cached_logits_match_jax(spatial):
    """The row-cached path casts every weight and the conditioning map once
    (the JAX regression of ``tests/test_models.py:404``): within one ulp of
    JAX's row-cached logits at 99% of elements, and within 2e-2 of the
    parallel forward (its taps as matrix products sum in another order)."""
    pair = PPair(spatial, seed=2)
    codes, labels, cond = pair.inputs(3)
    inc = tpc.incremental_logits(pair.tm, *pair.targs(codes, labels, cond)).numpy()
    jinc = np.asarray(jpc.incremental_logits(pair.jm, pair.jvars,
                                             *pair.jargs(codes, labels, cond)))
    assert_bf16_close(inc, jinc, ULP_SHARE, "vs JAX incremental_logits")
    with torch.no_grad():
        forward = pair.tm(*pair.targs(codes, labels, cond)).numpy()
    assert_bf16_close(inc, forward, 0.0, "vs the forward")


@pytest.mark.parametrize("spatial", [False, True])
def test_pixelcnn_bf16_fast_sampler_runs(spatial):
    """``fast_generate`` in bf16, spatially conditioned too, from a
    generator: valid codes, and the same codes as teacher forcing its own
    draws through the row-cached path would give."""
    pair = PPair(spatial, seed=4)
    _, labels, cond = pair.inputs(5)
    out = tpc.fast_generate(pair.tm, torch.from_numpy(labels), torch.Generator().manual_seed(0),
                            shape=(PH, PW), batch_size=PB,
                            cond_map=None if cond is None else torch.from_numpy(cond))
    assert out.dtype == torch.int32 and tuple(out.shape) == (PB, PH, PW)
    assert int(out.min()) >= 0 and int(out.max()) < PK


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------


def _step_case(case):
    """(JAX module, variables, port module, numpy batch) of one family."""
    if case in ARCHS:
        pair = TPair(seed=8, n_experts=ARCHS[case])
        codes, labels = _codes(9)
        return pair.jm, pair.variables, pair.tm, {"codes": codes, "labels": labels}
    pair = PPair(spatial=case == "pixelcnn_spatial", seed=8)
    codes, labels, cond = pair.inputs(9)
    batch = {"codes": codes, "labels": labels}
    if cond is not None:
        batch["cond"] = cond
    return pair.jm, pair.variables, pair.tm, batch


@pytest.mark.parametrize("case", [*ARCHS, "pixelcnn", "pixelcnn_spatial"])
def test_bf16_train_step_matches_jax(case):
    """One step of the ``Trainer``'s fused step from warm moments against
    JAX's jitted step: float32 logits reach the loss, the routed aux term is
    float32, the gradients land in the float32 flat buffer and kernel 3's
    update (its plain version on the CPU) moves float32 parameters."""
    jm, variables, tm, batch = _step_case(case)
    jcfg, tcfg = cfgs()
    pair = TrainPair(jm, variables, tm, jcfg, tcfg, seed=10)
    jstate, jmetrics = jtrainer.make_train_step(jm, jcfg, donate=False)(
        pair.jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    logits = []
    handle = tm.register_forward_hook(lambda m, args, out: logits.append(out))
    _, tmetrics = trainer.make_train_step(tm, tcfg)(
        pair.tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    handle.remove()
    out = logits[0][0] if isinstance(logits[0], tuple) else logits[0]
    assert out.dtype == torch.float32
    assert set(tmetrics) == set(jmetrics)
    for k in tmetrics:
        assert tmetrics[k].dtype == torch.float32, k
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=GNORM_REL if k == "grad_norm" else LOSS_REL, err_msg=k)
    ts = pair.tstate
    assert ts.flat.flat.dtype == ts.flat.grad.dtype == torch.float32
    params = pair.to_jax_order(ts.flat.flat)
    moved = np.abs(params - np.asarray(ravel_pytree(variables["params"])[0])).max()
    assert moved > 10 * PARAM_ATOL  # the step moved the parameters
    want = np.asarray(ravel_pytree(jstate.params)[0])
    np.testing.assert_allclose(params, want, atol=PARAM_ATOL)
    assert (np.abs(params - want) <= PARAM_NEAR).mean() >= PARAM_NEAR_SHARE
    np.testing.assert_allclose(pair.to_jax_order(ts.ema_params), np.asarray(jstate.ema_params),
                               atol=PARAM_ATOL)
    assert int(ts.step) == int(jstate.step)

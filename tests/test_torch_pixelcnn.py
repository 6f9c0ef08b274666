"""The port's GatedPixelCNN held against the JAX package on the CPU, with the
same weights (through the bridge), codes, labels and conditioning maps:
dim 16, 3 layers, 32 codes, 4 classes, a non-square 5 x 6 grid, and
conditioning maps of 8 channels for the spatially conditioned model.

Tolerances, with their reasons (float32 convolutions and matrix products
summed in another order, about 1e-7 relative per operation):
  * logits, parallel and row-cached, 1e-5 absolute (JAX's own limit for its
    row-cached path, tests/test_models.py:355-356);
  * sampled codes equal, except where the top two Gumbel-perturbed logits
    of the JAX draw differ by less than 1e-5 (a near-tie may go either way);
  * one train step: the NLL 1e-5 relative, grad_norm 1e-4 relative,
    gradients 2e-4 of the largest, parameters and the EMA 2e-5 absolute,
    Adam moments 1e-3 of the vector's largest (``tests/torch_parity.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.models import pixelcnn as jpc
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.models import GatedPixelCNN
from neural_sound_generation_tpu_torch.models import pixelcnn as tpc
from neural_sound_generation_tpu_torch.training import losses, train_state, trainer
from torch_parity import (
    TrainPair,
    assert_metrics,
    assert_round_trip,
    cfgs,
    np_tree,
    perturb_params,
)

torch.set_num_threads(1)

K, DIM, LAYERS, CLASSES, COND = 32, 16, 3, 4, 8
B, H, W = 2, 5, 6
LOGIT_ATOL = 1e-5
TIE_GAP = 1e-5


def _inputs(seed, spatial, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, K, (b, h, w)).astype(np.int32)
    labels = rng.integers(0, CLASSES, b).astype(np.int32)
    cond = rng.standard_normal((b, h, w, COND)).astype(np.float32) if spatial else None
    return codes, labels, cond


class Pair:
    """The JAX PixelCNN (perturbed weights: nonzero biases take part) and
    the port's with the same weights."""

    def __init__(self, spatial=False, seed=0):
        self.spatial = spatial
        codes, labels, cond = _inputs(seed, spatial)
        self.jm = jpc.GatedPixelCNN(input_dim=K, dim=DIM, n_layers=LAYERS, n_classes=CLASSES,
                                    spatial_cond=spatial)
        v = self.jm.init(jax.random.PRNGKey(seed), *self._jargs(codes, labels, cond))
        self.variables = perturb_params(np_tree(v), seed + 1, scale=0.05)
        self.jvars = jax.tree_util.tree_map(jnp.asarray, self.variables)
        self.tm = GatedPixelCNN(K, DIM, LAYERS, CLASSES, spatial_cond=spatial,
                                cond_dim=COND if spatial else 0)
        self.tm.load_state_dict(convert.flax_to_state_dict(self.variables, self.tm))

    def _jargs(self, codes, labels, cond):
        return (jnp.asarray(codes), jnp.asarray(labels)) + (
            (jnp.asarray(cond),) if self.spatial else ())

    def jlogits(self, codes, labels, cond):
        return np.asarray(self.jm.apply(self.jvars, *self._jargs(codes, labels, cond)))

    def tlogits(self, codes, labels, cond):
        with torch.no_grad():
            return self.tm(*_torch(codes, labels, cond)).numpy()


def _torch(codes, labels, cond):
    return (torch.from_numpy(codes), torch.from_numpy(labels),
            None if cond is None else torch.from_numpy(cond))


def jax_gumbel(key, t_len, b, k=K):
    """The noise of the JAX samplers' draws: one ``split`` a pixel, raster
    order, ``categorical`` = argmax(logits + gumbel(sub))."""
    out = []
    for _ in range(t_len):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (b, k))))
    return np.stack(out)


def assert_same_draws(got, want, logits, gumbel):
    """Codes equal except where the JAX draw's perturbed logits are a
    near-tie; ``logits`` (B, H, W, K) are the teacher-forced logits of
    ``want``."""
    assert got.dtype == np.int32 and got.shape == want.shape
    w = want.shape[2]
    # the first difference of each sample; later pixels are conditioned on it
    for bi in range(want.shape[0]):
        diff = np.argwhere(got[bi] != want[bi])
        if len(diff):
            i, j = diff[0]
            top2 = np.sort(logits[bi, i, j] + gumbel[i * w + j, bi])[-2:]
            assert top2[1] - top2[0] < TIE_GAP, (bi, i, j, top2)


@pytest.mark.parametrize("spatial", [False, True])
def test_logits_match_the_jax_module(spatial):
    pair = Pair(spatial)
    codes, labels, cond = _inputs(1, spatial)
    got = pair.tlogits(codes, labels, cond)
    assert got.shape == (B, H, W, K) and got.dtype == np.float32
    np.testing.assert_allclose(got, pair.jlogits(codes, labels, cond), atol=LOGIT_ATOL)


@pytest.mark.parametrize("spatial", [False, True])
def test_causality(spatial):
    """The logits at (i, j) move with no code at or after (i, j) in raster
    order, and do move with one before it (JAX tests/test_models.py:163)."""
    pair = Pair(spatial, seed=2)
    codes, labels, cond = _inputs(3, spatial)
    base = pair.tlogits(codes, labels, cond)

    def flipped(ii, jj):
        x = codes.copy()
        x[:, ii, jj] = (x[:, ii, jj] + 7) % K
        return pair.tlogits(x, labels, cond)

    i, j = 2, 3
    for ii, jj in ((i, j), (i, j + 1), (i, W - 1), (i + 1, 0), (i + 1, j), (H - 1, W - 1)):
        after = flipped(ii, jj).reshape(B, H * W, K)
        np.testing.assert_array_equal(after[:, : ii * W + jj + 1],
                                      base.reshape(B, H * W, K)[:, : ii * W + jj + 1])
    for ii, jj in ((i, j - 1), (i - 1, j), (i - 1, W - 1)):
        assert not np.allclose(flipped(ii, jj)[:, i, j], base[:, i, j], atol=1e-6)


@pytest.mark.parametrize("spatial", [False, True])
def test_incremental_logits_match_the_forward_and_jax(spatial):
    pair = Pair(spatial, seed=4)
    codes, labels, cond = _inputs(5, spatial)
    inc = tpc.incremental_logits(pair.tm, *_torch(codes, labels, cond)).numpy()
    np.testing.assert_allclose(inc, pair.tlogits(codes, labels, cond), atol=LOGIT_ATOL)
    jinc = np.asarray(jpc.incremental_logits(
        pair.jm, pair.jvars, jnp.asarray(codes), jnp.asarray(labels),
        None if cond is None else jnp.asarray(cond)))
    np.testing.assert_allclose(inc, jinc, atol=LOGIT_ATOL)


@pytest.mark.parametrize("spatial,shape", [(False, (H, W)), (True, (4, 7))])
def test_fast_and_naive_sampling_draw_the_jax_codes(spatial, shape):
    """Both samplers, given the noise of JAX's key-split order, draw what
    ``jax fast_generate`` draws (flat, and spatially conditioned on a
    non-square grid)."""
    pair = Pair(spatial, seed=6)
    h, w = shape
    b = 3
    _, labels, cond = _inputs(7, spatial, b=b, h=h, w=w)
    key = jax.random.PRNGKey(8)
    jcond = None if cond is None else jnp.asarray(cond)
    want = np.asarray(jpc.fast_generate(pair.jm, pair.jvars, jnp.asarray(labels), key,
                                        shape=shape, batch_size=b, cond_map=jcond))
    gumbel = jax_gumbel(key, h * w, b)
    wlogits = pair.jlogits(want, labels, cond)
    tcond = None if cond is None else torch.from_numpy(cond)
    for sampler in (tpc.fast_generate, tpc.generate):
        got = sampler(pair.tm, torch.from_numpy(labels), shape=shape, batch_size=b,
                      cond_map=tcond, gumbel=torch.from_numpy(gumbel)).numpy()
        assert_same_draws(got, want, wlogits, gumbel)
    assert len(np.unique(want)) > 4  # the draws are not all one code


def test_generate_draws_from_a_generator_reproducibly():
    pair = Pair(seed=9)
    labels = torch.tensor([1, 2], dtype=torch.int32)

    def draw(fn, seed):
        return fn(pair.tm, labels, torch.Generator().manual_seed(seed), (3, 4), 2)

    a, b, c = (draw(tpc.fast_generate, s) for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(draw(tpc.generate, 3), a)  # one noise layout for both samplers
    assert int(a.min()) >= 0 and int(a.max()) < K


@pytest.mark.parametrize("spatial", [False, True])
def test_convert_round_trip_is_bit_exact(spatial):
    """The PixelCNN tree (raw HWIO kernels beside Embed and Conv leaves)
    comes back bit for bit, and a flat vector in JAX's ravel order maps
    through the port's flat order unchanged."""
    pair = Pair(spatial, seed=10)
    assert_round_trip(pair.variables, pair.tm)
    sd = pair.tm.state_dict()
    assert sd["layer_0.vert_kernel"].shape == (2 * DIM, DIM, 4, 7)
    assert sd["layer_1.horiz_kernel"].shape == (2 * DIM, DIM, 1, 2)
    assert not any("mask" in k for k in sd)  # the masks are constants, not state


@pytest.mark.parametrize("spatial", [False, True])
def test_train_step_matches_the_jax_trainer(spatial):
    """One fused step from warm moments against the JAX train step, whose
    loss is ``_pixelcnn_loss_fn``."""
    pair = Pair(spatial, seed=11)
    jcfg, tcfg = cfgs()
    tp = TrainPair(pair.jm, pair.variables, pair.tm, jcfg, tcfg, seed=11)
    codes, labels, cond = _inputs(12, spatial)
    batch = {"codes": codes, "labels": labels}
    if spatial:
        batch["cond"] = cond
    loss_fn = jtrainer._pixelcnn_loss_fn(pair.jm)
    (_, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        pair.jvars["params"], {}, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    jstate, jm = jtrainer.make_train_step(pair.jm, jcfg, donate=False)(
        tp.jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    _, tmetrics = trainer.make_train_step(pair.tm, tcfg)(
        tp.tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    tp.assert_grads_match(jgrads)
    assert_metrics(tmetrics, jm, ("loss", "nll_per_code"))
    tp.assert_states_match(jstate)


def test_masked_taps_move_by_weight_decay_alone():
    """The mask is applied on every forward, never written into the weights:
    the masked taps get zero gradient from the loss, and weight decay alone
    (added to the gradient before Adam, as in the JAX optimizer) shrinks
    them toward zero."""
    pair = Pair(seed=13)
    _, tcfg = cfgs()
    state = train_state.create_train_state(pair.tm, tcfg.train)
    layer0 = pair.tm.layer_0
    before = layer0.vert_kernel.detach().clone()
    codes, labels, _ = _inputs(14, False)
    trainer.make_train_step(pair.tm, tcfg)(
        state, {"codes": torch.from_numpy(codes), "labels": torch.from_numpy(labels)})
    assert torch.count_nonzero(layer0.vert_kernel.grad[:, :, -1]) == 0
    assert torch.count_nonzero(layer0.horiz_kernel.grad[..., -1]) == 0
    assert torch.count_nonzero(layer0.vert_kernel.grad[:, :, :-1]) > 0
    moved = layer0.vert_kernel.detach()[:, :, -1] - before[:, :, -1]
    assert torch.equal(torch.sign(moved), -torch.sign(before[:, :, -1]))


def test_eval_step_runs_on_the_ema_shadow():
    pair = Pair(spatial=True, seed=15)
    _, tcfg = cfgs()
    state = train_state.create_train_state(pair.tm, tcfg.train)
    with torch.no_grad():
        state.ema_params.mul_(0.5)
    codes, labels, cond = _torch(*_inputs(16, True))
    logits, metrics = trainer.make_eval_step(pair.tm, tcfg)(
        state, {"codes": codes, "labels": labels, "cond": cond})
    with state.flat.swapped(state.ema_params):
        want = pair.tm(codes, labels, cond)
    assert torch.equal(logits, want)
    assert torch.equal(metrics["loss"], losses.prior_nll(want, codes)[0])


def test_spatial_model_refuses_a_missing_map():
    pair = Pair(spatial=True, seed=17)
    codes, labels, _ = _torch(*_inputs(18, False))
    with pytest.raises(ValueError, match="cond_map"):
        pair.tm(codes, labels)
    with pytest.raises(ValueError, match="cond_dim"):
        GatedPixelCNN(K, DIM, LAYERS, CLASSES, spatial_cond=True)

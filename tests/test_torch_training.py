"""The port's training path (losses, schedules, train state, train and eval
steps) held against the JAX package on the CPU, with the same weights (through
the bridge), the same batches and the same optimizer state.

Adam's first step moves each parameter by about lr * sign(g), so an element
whose gradient is at rounding-noise size could flip between frameworks and
move by 2 lr. The steps here start from warm moments (count 100, m and v
drawn so the step is a smooth function of the gradient) to keep every
element comparable; gradients are compared first.

Tolerances, with their reasons (float32 convolutions summed in another
order differ by about 1e-6 relative per layer at these widths):
  * loss terms 1e-5 relative; grad_norm 1e-4 relative;
  * gradients 2e-4 of the largest gradient, absolute;
  * parameters, the EMA and BatchNorm statistics 2e-5 absolute (updates are
    about 1e-3, values about 1);
  * Adam moments 1e-3 of the vector's largest magnitude, absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu.training import losses as jlosses
from neural_sound_generation_tpu.training import train_state as jts
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.ops import vq as vq_ops
from neural_sound_generation_tpu_torch.training import losses, train_state, trainer

torch.set_num_threads(1)

DIM, Z_DIM, B, FRAMES = 32, 64, 4, 16
COUNT = 100
LOSS_RTOL, GNORM_RTOL, GRAD_FRAC, PARAM_ATOL, MOMENT_FRAC = 1e-5, 1e-4, 2e-4, 2e-5, 1e-3

TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, ema_warmup=True,
             initial_learning_rate=1e-3)


def _cfgs(ema_codebook=False, num_quantizers=1, restart=0.0):
    model = dict(beta=0.25, dim=DIM, z_dim=Z_DIM, ema_codebook=ema_codebook,
                 restart_dead_threshold=restart, ema_codebook_decay=0.9,
                 num_quantizers=num_quantizers)
    out = []
    for base in (JaxConfig(), Config()):
        out.append(dataclasses.replace(
            base, train=dataclasses.replace(base.train, **TRAIN),
            model=dataclasses.replace(base.model, **model)))
    return out


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, B, 80, FRAMES, 1)).astype(np.float32)


class Pair:
    """A JAX train state and the port's, with the same weights, batch
    statistics, warm moments and EMA shadow; ``num_quantizers`` residual-VQ
    stages, bf16 compute under ``bf16``."""

    def __init__(self, ema_codebook=False, seed=0, num_quantizers=1, bf16=False, restart=0.0):
        self.jcfg, self.tcfg = _cfgs(ema_codebook, num_quantizers, restart)
        rng = np.random.default_rng(seed)
        x0 = _batches(1, seed + 100)[0]
        self.jm = JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM, num_quantizers=num_quantizers,
                           dtype=jnp.bfloat16 if bf16 else jnp.float32)
        v = jax.tree_util.tree_map(
            np.asarray, self.jm.init(jax.random.PRNGKey(seed), jnp.asarray(x0[:1]), train=False))
        # a codebook drawn from train-mode encoder outputs: every code in use
        (_, z_e, _), _ = self.jm.apply(v, jnp.asarray(x0), train=True, mutable=["batch_stats"])
        ze = np.asarray(z_e).reshape(-1, DIM)
        if num_quantizers == 1:
            pick = rng.choice(ze.shape[0], Z_DIM, replace=False)
            v["params"]["codebook"] = ze[pick] + 0.05 * rng.standard_normal(
                (Z_DIM, DIM)).astype(np.float32)
        else:  # stage q from what stages < q leave
            books, residual = [], ze
            for _ in range(num_quantizers):
                pick = rng.choice(ze.shape[0], Z_DIM, replace=False)
                book = (residual[pick] + 0.05 * rng.standard_normal((Z_DIM, DIM))).astype(
                    np.float32)
                books.append(book)
                near = ((residual[:, None] - book[None]) ** 2).sum(-1).argmin(1)
                residual = residual - book[near]
            v["params"]["codebook"] = np.stack(books)
        self.variables = v
        flat_p = np.asarray(ravel_pytree(v["params"])[0])
        n = flat_p.size
        m0 = (1e-3 * rng.standard_normal(n)).astype(np.float32)
        v0 = rng.uniform(1e-6, 1e-5, n).astype(np.float32)
        ema0 = (flat_p + 0.01 * rng.standard_normal(n)).astype(np.float32)

        js = jts.create_train_state(v, self.jcfg.train, ema_codebook=ema_codebook)
        self.jstate = js.replace(
            step=jnp.asarray(COUNT, jnp.int32),
            opt_state=js.opt_state.replace(count=jnp.asarray(COUNT, jnp.int32),
                                           m=jnp.asarray(m0), v=jnp.asarray(v0)),
            ema_params=jnp.asarray(ema0),
        )

        self.tm = VQVAE(1, DIM, Z_DIM, num_quantizers=num_quantizers,
                        dtype=torch.bfloat16 if bf16 else torch.float32)
        self.tm.load_state_dict(convert.flax_to_state_dict(v))
        ts = train_state.create_train_state(self.tm, self.tcfg.train, ema_codebook=ema_codebook)
        names = ts.flat.names
        with torch.no_grad():
            ts.step.fill_(COUNT)
            ts.opt_state.count.fill_(COUNT)
            ts.opt_state.m.copy_(convert.flax_flat_to_port(m0, v["params"], names))
            ts.opt_state.v.copy_(convert.flax_flat_to_port(v0, v["params"], names))
            ts.ema_params.copy_(convert.flax_flat_to_port(ema0, v["params"], names))
        self.tstate = ts

    def to_jax_order(self, vector):
        return convert.port_flat_to_flax(vector, self.tm, self.tstate.flat)

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
        stats = convert.module_to_flax(self.tm)["batch_stats"]
        np.testing.assert_allclose(ravel_pytree(stats)[0],
                                   np.asarray(ravel_pytree(jstate.batch_stats)[0]),
                                   atol=PARAM_ATOL)
        assert int(ts.step) == int(jstate.step)
        assert int(ts.opt_state.count) == int(jstate.opt_state.count)


def _assert_metrics(tm, jm):
    for k in ("loss", "loss_recons", "loss_vq", "loss_commit", "train_loss"):
        np.testing.assert_allclose(np.asarray(tm[k]), np.asarray(jm[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(np.asarray(tm["grad_norm"]), np.asarray(jm["grad_norm"]),
                               rtol=GNORM_RTOL)


@pytest.mark.parametrize("ema_codebook", [False, True])
def test_one_train_step_matches_jax(ema_codebook):
    pair = Pair(ema_codebook)
    x = _batches(1, 7)[0]
    # gradients first, on the same initial state
    loss_fn = jtrainer._vqvae_loss_fn(pair.jm, pair.jcfg.model.beta)
    (_, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        pair.jstate.params, pair.jstate.batch_stats, {"x": jnp.asarray(x)}, None)
    jstep = jtrainer.make_train_step(pair.jm, pair.jcfg, donate=False)
    jstate, jmetrics = jstep(pair.jstate, {"x": jnp.asarray(x)}, jax.random.PRNGKey(0))

    tstep = trainer.make_train_step(pair.tm, pair.tcfg)
    _, tmetrics = tstep(pair.tstate, {"x": torch.from_numpy(x)})

    want_g = np.asarray(ravel_pytree(jgrads)[0])
    got_g = pair.to_jax_order(pair.tstate.flat.grad)
    if ema_codebook:  # the codebook's gradient is zeroed before the update
        cb = pair.tstate.flat.view("codebook", pair.tstate.flat.grad)
        assert float(cb.abs().max()) == 0.0
        jgrads = dict(jgrads)
        jgrads["codebook"] = jnp.zeros_like(jgrads["codebook"])
        want_g = np.asarray(ravel_pytree(jgrads)[0])
    np.testing.assert_allclose(got_g, want_g, atol=GRAD_FRAC * np.abs(want_g).max())
    _assert_metrics(tmetrics, jmetrics)
    pair.assert_states_match(jstate)
    if ema_codebook:
        for k in ("cluster", "embed_sum"):
            np.testing.assert_allclose(pair.tstate.codebook_ema[k].numpy(),
                                       np.asarray(jstate.codebook_ema[k]), atol=PARAM_ATOL,
                                       rtol=1e-5, err_msg=k)


def test_three_step_multistep_matches_jax():
    pair = Pair(seed=1)
    xs = _batches(3, 11)
    jmulti = jtrainer.make_multistep_train(pair.jm, pair.jcfg, 3, donate=False)
    jstate, jstacked = jmulti(pair.jstate, {"x": jnp.asarray(xs)}, jax.random.PRNGKey(0))
    tmulti = trainer.make_multistep_train(pair.tm, pair.tcfg, 3)
    _, tstacked = tmulti(pair.tstate, {"x": torch.from_numpy(xs)})
    assert tstacked["loss"].shape == (3,)
    _assert_metrics(tstacked, jstacked)
    pair.assert_states_match(jstate)


def test_eval_step_matches_jax_on_the_ema_shadow():
    pair = Pair(seed=2)
    x = _batches(1, 13)[0]
    jeval = jtrainer.make_eval_step(pair.jm, pair.jcfg)
    jrecon, jmetrics = jeval(pair.jstate, {"x": jnp.asarray(x)})
    teval = trainer.make_eval_step(pair.tm, pair.tcfg)
    live = pair.tstate.flat.flat.clone()
    trecon, tmetrics = teval(pair.tstate, {"x": torch.from_numpy(x)})
    for k in ("loss", "loss_recons", "loss_vq", "loss_commit", "perplexity"):
        np.testing.assert_allclose(np.asarray(tmetrics[k]), np.asarray(jmetrics[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(trecon.numpy(), np.asarray(jrecon), atol=1e-4)
    # the live parameters are back in place after the EMA pass
    assert torch.equal(pair.tstate.flat.flat, live)


def test_parameters_and_gradients_are_views_of_the_flat_buffers():
    pair = Pair(seed=3)
    flat = pair.tstate.flat
    step = trainer.make_train_step(pair.tm, pair.tcfg)
    step(pair.tstate, {"x": torch.from_numpy(_batches(1, 5)[0])})
    base, gbase = flat.flat.data_ptr(), flat.grad.data_ptr()
    size = flat.numel * 4
    for (name, p), offset in zip(pair.tm.named_parameters(), flat.offsets):
        assert p.data_ptr() == base + 4 * offset, name
        assert p.grad.data_ptr() == gbase + 4 * offset, name
        assert base <= p.data_ptr() < base + size
    # the fused update writes the model: a change to the buffer shows in it
    with torch.no_grad():
        flat.flat.zero_()
    assert float(pair.tm.codebook.detach().abs().max()) == 0.0
    assert flat.names == [n for n, _ in pair.tm.named_parameters()]


def test_swapped_parameters_come_back():
    pair = Pair(seed=4)
    flat = pair.tstate.flat
    other = torch.zeros_like(flat.flat)
    with flat.swapped(other):
        assert float(pair.tm.encoder.Conv_0.weight.detach().abs().max()) == 0.0
    assert pair.tm.encoder.Conv_0.weight.data_ptr() == flat.flat.data_ptr() + 4 * flat.offsets[
        flat.names.index("encoder.Conv_0.weight")]
    with pytest.raises(ValueError):
        with flat.swapped(other[:-1]):
            pass


def test_vqvae_loss_and_perplexity_match_jax():
    rng = np.random.default_rng(0)
    x, xt = rng.standard_normal((2, 3, 8, 4, 1)).astype(np.float32)
    ze, zq = rng.standard_normal((2, 3, 2, 1, 5)).astype(np.float32)
    _, jm = jlosses.vqvae_loss(*map(jnp.asarray, (xt, x, ze, zq)), 0.25)
    tze = torch.from_numpy(ze).requires_grad_()
    tzq = torch.from_numpy(zq).requires_grad_()
    total, tm = losses.vqvae_loss(torch.from_numpy(xt), torch.from_numpy(x), tze, tzq, 0.25)
    for k in jm:
        np.testing.assert_allclose(tm[k].detach().numpy(), np.asarray(jm[k]), rtol=1e-6)
    total.backward()  # the stop-gradients: z_q learns by vq, z_e by beta * commit
    np.testing.assert_allclose(tzq.grad.numpy(), 2 * (zq - ze) / zq.size, rtol=1e-5)
    np.testing.assert_allclose(tze.grad.numpy(), 0.25 * 2 * (ze - zq) / ze.size, rtol=1e-5)
    idx = rng.integers(0, 9, (4, 5, 6)).astype(np.int32)
    idx[idx == 3] = 4  # an unused code
    np.testing.assert_allclose(float(losses.codebook_perplexity(torch.from_numpy(idx), 12)),
                               float(jlosses.codebook_perplexity(jnp.asarray(idx), 12)),
                               rtol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("constant", {}),
    ("noam_learning_rate_decay", {"warmup_steps": 10}),
    ("noam_learning_rate_decay", {}),
    ("step_learning_rate_decay", {"anneal_rate": 0.5, "anneal_interval": 4}),
    ("step_learning_rate_decay", {"anneal_rate": 0.98, "anneal_interval": 30000}),
])
def test_lr_schedules_match_jax(name, kwargs):
    counts = [0, 1, 3, 4, 5, 9, 10, 11, 100, 29999, 30000, 30001, 90000]
    fields = dict(lr_schedule=name, lr_schedule_kwargs=kwargs, initial_learning_rate=2e-3)
    jsched = jts.make_lr_schedule(dataclasses.replace(JaxConfig().train, **fields))
    tsched = train_state.make_lr_schedule(dataclasses.replace(Config().train, **fields))
    for c in counts:
        want = float(jsched(jnp.asarray(c, jnp.int32)))
        got = float(tsched(torch.tensor(c, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"count {c}")
    with pytest.raises(ValueError):
        train_state.make_lr_schedule(dataclasses.replace(Config().train, lr_schedule="cosine"))


@pytest.mark.parametrize("warmup", [False, True])
def test_resolve_ema_decay_matches_jax(warmup):
    for step in (0, 1, 5, 50, 10_000, 200_000):
        want = float(jts.resolve_ema_decay(0.9999, warmup, jnp.asarray(step, jnp.int32)))
        got = float(train_state.resolve_ema_decay(0.9999, warmup,
                                                  torch.tensor(step, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-7)


def test_create_train_state_matches_jax_init():
    jcfg, tcfg = _cfgs(ema_codebook=True)
    tm = VQVAE(1, DIM, Z_DIM, generator=torch.Generator().manual_seed(0))
    state = train_state.create_train_state(tm, tcfg.train, ema_codebook=True)
    assert state.opt_state.m.dtype == torch.float32 and int(state.opt_state.count) == 0
    assert torch.equal(state.ema_params, state.flat.flat)
    assert state.ema_params.data_ptr() != state.flat.flat.data_ptr()
    assert torch.equal(state.codebook_ema["cluster"], torch.ones(Z_DIM))
    assert torch.equal(state.codebook_ema["embed_sum"], tm.codebook.detach())
    bf16 = train_state.create_train_state(
        VQVAE(1, DIM, Z_DIM), dataclasses.replace(tcfg.train, bf16_moments=True))
    assert bf16.opt_state.v.dtype == torch.bfloat16
    # fused=False: the per-leaf optimizer, float32 zero moments a parameter
    # (optax's adam ignores bf16_moments)
    leaf = train_state.create_train_state(
        VQVAE(1, DIM, Z_DIM), dataclasses.replace(tcfg.train, bf16_moments=True), fused=False)
    assert isinstance(leaf.opt_state, train_state.LeafOptState)
    assert list(leaf.opt_state.m) == leaf.flat.names
    assert all(t.dtype == torch.float32 and not t.any() for t in leaf.opt_state.moments())
    # the same model in both frameworks has the same number of parameters
    jv = JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 80, FRAMES, 1)), train=False)
    assert state.flat.numel == ravel_pytree(jv["params"])[0].size


def test_flat_order_bridge_round_trips():
    pair = Pair(seed=5)
    names = pair.tstate.flat.names
    jflat = np.random.default_rng(0).standard_normal(pair.tstate.flat.numel).astype(np.float32)
    port = convert.flax_flat_to_port(jflat, pair.variables["params"], names)
    np.testing.assert_array_equal(pair.to_jax_order(port), jflat)
    # the live parameters map onto JAX's ravel of the same params exactly
    np.testing.assert_array_equal(pair.to_jax_order(pair.tstate.flat.flat),
                                  np.asarray(ravel_pytree(pair.variables["params"])[0]))
    np.testing.assert_array_equal(convert.ravel_flax(pair.variables["params"]),
                                  np.asarray(ravel_pytree(pair.variables["params"])[0]))
    tree = convert.unravel_flax(jflat, pair.variables["params"])
    np.testing.assert_array_equal(np.asarray(ravel_pytree(tree)[0]), jflat)


def test_trainer_epochs_pull_metrics_and_warn_on_empty_epochs(tmp_path):
    pair = Pair(seed=6)
    logs = []
    cfg = dataclasses.replace(pair.tcfg, train=dataclasses.replace(
        pair.tcfg.train, log_interval=0, checkpoint_interval=2))
    tr = trainer.Trainer(pair.tm, cfg, pair.tstate, log_fn=logs.append,
                         metrics_path=str(tmp_path / "m.jsonl"), multi_steps=2)
    saved = []
    xs = _batches(5, 3)
    means = tr.train_epoch(iter([{"x": x} for x in xs]), epoch=1,
                           checkpoint_cb=lambda s, step: saved.append(step))
    assert int(tr.state.step) == COUNT + 4  # the fifth batch is a partial chunk
    assert saved == [COUNT + 2, COUNT + 4]
    assert np.isfinite(means["loss"]) and "grad_norm" in means
    tr.train_epoch(iter([]), epoch=2)
    assert any("WARNING: epoch 2 produced 0 training batches" in line for line in logs)
    evals, recon = tr.eval_epoch(iter([{"x": xs[0]}]))
    assert recon.shape == (B, 80, FRAMES, 1) and "perplexity" in evals
    records = [line for line in open(tmp_path / "m.jsonl")]
    assert len(records) == 3 and '"phase": "test"' in records[-1]



def test_rvq_ema_codebook_step_with_restarts_matches_jax(monkeypatch):
    """Residual VQ under EMA codebooks with dead-code restarts: per-stage
    statistics against each stage's residual, per-stage restarts from each
    stage's own residuals. jax.random cannot be reproduced in torch, so the
    port's restart draw is replaced by JAX's (randint of fold_in(key, q)),
    stage by stage; everything else is the port's. The f32 step limits."""
    pair = Pair(ema_codebook=True, seed=7, num_quantizers=2, restart=1.0)
    x = _batches(1, 17)[0]
    key = jax.random.PRNGKey(3)
    jstep = jtrainer.make_train_step(pair.jm, pair.jcfg, donate=False)
    jstate, jmetrics = jstep(pair.jstate, {"x": jnp.asarray(x)}, key)

    stages = []

    def jax_draw(codebook, usage, batch_flat, generator, threshold, cluster, embed_sum):
        q = len(stages)
        stages.append(q)
        idx = np.array(jax.random.randint(jax.random.fold_in(key, q), (codebook.shape[0],), 0,
                                          batch_flat.shape[0]))
        return vq_ops.restart_rows(codebook, usage, batch_flat[torch.from_numpy(idx).long()],
                                   threshold, cluster, embed_sum)

    monkeypatch.setattr(trainer, "restart_dead_codes", jax_draw)
    tstep = trainer.make_train_step(pair.tm, pair.tcfg)
    _, tmetrics = tstep(pair.tstate, {"x": torch.from_numpy(x)})
    assert stages == [0, 1]
    _assert_metrics(tmetrics, jmetrics)
    pair.assert_states_match(jstate)
    ce = pair.tstate.codebook_ema
    assert ce["cluster"].shape == (2, Z_DIM) and ce["embed_sum"].shape == (2, Z_DIM, DIM)
    for k in ("cluster", "embed_sum"):
        np.testing.assert_allclose(ce[k].numpy(), np.asarray(jstate.codebook_ema[k]),
                                   atol=PARAM_ATOL, rtol=1e-5, err_msg=k)
    # both stages restarted some codes (cluster reset to exactly 1)
    for q in range(2):
        assert 0 < int((ce["cluster"][q] == 1.0).sum()) < Z_DIM, q
    # the port's own draws: reproducible from the step's generator
    runs = []
    monkeypatch.undo()
    for _ in range(2):
        p2 = Pair(ema_codebook=True, seed=7, num_quantizers=2, restart=1.0)
        trainer.make_train_step(p2.tm, p2.tcfg)(p2.tstate, {"x": torch.from_numpy(x)},
                                                torch.Generator().manual_seed(5))
        runs.append(p2.tm.codebook.detach().clone())
    assert torch.equal(runs[0], runs[1])


def test_rvq_eval_step_pools_perplexity_over_stages_as_jax_does():
    pair = Pair(seed=9, num_quantizers=2)
    x = _batches(1, 19)[0]
    jrecon, jmetrics = jtrainer.make_eval_step(pair.jm, pair.jcfg)(pair.jstate,
                                                                  {"x": jnp.asarray(x)})
    trecon, tmetrics = trainer.make_eval_step(pair.tm, pair.tcfg)(pair.tstate,
                                                                  {"x": torch.from_numpy(x)})
    for k in ("loss", "loss_recons", "loss_vq", "loss_commit", "perplexity"):
        np.testing.assert_allclose(np.asarray(tmetrics[k]), np.asarray(jmetrics[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(trecon.numpy(), np.asarray(jrecon), atol=1e-4)


def test_bf16_train_step_matches_jax_bf16():
    """One bf16 step from the same state: the loss terms within 2e-2
    relative (bf16 roundings flip where float32 sums run in another order);
    the parameters, gradients and moments stay float32."""
    pair = Pair(seed=8, bf16=True)
    x = _batches(1, 21)[0]
    jstep = jtrainer.make_train_step(pair.jm, pair.jcfg, donate=False)
    jstate, jmetrics = jstep(pair.jstate, {"x": jnp.asarray(x)}, jax.random.PRNGKey(0))
    _, tmetrics = trainer.make_train_step(pair.tm, pair.tcfg)(pair.tstate,
                                                              {"x": torch.from_numpy(x)})
    for k in ("loss", "loss_recons", "loss_vq", "loss_commit", "train_loss"):
        np.testing.assert_allclose(np.asarray(tmetrics[k]), np.asarray(jmetrics[k]), rtol=2e-2,
                                   err_msg=k)
    ts = pair.tstate
    assert ts.flat.flat.dtype == ts.flat.grad.dtype == ts.opt_state.m.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in pair.tm.parameters())
    assert float(ts.flat.grad.abs().max()) > 0


def test_bf16_training_tracks_float32():
    """tests/test_models.py::test_vqvae_bf16_training_parity on the port:
    bf16 compute must track float32's convergence on a learnable input
    (sinusoidal ridges and noise), not merely stay finite: over 40 steps
    both learn (the loss falls by a third), and bf16's final loss is under
    1.25x float32's."""
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, 16)[None, :, None, None]
    x = torch.from_numpy((0.5 * np.sin(2 * np.pi * 4 * t)
                          + 0.1 * rng.standard_normal((4, 16, 16, 1))).astype(np.float32))
    cfg = Config()
    finals = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = VQVAE(1, 16, 32, dtype=dtype, generator=torch.Generator().manual_seed(0))
        state = train_state.create_train_state(model, cfg.train)
        step = trainer.make_train_step(model, cfg)
        losses = [float(step(state, {"x": x})[1]["loss"]) for _ in range(40)]
        assert np.isfinite(losses).all()
        assert losses[-1] < 0.67 * losses[0], (dtype, losses[0], losses[-1])
        finals[dtype] = losses[-1]
    assert finals[torch.bfloat16] < 1.25 * finals[torch.float32], finals


def test_rvq_train_state_and_bridges():
    """RVQ EMA-codebook state as JAX builds it ((Q, K) clusters of 1,
    embed_sum the codebook); the flat-vector orders and the EMA statistics
    carried both ways for an RVQ model."""
    pair = Pair(ema_codebook=True, seed=10, num_quantizers=3)
    ce, jce = pair.tstate.codebook_ema, pair.jstate.codebook_ema
    assert torch.equal(ce["cluster"], torch.ones(3, Z_DIM))
    np.testing.assert_array_equal(ce["embed_sum"].numpy(), np.asarray(jce["embed_sum"]))
    back = convert.codebook_ema_to_port(jax.tree_util.tree_map(np.asarray, jce))
    for k in ("cluster", "embed_sum"):
        assert torch.equal(back[k], ce[k]), k
        np.testing.assert_array_equal(convert.codebook_ema_to_flax(ce)[k], np.asarray(jce[k]))
    with pytest.raises(ValueError):
        convert.codebook_ema_to_port({"cluster": np.ones((2, Z_DIM)),
                                      "embed_sum": np.ones((3, Z_DIM, DIM))})
    names = pair.tstate.flat.names
    params = pair.variables["params"]
    jflat = np.random.default_rng(1).standard_normal(pair.tstate.flat.numel).astype(np.float32)
    np.testing.assert_array_equal(
        pair.to_jax_order(convert.flax_flat_to_port(jflat, params, names)), jflat)
    np.testing.assert_array_equal(pair.to_jax_order(pair.tstate.flat.flat),
                                  np.asarray(ravel_pytree(params)[0]))
    assert pair.tstate.flat.view("codebook").shape == (3, Z_DIM, DIM)

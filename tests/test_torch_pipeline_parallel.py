"""Pipeline parallelism (the mesh's ``pipe`` axis) for the transformer prior
and WaveNet, on the CPU.

Two gloo launches join through ``file://`` rendezvous in the test's
directories and run every case of ``tests/torch_pp_worker.py``: a world of
2 on (data 1 x pipe 2), a world of 4 on (data 2 x pipe 2) and then (data 1
x pipe 4), which restores the checkpoint its pipe-2 mesh wrote and runs the
cases whose layers stage over 4. Each case is held against the same case
function run here with no mesh: the port's one-rank step. The pipelined
loss and gradient are also held against JAX's ``prior_pp_logits`` and
``wavenet_pp_logits`` under ``jax.value_and_grad`` on ``make_pp_mesh(
n_pipe=2, n_data=1|2)`` over the conftest's virtual CPU devices, and one
step's parameters against JAX's ``make_pp_prior_train_step`` and
``make_pp_wavenet_train_step``. ``cli.prior train --arch transformer`` and
``cli.vocoder train`` then run with ``--mesh-pipe 2`` under ``torchrun`` on
two ranks against one rank, and their artifacts sample and synthesize on
one rank.

Tolerances, with their reasons:
  * every gathered value bit-equal on every rank (one set of collective
    results feeds the same arithmetic), each rank's whole local state
    bit-equal across its data group, and its rest (the flat buffers past
    ``split_at``: parameters, moments, EMA) across its pipe group;
  * losses 1e-5 relative, the routed load-balance term 1e-6; bf16 losses
    2e-2 (the microbatches' shapes change the bf16 products' sums);
  * the flat gradient within 1e-5 of the one-rank gradient's norm (the
    microbatches and the pipe group's sum reorder float32 sums). The MoL
    vocoders take the larger of that and twice the one-rank float32
    gradient's own distance from the float64 gradient of the same step
    (the float64 case): the MoL loss's branches (``cdf_delta > 1e-5``,
    the tails) switch on rounding, so its float32 gradient sits 1e-4 of
    its norm from the exact one whatever the order of the sums;
  * parameters, moments and the EMA after a step from warm moments 1e-5
    relative and 1e-6 absolute, or 2e-6 of the tensor's largest
    (``test_torch_model_parallel.py``'s bounds); a MoL vocoder's moments
    and parameters by the gradient's own bound;
  * in float64 (the dense and the spatial prior, the MoL and the speaker
    vocoders, their gradient outside the train step) 1e-12 relative and
    1e-12 of each leaf's largest: the pipeline reorders sums, so the
    float32 gaps above are rounding alone; the loss 1e-5, as both models
    return float32 logits or predictions;
  * a checkpoint's round trip between S 1, 2 and 4 bit-exact;
  * against JAX: the loss 1e-5 relative, gradients 2e-4 of the largest;
    bf16 losses 2e-2 and gradients 5e-2 of the largest (XLA keeps bf16
    intermediates in float32 where it fuses); one step's parameters from
    the same warm moments 1e-5 relative and 2e-6 of the largest;
  * the CLIs' checkpoints 1e-5 absolute; a bias, and the vocoder's
    upsampler, 2 lr a step (Adam's cold first steps turn a rounding-noise
    gradient into +-lr; ``test_torch_gated_model_parallel.py``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import torch_pp_worker as worker
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import transformer_prior as jtp
from neural_sound_generation_tpu.models import wavenet as jwn
from neural_sound_generation_tpu.parallel import pipeline as jpp
from neural_sound_generation_tpu.training import losses as jlosses
from neural_sound_generation_tpu.training.train_state import make_optimizer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.parallel import pipeline as pp
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import ALIGN

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: launch -> (world, the mesh tags it runs)
LAUNCHES = {"w2": (2, ("d1p2",)), "w4": (4, ("d2p2", "d1p4"))}
TAGS = ("d1p2", "d2p2", "d1p4")
LOSS_RTOL, AUX_RTOL, GRAD_REL, STAT_ATOL, STAT_RTOL, SUM_FRAC = 1e-5, 1e-6, 1e-5, 1e-6, 1e-5, 2e-6
F64_RTOL, BF16_LOSS_RTOL, CLI_ATOL = 1e-12, 2e-2, 1e-5
JAX_GRAD_FRAC, JAX_BF16_GRAD_FRAC = 2e-4, 5e-2
ROWS, T, FRAMES, GRID = 8, 64, 16, (5, 6)  # a batch's rows, samples, mel frames, code grid


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _weights(family: str, seed: int) -> dict:
    """The family's seeded weights with every leaf moved by 0.05 N(0, 1),
    so that the biases, zero at init, take part."""
    model = worker.make(family, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(100 + seed)
    return {k: t + 0.05 * torch.randn(t.shape, generator=gen)
            for k, t in model.state_dict().items()}


def _inputs(work) -> dict:
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    lengths = t(rng.integers(40, T + 1, ROWS).astype(np.int64))
    mel = t(rng.standard_normal((ROWS, FRAMES, worker.WAVENET["cin_channels"]))
            .astype(np.float32))
    codes = {"codes": t(rng.integers(0, worker.K, (ROWS, *GRID)).astype(np.int64)),
             "labels": t(rng.integers(0, worker.CLASSES, ROWS).astype(np.int64))}
    inp = {"mol_batch": {"y": t(rng.uniform(-0.9, 0.9, (ROWS, T, 1)).astype(np.float32)),
                         "c": mel, "input_lengths": lengths},
           "mulaw_batch": {"y": t(rng.integers(0, worker.QC, (ROWS, T)).astype(np.int64)),
                           "c": mel, "input_lengths": lengths,
                           "g": t(rng.integers(0, worker.SPEAKERS, ROWS).astype(np.int64))},
           "codes_batch": codes,
           "codes_cond_batch": {**codes, "cond": t(rng.standard_normal(
               (ROWS, *GRID, worker.COND)).astype(np.float32))}}
    for i, family in enumerate(("prior", "prior_moe", "prior_spatial", "wavenet",
                                "wavenet_mulaw", "wavenet_s4")):
        inp[family] = _weights(family, i)
    for family in worker.SAVED:
        inp[f"ckpt_one_{family}"] = str(work / f"ckpt_one_{family}")
    inp["work"] = str(work)
    return inp


def _spawn(work, world):
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_pp_worker.py"), str(r), str(world),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env())
        for r in range(world)]


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    work = tmp_path_factory.mktemp("pipeline")
    inp = _inputs(work)
    # the one-rank checkpoints the stages restore: each family's stepped state
    for family in worker.SAVED:
        _, state, _ = worker._step(inp, None, family)
        checkpoint.save(inp[f"ckpt_one_{family}"], state, step=101)
    checkpoint.wait_for_pending()
    dirs = {key: work / key for key in LAUNCHES}
    procs = {}
    for key, d in dirs.items():
        d.mkdir()
        torch.save(inp, d / "inputs.pt")
        procs[key] = _spawn(d, LAUNCHES[key][0])
    one = {name: case(inp, None) for name, case in worker.CASES.items()}
    for key, ps in procs.items():
        try:
            outs = [p.communicate(timeout=240)[0] for p in ps]
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(ps, outs)):
            assert p.returncode == 0, f"launch {key} rank {r} failed:\n{out}"
    ranks = {}
    for key, d in dirs.items():
        loaded = [torch.load(d / f"rank{r}.pt", weights_only=True)
                  for r in range(LAUNCHES[key][0])]
        for t in LAUNCHES[key][1]:
            ranks[t] = [rank[t] for rank in loaded]
    return {"ranks": ranks, "one": one, "inp": inp, "dirs": dirs}


def _grad(d: dict) -> torch.Tensor:
    return torch.cat([d[k].reshape(-1).double() for k in sorted(d) if k.startswith("grad/")])


def _mol_noise(one: dict, family: str) -> float:
    """The one-rank float32 gradient's distance from the float64 one, over
    its norm (the MoL loss's rounding-switched branches)."""
    f64 = one["float64"]["whole"]
    g64 = torch.cat([f64[f"f64/{family}/params/{k[len('grad/'):]}"].reshape(-1)
                     for k in sorted(one[family]["whole"]) if k.startswith("grad/")])
    g32 = _grad(one[family]["whole"])
    return float((g32 - g64).norm() / g64.norm())


def _grad_limit(one: dict, case: str) -> float:
    if case in ("wavenet", "wavenet_s4"):
        return max(GRAD_REL, 2 * _mol_noise(one, case))
    return GRAD_REL


def _assert_close(key, got, want, case, limit):
    kind = key.split("/", 1)[0]
    bf16 = case.endswith("_bf16")
    if kind == "f64":
        if key.endswith("/loss"):  # of the float32 logits both models return
            torch.testing.assert_close(got, want, rtol=LOSS_RTOL, atol=0, msg=key)
        else:
            scale = float(want.abs().max()) if want.numel() else 0.0
            torch.testing.assert_close(got, want, rtol=F64_RTOL, atol=F64_RTOL * scale, msg=key)
    elif kind in ("restored", "from_p2") or key in ("step", "opt_state/count"):
        assert torch.equal(got, want), key
    elif kind == "metric":
        if key == "metric/moe_load_balance":
            torch.testing.assert_close(got, want, rtol=AUX_RTOL, atol=0, msg=key)
        elif not key.endswith("grad_norm") or not bf16:
            rtol = BF16_LOSS_RTOL if bf16 else max(LOSS_RTOL, limit)
            torch.testing.assert_close(got, want, rtol=rtol, atol=0, msg=key)
    elif kind == "grad" or bf16:
        return  # the whole gradient is held by its norm below; bf16 by its loss
    else:  # params, moments, EMA shadow
        frac = max(SUM_FRAC, limit)
        atol = max(STAT_ATOL * (limit / GRAD_REL), frac * float(want.abs().max()))
        torch.testing.assert_close(got.float(), want.float(), rtol=max(STAT_RTOL, limit),
                                   atol=atol, msg=key)


CASE_IDS = [(t, c) for t in TAGS for c in worker.CASES
            if (c in worker.P4_CASES) == (t == "d1p4") or t != "d1p4" and c != "wavenet_s4"]


@pytest.mark.parametrize("mesh,case", CASE_IDS, ids=[f"{t}-{c}" for t, c in CASE_IDS])
def test_stages_compute_the_one_rank_step(pipe, mesh, case):
    """Each case's gathered values bit-equal on every rank and equal to the
    one-rank run's; the flat gradient within its bound of the norm."""
    ranks = [r[case] for r in pipe["ranks"][mesh]]
    one = pipe["one"]
    want = one[case]["whole"]
    want_keys = set(want)
    if mesh == "d1p4" and case == "float64":
        want_keys = {k for k in want if not k.startswith(("f64/wavenet/", "f64/wavenet_mulaw/"))}
    if mesh == "d1p4" and case == "restore":
        want_keys |= {k.replace("restored/", "from_p2/", 1) for k in want}
    if mesh != "d1p4" and case == "restore":  # the S-2 states the test restores below
        want_keys |= {k for k in ranks[0]["whole"] if k.startswith("stepped/")}
    assert set(ranks[0]["whole"]) == want_keys
    limit = _grad_limit(one, case)
    for key in ranks[0]["whole"]:
        for r, rank in enumerate(ranks[1:], 1):
            assert torch.equal(rank["whole"][key], ranks[0]["whole"][key]), \
                f"{case} {key}: rank {r} differs from rank 0"
        if key in want:
            _assert_close(key, ranks[0]["whole"][key], want[key], case, limit)
    if any(k.startswith("grad/") for k in want) and not case.endswith("_bf16"):
        g1, g2 = _grad(want), _grad(ranks[0]["whole"])
        assert float((g2 - g1).norm()) <= limit * float(g1.norm()), case


@pytest.mark.parametrize("mesh", TAGS)
def test_rest_bit_equal_across_each_pipe_group(pipe, mesh):
    """Everything a rank holds is bit-equal across its data group (the same
    stage); its rest (parameters, moments, EMA past ``split_at``) across
    its pipe group, which applies one update to it."""
    for case, result in pipe["ranks"][mesh][0].items():
        if "coord" not in result["local"]:
            continue
        locs = [r[case]["local"] for r in pipe["ranks"][mesh]]
        for a in locs:
            for b in locs:
                (da, sa), (db, sb) = a["coord"].tolist(), b["coord"].tolist()
                if sa == sb:
                    for key in ("all", "grad"):
                        assert torch.equal(a[key], b[key]), f"{case} {key}: data group differs"
                if da == db:
                    assert torch.equal(a["rest"], b["rest"]), f"{case}: rest differs in a row"
                    cut = int(a["split_at"])
                    assert torch.equal(a["grad"][cut:], b["grad"][cut:]), case


def _local_count(family: str, n_pipe: int, stage: int) -> tuple[int, int]:
    """(the parameters a stage holds, its stage layers' share of them)."""
    model = worker.make(family)
    depth = model.n_layers if family.startswith("prior") else model.layers
    mine = pp.Stage(stage, n_pipe).layers(depth)
    pattern = pp._layer_re(model)
    count = layers = 0
    for name, p in model.named_parameters():
        m = pattern.match(name)
        if m is None or int(m.group(1)) in mine:
            count += p.numel()
            layers += p.numel() if m else 0
    return count, layers


@pytest.mark.parametrize("mesh", TAGS)
def test_each_rank_holds_only_its_stage(pipe, mesh):
    """A rank's flat buffer, moments and EMA hold its stage's layers and the
    rest whole, up to the alignment padding of each leaf; ``split_at`` is
    where its layers end."""
    n_pipe = int(mesh[-1])
    for case in ("prior", "prior_moe", "wavenet_s4") if n_pipe == 4 else (
            "prior", "prior_moe", "prior_spatial", "wavenet", "wavenet_mulaw"):
        leaves = len(pipe["inp"][case])
        for rank in pipe["ranks"][mesh]:
            loc = rank[case]["local"]
            stage = int(loc["coord"][1])
            want, layers = _local_count(case, n_pipe, stage)
            assert 0 <= loc["flat"].numel() - want < ALIGN * leaves, (case, stage)
            assert 0 <= int(loc["split_at"]) - layers < ALIGN * leaves, (case, stage)
            assert loc["all"].numel() == 4 * loc["flat"].numel()  # params, m, v, EMA
    whole, _ = _local_count("prior", 1, 0)
    assert _local_count("prior", 2, 0)[0] < 0.75 * whole
    assert _local_count("prior", 4, 1)[0] < 0.5 * whole


@pytest.mark.parametrize("mesh", ["d1p2", "d2p2"])
@pytest.mark.parametrize("family", worker.SAVED)
def test_checkpoint_written_at_p2_resumes_at_p1_and_p4_and_serves(pipe, mesh, family):
    """Rank 0 wrote the dense tree from S 2: a one-rank state restores it and
    equals the stages' gathered state bit for bit; the S 4 mesh of the same
    launch restored the same tree; the weights load into a whole model."""
    inp = pipe["inp"]
    ckpt = str(pipe["dirs"]["w2" if mesh == "d1p2" else "w4"] / f"ckpt_{mesh}_{family}")
    _, state = worker.fresh_state(inp, family, None)
    checkpoint.restore(ckpt, state)
    got = checkpoint.state_tensors(state)
    head = f"stepped/{family}/"
    stepped = {k[len(head):]: t for k, t in pipe["ranks"][mesh][0]["restore"]["whole"].items()
               if k.startswith(head)}
    assert stepped.keys() == got.keys()
    one = pipe["one"]
    limit = _grad_limit(one, family)
    for key, t in got.items():
        assert torch.equal(t, stepped[key]), key
        if key.startswith("params/"):
            _assert_close(key, t, one[family]["whole"][key], family, limit)
    if mesh == "d2p2":
        p4 = pipe["ranks"]["d1p4"][0]["restore"]["whole"]
        for key, t in got.items():
            assert torch.equal(p4[f"from_p2/{family}/{key}"], t), key
    model = worker.build(inp, family)
    checkpoint.restore_params(ckpt, model)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), got[f"params/{name}"]), name


# ---------------------------------------------------------------------------
# Against JAX's pipeline
# ---------------------------------------------------------------------------


def _jax_module(family: str):
    if family.startswith("prior"):
        return jtp.TransformerPrior(
            input_dim=worker.K, dim=worker.DIM, n_layers=worker.LAYERS, n_heads=worker.HEADS,
            n_classes=worker.CLASSES,
            n_experts=worker.EXPERTS if family == "prior_moe" else 0,
            spatial_cond=family == "prior_spatial", max_rows=8, max_cols=8,
            dtype=jnp.bfloat16 if family == "prior_bf16" else jnp.float32)
    if family == "wavenet_mulaw":
        return jwn.WaveNet(out_channels=worker.QC, scalar_input=False,
                           quantize_channels=worker.QC, gin_channels=worker.GIN,
                           n_speakers=worker.SPEAKERS, **worker.WAVENET)
    return jwn.WaveNet(out_channels=worker.MOL_OUT, **worker.WAVENET)


def _jax_batch(inp, family: str) -> dict:
    return {k: jnp.asarray(v.numpy().astype(np.int32) if not v.is_floating_point()
                           else v.numpy()) for k, v in worker.batch(inp, family).items()}


def _jax_loss_fn(family: str, jm, mesh, n_micro: int):
    """JAX's pipelined objective of the family: ``(params, batch) ->
    (objective, (loss, load-balance term or 0))``."""
    cfg = JaxConfig()
    if family.startswith("prior"):
        routed = family == "prior_moe"

        def prior_loss(params, b):
            out = jpp.prior_pp_logits(jm, {"params": params}, b["codes"], b["labels"], mesh,
                                      n_micro, cond_map=b.get("cond"))
            logits, aux = out if routed else (out, jnp.zeros(()))
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll = -jnp.mean(jnp.take_along_axis(logp, b["codes"][..., None], axis=-1))
            return nll + 0.01 * aux, (nll, aux)

        return prior_loss

    def vocoder_loss(params, b):
        rest, stacked = jpp.wavenet_stack_params(jm, {"params": params})
        x = jwn.WaveNet.shift_inputs(b["y"], jm.scalar_input)
        y_hat = jpp.wavenet_pp_logits(
            jm, rest, stacked, x, b["c"], mesh, n_micro,
            dtype=jnp.bfloat16 if family == "wavenet_bf16" else None, g=b.get("g"))
        if jm.scalar_input:
            loss = jlosses.discretized_mix_logistic_loss(
                y_hat, b["y"], num_classes=cfg.audio.quantize_channels,
                log_scale_min=cfg.arch.log_scale_min, lengths=b["input_lengths"])
        else:
            loss = jlosses.masked_cross_entropy(y_hat, b["y"], b["input_lengths"])
        return loss, (loss, jnp.zeros(()))

    return vocoder_loss


def _flax_params(family: str, named: dict) -> dict:
    """A port tree by parameter name as flax params."""
    return convert.module_to_flax(worker.make(family), named)["params"]


@pytest.mark.parametrize("family,n_data", [
    ("prior", 1), ("prior", 2), ("prior_moe", 2), ("prior_spatial", 1), ("prior_bf16", 1),
    ("wavenet", 1), ("wavenet_mulaw", 2), ("wavenet_bf16", 1)])
def test_pipelined_loss_and_gradient_equal_jax(pipe, family, n_data):
    """The stages' loss and gathered gradient hold against JAX's
    ``prior_pp_logits`` / ``wavenet_pp_logits`` under ``jax.value_and_grad``
    on ``make_pp_mesh(n_pipe=2, n_data)``, from the same weights and batch:
    the loss 1e-5 relative (the routed term 1e-6), the gradient 2e-4 of the
    largest; bf16 2e-2 and 5e-2."""
    inp = pipe["inp"]
    jm = _jax_module(family)
    mesh = jpp.make_pp_mesh(n_pipe=2, n_data=n_data)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.module_to_flax(worker.build(inp, family))["params"])
    (_, (loss, aux)), grads = jax.jit(jax.value_and_grad(
        _jax_loss_fn(family, jm, mesh, 2), has_aux=True))(params, _jax_batch(inp, family))
    got = pipe["ranks"][f"d{n_data}p2"][0][family]["whole"]
    bf16 = family.endswith("_bf16")
    torch.testing.assert_close(float(got["metric/loss"]), float(loss),
                               rtol=BF16_LOSS_RTOL if bf16 else LOSS_RTOL, atol=0)
    if family == "prior_moe":
        torch.testing.assert_close(float(got["metric/moe_load_balance"]), float(aux),
                                   rtol=AUX_RTOL, atol=0)
    want_g = np.asarray(ravel_pytree(grads)[0])
    named = {k[len("grad/"):]: t for k, t in got.items() if k.startswith("grad/")}
    got_g = convert.ravel_flax(_flax_params(family, named))
    frac = JAX_BF16_GRAD_FRAC if bf16 else JAX_GRAD_FRAC
    np.testing.assert_allclose(got_g, want_g, atol=frac * np.abs(want_g).max())


def _warm_opt(tx, params, family: str, inp):
    """The optax chain's state with the worker's warm moments (count 100)."""
    model = worker.build(inp, family)
    state = worker.warm(worker.create_train_state(model, worker.config().train))
    m, v = (_flax_params(family, {k: t.clone() for k, t in
                                  state.opt_state.named_moments(state.flat, key).items()})
            for key in ("m", "v"))
    to_jax = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731

    def visit(st):
        if isinstance(st, optax.ScaleByAdamState):
            return optax.ScaleByAdamState(count=jnp.asarray(100, jnp.int32), mu=to_jax(m),
                                          nu=to_jax(v))
        if isinstance(st, tuple) and not hasattr(st, "_fields"):
            return tuple(visit(s) for s in st)
        return st

    return visit(tx.init(params))


@pytest.mark.parametrize("family", ["prior_moe", "wavenet_mulaw"])
def test_one_step_equals_the_jax_pp_train_step(pipe, family):
    """The (data 1 x pipe 2) stages' step from warm moments holds against
    JAX's ``make_pp_prior_train_step`` / ``make_pp_wavenet_train_step``
    from the same moments, partitioned by JAX's own split: the parameters
    1e-5 relative and 2e-6 of each leaf's largest."""
    inp = pipe["inp"]
    jm = _jax_module(family)
    mesh = jpp.make_pp_mesh(n_pipe=2, n_data=1)
    base = JaxConfig()
    jcfg = dataclasses.replace(base, train=dataclasses.replace(base.train, **worker.TRAIN))
    tx = make_optimizer(jcfg.train)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.module_to_flax(worker.build(inp, family))["params"])
    dense_opt = _warm_opt(tx, params, family, inp)
    if family.startswith("prior"):
        split = lambda d: jpp.pp_prior_split(jm, d)  # noqa: E731
        rest, stacked = jpp.pp_prior_partition(jm, {"params": params}, mesh)
        _, step = jpp.make_pp_prior_train_step(jm, mesh, 2, tx)
        unsplit = lambda r, s: jpp.pp_prior_unpartition(jm, r, s)  # noqa: E731
    else:
        split = lambda d: jpp.wavenet_stack_params(jm, {"params": d})  # noqa: E731
        rest, stacked = jpp.wavenet_stack_params(jm, {"params": params}, mesh)
        _, step = jpp.make_pp_wavenet_train_step(jm, jcfg, mesh, 2, tx)
        unsplit = lambda r, s: jpp.wavenet_unstack_params(jm, r, s)  # noqa: E731
    opt = jpp.pp_opt_state_from_dense(dense_opt, split, mesh)
    rest, stacked, _, _ = step(rest, stacked, opt, _jax_batch(inp, family))
    want = unsplit(rest, stacked)
    got = pipe["ranks"]["d1p2"][0][family]["whole"]
    got = _flax_params(family, {k[len("params/"):]: t for k, t in got.items()
                                if k.startswith("params/")})
    pairs = zip(jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_leaves(want))
    for (path, g), w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=STAT_RTOL, atol=SUM_FRAC * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# The CLIs under torchrun
# ---------------------------------------------------------------------------

CLI_LR = 1e-3  # both CLIs' learning rate (the vocoder's default, the prior's --lr)
VQ_DIM, VQ_CODES = 16, 32
VOC_WIDTHS = ["--layers", "4", "--stacks", "2", "--residual-channels", "8"]
PRIOR_WIDTHS = ["--arch", "transformer", "--prior-dim", str(worker.DIM), "--prior-layers",
                str(worker.LAYERS), "--prior-heads", str(worker.HEADS)]


def _torchrun(module, *argv) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "2", "-m", module, *argv]


def _prior_args(datadir, vq, ckpt, *extra):
    return ["train", "--datadir", datadir, "--vqvae-ckpt", vq, "--ckpt-dir", ckpt,
            "--dim", str(VQ_DIM), "--z-dim", str(VQ_CODES), "--batch-size", "4",
            "--max-batches-per-epoch", "2", "--lr", str(CLI_LR), "--device", "cpu",
            *PRIOR_WIDTHS, *extra]


def _vocoder_args(datadir, ckpt, *extra):
    return ["train", "--datadir", datadir, "--ckpt-dir", ckpt, "--batch-size", "4",
            "--max-batches-per-epoch", "2", "--device", "cpu", *VOC_WIDTHS, *extra]


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """``cli.prior train --arch transformer --mesh-pipe 2`` (an epoch, then
    a ``--resume`` epoch from its ``_pp_train`` sibling) and ``cli.vocoder
    train --mesh-pipe 2 --multi-steps 2`` under torchrun on two ranks, the
    launches at once, while the same runs go on one rank here; then the
    vocoder under the pipe resumes from a copy of the one-rank artifact."""
    import shutil

    from neural_sound_generation_tpu_torch.cli import prior, vocoder
    from neural_sound_generation_tpu_torch.models import VQVAE
    from neural_sound_generation_tpu_torch.training import train_state
    from test_torch_cli_train import _corpus
    from test_torch_vocoder_train import write_corpus

    root = tmp_path_factory.mktemp("pp_clis")
    wav_dir = write_corpus(str(root / "wav_corpus"), n=16)
    os.makedirs(root / "mel_corpus")
    mel_dir = _corpus(root / "mel_corpus", n=16)
    vq = str(root / "vqvae")
    model = VQVAE(1, VQ_DIM, VQ_CODES, generator=torch.Generator().manual_seed(3))
    checkpoint.save(vq, train_state.create_train_state(model, worker.config().train), step=1,
                    extra={"arch": "vqvae", "num_quantizers": 1})
    ckpt = {(run, tag): str(root / tag / run) for run in ("prior", "wavenet", "resumed")
            for tag in ("one", "pp")}
    pipe_flags = ["--mesh-pipe", "2"]
    mod = "neural_sound_generation_tpu_torch.cli."
    first, second = ["--epochs", "1"], ["--epochs", "2", "--resume"]
    commands = {
        "prior": ["sh", "-c", " ".join([
            *_torchrun(mod + "prior", *_prior_args(mel_dir, vq, ckpt["prior", "pp"], *first,
                                                   *pipe_flags)),
            "&&", *_torchrun(mod + "prior", *_prior_args(mel_dir, vq, ckpt["prior", "pp"],
                                                         *second, *pipe_flags))])],
        "wavenet": _torchrun(mod + "vocoder", *_vocoder_args(
            wav_dir, ckpt["wavenet", "pp"], *first, "--multi-steps", "2", *pipe_flags))}
    procs = {run: subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for run, cmd in commands.items()}
    try:
        vocoder.main(_vocoder_args(wav_dir, ckpt["wavenet", "one"], *first, "--multi-steps",
                                   "2"))
        # a one-rank run's artifact (and its EMA sibling) resumes under the pipe
        for sub in ("", "_ema"):
            shutil.copytree(ckpt["wavenet", "one"] + sub, ckpt["resumed", "pp"] + sub)
        procs["resumed"] = subprocess.Popen(
            _torchrun(mod + "vocoder", *_vocoder_args(wav_dir, ckpt["resumed", "pp"], *second,
                                                      *pipe_flags)),
            cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        prior.main(_prior_args(mel_dir, vq, ckpt["prior", "one"], *first))
        prior.main(_prior_args(mel_dir, vq, ckpt["prior", "one"], *second))
        outs = {run: p.communicate(timeout=240)[0] for run, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for run, p in procs.items():
        assert p.returncode == 0, f"{run}:\n{outs[run]}"
    return {"ckpt": ckpt, "outs": outs, "vq": vq, "wav_dir": wav_dir}


def _assert_states_match(one_dir: str, pp_dir: str, step: int, steps: int) -> None:
    """The one-rank ``_train`` and the pipe run's ``_pp_train`` checkpoints
    at ``step``: the same dense tree, every parameter and EMA leaf within
    1e-5, a bias and the vocoder's upsampler within 2 lr a step; step and
    count equal; the pipe run's artifact is its state's parameters."""
    one, two = (torch.load(os.path.join(d, f"step_{step}", "state.pt"), weights_only=True)
                for d in (one_dir + "_train", pp_dir + "_pp_train"))
    assert one.keys() == two.keys()
    for key, want in one.items():
        got = two[key]
        assert got.shape == want.shape, key
        if key.startswith(("params/", "ema_params/")):
            noise = key.endswith("bias") or "/upsampler." in key
            limit = 2 * CLI_LR * steps if noise else CLI_ATOL
            assert float((got - want).abs().max()) <= limit, key
        elif key in ("step", "opt_state/count"):
            assert torch.equal(got, want), key
    artifact = torch.load(os.path.join(pp_dir, f"step_{step}", "state.pt"), weights_only=True)
    assert artifact.keys() == {k for k in two if k.startswith("params/")}
    for key, t in artifact.items():
        assert torch.equal(t, two[key]), key


def test_cli_prior_train_with_a_pipe_matches_one_rank_and_samples(clis, tmp_path):
    """``cli.prior train --arch transformer --mesh-pipe 2``, then
    ``--resume`` from its ``_pp_train`` sibling: the one-rank run's four
    steps (dense checkpoints within 1e-5; the artifact and ``_ema`` at step
    4); ``cli.prior sample`` draws from the pipe run's EMA artifact on one
    rank."""
    from scipy.io import wavfile

    from neural_sound_generation_tpu_torch.cli import prior

    one, two = clis["ckpt"]["prior", "one"], clis["ckpt"]["prior", "pp"]
    out = clis["outs"]["prior"]
    assert "pp prior: dp1xpp2, 2 microbatches" in out
    assert "[pp2 x dp1, 2 microbatches]" in out and "resumed pp train state from step 2" in out
    for sub in ("", "_ema", "_pp_train"):
        assert checkpoint.latest_step(two + sub) == 4
    assert checkpoint.read_extra(two + "_ema")["averaged"] is True
    _assert_states_match(one, two, 4, 4)
    prior.main(["sample", "--vqvae-ckpt", clis["vq"], "--prior-ckpt", two + "_ema",
                "--output-dir", str(tmp_path / "s"), "--dim", str(VQ_DIM), "--z-dim",
                str(VQ_CODES), "--code-shape", "20", "2", "--num-samples", "2", "--device",
                "cpu", *PRIOR_WIDTHS])
    names = sorted(os.listdir(tmp_path / "s"))
    assert names == ["prior_sample_000.wav", "prior_sample_001.wav"]
    for name in names:
        _, wav = wavfile.read(tmp_path / "s" / name)
        assert wav.size and np.isfinite(wav).all()


def test_cli_vocoder_train_with_a_pipe_matches_one_rank_and_synthesizes(clis, tmp_path):
    """``cli.vocoder train --mesh-pipe 2 --multi-steps 2`` (one step a
    batch): the one-rank run's two steps; its artifact synthesizes on one
    rank and loads into ``serve --vocoder-ckpt``'s model; a one-rank
    artifact resumes under the pipe (Adam's moments restart, the EMA from
    its sibling)."""
    from scipy.io import wavfile

    from neural_sound_generation_tpu_torch.cli import serve, vocoder
    from neural_sound_generation_tpu_torch.config import Config

    one, two = clis["ckpt"]["wavenet", "one"], clis["ckpt"]["wavenet", "pp"]
    assert "pp wavenet: dp1xpp2, 2 microbatches" in clis["outs"]["wavenet"]
    _assert_states_match(one, two, 2, 2)
    mel = np.load(os.path.join(clis["wav_dir"], "m0.npy"))
    np.save(tmp_path / "mel.npy", mel)
    out = str(tmp_path / "out.wav")
    vocoder.main(["synthesize", "--ckpt-dir", two, "--mel-npy", str(tmp_path / "mel.npy"),
                  "--output", out, "--max-frames", "2", "--device", "cpu", *VOC_WIDTHS])
    _, wav = wavfile.read(out)
    assert wav.shape == (2 * Config().audio.effective_hop_size,) and np.isfinite(wav).all()
    args = serve.parse_args(["--device", "cpu", "--vocoder", "wavenet", "--vocoder-ckpt", two,
                             "--vocoder-layers", "4", "--vocoder-stacks", "2",
                             "--vocoder-residual-channels", "8"])
    model = serve.load_serving_vocoder(args, Config(), torch.device("cpu"))
    artifact = torch.load(os.path.join(two, "step_2", "state.pt"), weights_only=True)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), artifact[f"params/{name}"]), name
    resumed = clis["ckpt"]["resumed", "pp"]
    assert "resumed params from step 2, epoch 2 (no *_pp_train sibling" in clis["outs"]["resumed"]
    assert checkpoint.latest_step(resumed + "_pp_train") == 4
    assert checkpoint.read_extra(resumed)["epoch"] == 2


# ---------------------------------------------------------------------------
# The split: the bridge's stage share and JAX's stacked layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,n_stages", [("prior_moe", 2), ("prior_spatial", 4),
                                             ("wavenet_mulaw", 2), ("wavenet_s4", 4)])
def test_stage_state_dict_loads_into_each_stage(family, n_stages):
    """``convert.stage_state_dict`` gives each stage its share of a JAX
    tree: it loads strictly into the model cut to that stage, whose layers
    are the whole model's of the stage's range, and the stages' shares
    cover the tree once for the layers and each time for the rest."""
    whole = worker.make(family, torch.Generator().manual_seed(5))
    variables = convert.module_to_flax(whole)
    sd = whole.state_dict()
    seen: dict = {}
    for s in range(n_stages):
        stage = worker.make(family)
        if family.startswith("prior"):
            pp.pp_prior_partition(stage, pp.Stage(s, n_stages))
        else:
            pp.pp_wavenet_partition(stage, pp.Stage(s, n_stages))
        share = convert.stage_state_dict(variables, worker.make(family), s, n_stages)
        stage.load_state_dict(share, strict=True)
        for k, t in stage.state_dict().items():
            assert torch.equal(t, sd[k]), k
            seen[k] = seen.get(k, 0) + 1
    pattern = pp._layer_re(whole)
    assert seen.keys() == sd.keys()
    assert all(n == (1 if pattern.match(k) else n_stages) for k, n in seen.items())


@pytest.mark.parametrize("family", ["prior", "wavenet_mulaw"])
def test_stacked_layout_is_jaxs_and_round_trips(family):
    """``pp_prior_split`` / ``wavenet_stack_params`` stack what JAX's
    functions of the same names stack, leaf for leaf (through the bridge's
    layouts), with the same leading axes, and their inverses give the dense
    tree back bit for bit."""
    model = worker.make(family, torch.Generator().manual_seed(6))
    tensors = dict(model.named_parameters())
    params = convert.module_to_flax(model)["params"]
    jm = _jax_module(family)
    if family.startswith("prior"):
        rest, stacked = pp.pp_prior_split(model, tensors)
        back = pp.pp_prior_unpartition(model, rest, stacked)
        jrest, jstacked = jpp.pp_prior_split(jm, {"params": params})
        for leaf, t in stacked.items():
            assert t.shape[0] == worker.LAYERS
            for i in range(worker.LAYERS):
                assert torch.equal(t[i], tensors[f"block_{i}.{leaf}"]), leaf
        groups = {"": stacked}
        jgroups = {"": jstacked}
    else:
        rest, stacked = pp.wavenet_stack_params(model, tensors)
        back = pp.wavenet_unstack_params(model, rest, stacked)
        jrest, jstacked = jpp.wavenet_stack_params(jm, {"params": params})
        groups, jgroups = stacked, jstacked
        assert set(stacked) == set(jstacked) == {"dilated", "cond", "res", "skip", "g"}
        per = model.layers // model.stacks
        for group, leaves in stacked.items():
            for leaf, t in leaves.items():
                assert t.shape[:2] == (model.stacks, per)
                for i in range(model.layers):
                    assert torch.equal(t[i // per, i % per], tensors[f"{group}_{i}.{leaf}"])
    assert {k.split(".")[0] for k in rest} == set(jrest)
    for group, leaves in groups.items():
        jleaves = jax.tree_util.tree_leaves(jgroups[group])
        assert sum(t.numel() for t in leaves.values()) == sum(np.size(x) for x in jleaves)
        lead = {np.shape(x)[:1 if family.startswith("prior") else 2] for x in jleaves}
        assert lead == {tuple(next(iter(leaves.values())).shape[:len(next(iter(lead)))])}
    assert back.keys() == tensors.keys()
    for k, t in tensors.items():
        assert torch.equal(back[k], t), k

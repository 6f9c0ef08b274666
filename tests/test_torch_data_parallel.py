"""Data parallelism over two ranks (the mesh's ``data`` axis) on the CPU.

Two rank processes join a gloo group through a ``file://`` rendezvous in
the test's directory (no TCP port to lose to another process), run every
case of ``tests/torch_dp_worker.py`` once on their rows of the global batch
(one spawn for the module), and each case is held against the same case
function run here on the whole batch with no mesh: the port's one-rank
step. The flagship VQ-VAE's step is also held against the JAX package's
step on ``make_mesh(n_data=2)`` over the conftest's virtual CPU devices,
with the same weights (through ``convert.py``) and the same seeded batch.
Two more launches run ``cli.main`` and ``cli.evaluate`` under ``torchrun``
on two ranks against the same CLIs on one.

Tolerances, with their reasons:
  * every global value bit-equal on the two ranks (one all-reduce result
    feeds the same kernels on both);
  * losses, load-balance terms, perplexities 1e-5 relative (the issue's
    bound; the ranks sum the batch in two halves, then over the ranks);
  * the all-reduced flat gradient within 1e-5 of the one-rank gradient's
    norm (relative to the norm, not per element: a convolution bias ahead
    of a BatchNorm has a true gradient of 0 and a computed one of rounding
    noise);
  * the cases' steps start from warm Adam moments (``worker._warm``), so
    parameters, the codebook (the JAX package's own data-parallel test
    holds it to 1e-6), BatchNorm statistics and EMA-codebook statistics
    agree within 1e-5 relative and 1e-6 absolute, or 2e-6 of the tensor's
    largest magnitude where that is more (the EMA statistics sum the rows
    in two halves and then over the ranks: the rounding of a sum follows
    the sum's magnitude, not the element's); per-row outputs and the
    gradients of single layers within 1e-5 of their largest magnitude (the
    BatchNorm case normalizes at |mean| / std = 100, where float32 keeps
    about five digits of x - mean);
  * the CLIs start from cold moments: Adam's first step moves an element by
    about lr * sign(g), and the sign of a rounding-noise gradient may differ
    between the runs. There the first moments (the gradients' running mean)
    agree within 1e-5 of their norm, weights within 1e-5, and biases within
    2 lr a step; BatchNorm's running means, which follow the biases ahead
    of them at momentum 0.01, within 1e-4. The CLI runs seed the codebook
    uniformly: a codebook drawn from the batch's own rows puts rows on
    near-ties of the nearest-code search (the card's phase 17 counts them);
  * against JAX: the loss 1e-5 relative, gradients 2e-4 of the largest
    gradient (the one-rank parity test's bound: JAX's BatchNorm takes
    E[x^2] - E[x]^2), the codebook 1e-6.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import torch_dp_worker as worker
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu.parallel import make_mesh as jax_make_mesh
from neural_sound_generation_tpu.parallel import replicated_sharding
from neural_sound_generation_tpu.parallel import shard_batch as jax_shard_batch
from neural_sound_generation_tpu.training import train_state as jts
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import evaluate, main, prior, vocoder
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.parallel import distributed
from neural_sound_generation_tpu_torch.training import checkpoint, train_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
LR = worker.TRAIN["initial_learning_rate"]
LOSS_RTOL, GRAD_REL, CODEBOOK_ATOL, STAT_ATOL, STAT_RTOL, ROW_FRAC = 1e-5, 1e-5, 1e-6, 1e-6, 1e-5, 1e-5
SUM_FRAC, JAX_GRAD_FRAC = 2e-6, 2e-4


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _jax_pair():
    """The flagship VQ-VAE at dim 16 / 32 codes in JAX, with a codebook
    drawn from train-mode encoder outputs (every code in reach), and its
    weights for the port."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, (8, 16, 16, 1)).astype(np.float32)
    jm = JaxVQVAE(input_dim=1, dim=worker.DIM, z_dim=worker.Z_DIM)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                   train=False))
    (_, z_e, _), _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ze = np.asarray(z_e).reshape(-1, worker.DIM)
    pick = rng.choice(ze.shape[0], worker.Z_DIM, replace=False)
    v["params"]["codebook"] = (ze[pick] + 0.05 * rng.standard_normal(
        (worker.Z_DIM, worker.DIM))).astype(np.float32)
    return jm, v, x


def _inputs(v, x) -> dict:
    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    rvq = VQVAE(1, worker.DIM, worker.Z_DIM, num_quantizers=2,
                generator=torch.Generator().manual_seed(4))
    moe = {"router.weight": 0.5 * rng.standard_normal((4, 8)),
           "router.bias": 0.1 * rng.standard_normal(4),
           "w_in": 0.3 * rng.standard_normal((4, 8, 32)), "b_in": 0.1 * rng.standard_normal((4, 32)),
           "w_out": 0.3 * rng.standard_normal((4, 32, 8)), "b_out": 0.1 * rng.standard_normal((4, 8))}
    return {
        "x": t(x), "x2": t(rng.uniform(0.0, 1.0, x.shape).astype(np.float32)),
        "vqvae": dict(convert.flax_to_state_dict(v)),
        "rvq": dict(rvq.state_dict()),
        "bn_x": t((100.0 + rng.standard_normal((8, 6, 5, 3))).astype(np.float32)),
        "bn_w": t(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
        "bn_b": t(rng.standard_normal(6).astype(np.float32)),
        "bn_r": t(rng.standard_normal((8, 6, 5, 3)).astype(np.float32)),
        "ce_logits": t(rng.standard_normal((4, 10, 5)).astype(np.float32)),
        "ce_targets": t(rng.integers(0, 5, (4, 10)).astype(np.int32)),
        "lengths": torch.tensor([10, 9, 2, 3], dtype=torch.int32),
        "mol_y_hat": t(rng.standard_normal((4, 10, 6)).astype(np.float32)),
        "mol_y": t(rng.uniform(-1.0, 1.0, (4, 10)).astype(np.float32)),
        "moe": {k: t(a.astype(np.float32)) for k, a in moe.items()},
        "moe_h": t(rng.standard_normal((4, 6, 8)).astype(np.float32)),
        "moe_r": t(rng.standard_normal((4, 6, 8)).astype(np.float32)),
        "img": t(rng.uniform(-1.0, 1.0, (8, 28, 28, 1)).astype(np.float32)),
        # rank 0's rows use codes 0-3, rank 1's codes 0-19
        "codes": torch.cat([t(rng.integers(0, 4, (4, 7)).astype(np.int32)),
                            t(rng.integers(0, 20, (4, 7)).astype(np.int32))]),
    }


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    jm, v, x = _jax_pair()
    inp = _inputs(v, x)
    torch.save(inp, work / "inputs.pt")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dp_worker.py"), str(r), str(WORLD),
         str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=_env())
        for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    one = {name: case(inp, None) for name, case in worker.CASES.items()}
    return {"ranks": ranks, "one": one, "jax": (jm, v, x)}


def _assert_global(key, got, want):
    name = key.rsplit("/", 1)[-1]
    if key == "generator":
        assert torch.equal(got, want)
    elif key == "grad":
        assert float((got - want).norm()) <= GRAD_REL * float(want.norm()), key
    elif key.startswith("buffer/") or key in ("flat", "codebook", "running_mean",
                                               "running_var", "cluster", "embed_sum"):
        atol = max(STAT_ATOL, SUM_FRAC * float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=STAT_RTOL, atol=atol, msg=key)
    elif key.startswith("grad/") or key.endswith("_grad"):
        torch.testing.assert_close(got, want, rtol=0, atol=ROW_FRAC * float(want.abs().max()),
                                   msg=key)
    else:  # losses, grad_norm, perplexities, load-balance terms
        assert name in ("loss", "loss_recons", "loss_vq", "loss_commit", "train_loss",
                        "grad_norm", "perplexity", "kl", "ce", "mol", "aux"), key
        torch.testing.assert_close(got, want, rtol=LOSS_RTOL, atol=0, msg=key)


@pytest.mark.parametrize("case", list(worker.CASES))
def test_two_ranks_compute_the_one_rank_step(dp, case):
    """Each case's global values bit-equal on the two ranks and equal to
    the one-rank run's; its per-row results, concatenated in rank order,
    equal the one-rank rows."""
    r0, r1 = (r[case] for r in dp["ranks"])
    one = dp["one"][case]
    assert r0["global"].keys() == one["global"].keys()
    for key, want in one["global"].items():
        assert torch.equal(r0["global"][key], r1["global"][key]), f"{case} {key}: ranks differ"
        _assert_global(key, r0["global"][key], want)
    if case == "host_shard":
        assert r0["rows"]["shard"].tolist() == [2, 0] and r1["rows"]["shard"].tolist() == [2, 1]
        return
    for key, want in one["rows"].items():
        got = torch.cat([r0["rows"][key], r1["rows"][key]])
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=ROW_FRAC * scale, msg=key)


def test_flagship_step_equals_the_jax_data_mesh_step(dp):
    """The rank step holds against the JAX step on a ('data' 2) mesh:
    GSPMD's sharded step is the one-device step on the whole batch."""
    jm, v, x = dp["jax"]
    base = JaxConfig()
    jcfg = dataclasses.replace(
        base, train=dataclasses.replace(base.train, **worker.TRAIN),
        model=dataclasses.replace(base.model, dim=worker.DIM, z_dim=worker.Z_DIM, beta=0.25))
    mesh = jax_make_mesh(n_data=WORLD)
    rep = replicated_sharding(mesh)
    model = VQVAE(1, worker.DIM, worker.Z_DIM)
    warm = worker._warm(train_state.create_train_state(model, worker.config().train))
    moments = {k: jnp.asarray(convert.port_flat_to_flax(getattr(warm.opt_state, k), model,
                                                        warm.flat)) for k in ("m", "v")}
    state = jts.create_train_state(v, jcfg.train)
    state = state.replace(step=jnp.asarray(100, jnp.int32), opt_state=state.opt_state.replace(
        count=jnp.asarray(100, jnp.int32), **moments))
    state = jax.device_put(state, rep)
    batch = jax_shard_batch({"x": jnp.asarray(x)}, mesh)
    loss_fn = jtrainer._vqvae_loss_fn(jm, jcfg.model.beta)
    (_, _), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params, state.batch_stats, batch, None)
    step = jtrainer.make_train_step(jm, jcfg, mesh=mesh, donate=False)
    jstate, jmetrics = step(state, batch, jax.device_put(jax.random.PRNGKey(0), rep))

    got = dp["ranks"][0]["flagship"]["global"]
    torch.testing.assert_close(float(got["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL,
                               atol=0)
    flat = warm.flat
    want_g = np.asarray(ravel_pytree(jgrads)[0])
    got_g = convert.port_flat_to_flax(got["grad"], model, flat)
    np.testing.assert_allclose(got_g, want_g, atol=JAX_GRAD_FRAC * np.abs(want_g).max())
    cb = flat.view("codebook", got["flat"])
    np.testing.assert_allclose(cb.numpy(), np.asarray(jstate.params["codebook"]),
                               atol=CODEBOOK_ATOL)


@pytest.mark.parametrize("device,local_world,cuda,cards,want", [
    ("cpu", 1, False, 0, "gloo"), ("cuda", 2, True, 8, "nccl"), (None, 8, True, 8, "nccl"),
    ("cuda", 2, True, 1, "gloo"), ("cuda", 1, False, 0, "gloo")])
def test_the_backend_rule(monkeypatch, device, local_world, cuda, cards, want):
    """NCCL when every rank of the host has a card of its own; gloo on the
    CPU and where ranks share a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert distributed.choose_backend(device, local_world) == want


def test_a_single_process_is_not_a_group():
    topo = distributed.initialize(device="cpu")
    assert topo == distributed.HostTopology(0, 1, 1, 1) and topo.is_primary
    assert distributed.loader_shard_args() == {"num_hosts": 1, "host_id": 0}
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("run,exc,match", [
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch", "pixelcnn",
                         "--mesh-model", "2", "--device", "cpu"]), SystemExit,
     r"--mesh-model 2: the model axis \(tensor parallel\) of 2 ranks needs a world of "
     r"n_data x 2 ranks, but this run has 1"),
    (lambda: main.main(["--mesh-data", "2", "--device", "cpu"]), SystemExit,
     r"--mesh-data 2 asks for 2 data-parallel ranks, but this run has 1: launch one process "
     r"per rank, torchrun --nproc_per_node 2"),
    (lambda: evaluate.main(["--datadir", "x", "--ckpt-dir", "y", "--mesh-model", "4"]),
     SystemExit, r"--mesh-model 4: the model axis"),
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--mesh-pipe", "2"]),
     SystemExit, r"--mesh-pipe stages the transformer prior's uniform block stack; use "
     r"--arch transformer \(the pixelcnn layers are not a uniform stack\)"),
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--mesh-model", "2",
                         "--device", "cpu"]), SystemExit, r"--mesh-model 2: the model axis"),
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--mesh-data", "2",
                         "--device", "cpu"]), SystemExit, r"2 data-parallel ranks"),
    (lambda: vocoder.main(["train", "--datadir", "x", "--mesh-model", "2", "--mesh-pipe",
                           "2"]),
     SystemExit, r"--mesh-model 2 with --mesh-pipe 2: a mesh has a model axis or a pipe "
                 r"axis, not both"),
    (lambda: vocoder.main(["train", "--datadir", "x", "--mesh-model", "2", "--device", "cpu"]),
     SystemExit, r"--mesh-model 2: the model axis"),
    (lambda: vocoder.main(["train", "--datadir", "x", "--mesh-data", "2", "--device", "cpu"]),
     SystemExit, r"2 data-parallel ranks"),
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch",
                         "transformer", "--mesh-pipe", "2"]),
     SystemExit, r"--prior-layers 15 does not stage evenly over --mesh-pipe 2"),
])
def test_refusals_name_their_slice(run, exc, match):
    """What the mesh does not cover refuses, naming the slice it waits
    for; a --mesh-data or --mesh-model the world does not have names the
    numbers."""
    with pytest.raises(exc, match=match):
        run()


# ---------------------------------------------------------------------------
# The CLIs under torchrun
# ---------------------------------------------------------------------------

DIM, Z_DIM = 16, 32


def _cli_args(tmp, datadir, tag, *extra):
    return ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", datadir,
            "--dim", str(DIM), "--z-dim", str(Z_DIM), "--batch-size", "4", "--epochs", "1",
            "--max-batches-per-epoch", "3", "--log-interval", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp / tag / "models"),
            "--sampledir", str(tmp / tag / "results"), *extra]


def _torchrun(module, args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(WORLD), "-m", module, *args]
    out = subprocess.run(cmd, cwd=REPO, env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_cli_main_and_evaluate_over_two_ranks_match_one_rank(tmp_path, capsys):
    from test_torch_cli_train import _corpus

    os.makedirs(tmp_path / "corpus")
    datadir = _corpus(tmp_path / "corpus", n=24)
    main.main(_cli_args(tmp_path, datadir, "one"))
    _torchrun("neural_sound_generation_tpu_torch.cli.main",
              _cli_args(tmp_path, datadir, "two", "--mesh-data", str(WORLD)))
    sub = os.path.join("vqvae", f"checkpoint_ljspeech_{DIM}_{Z_DIM}")
    ckpts = {tag: os.path.join(tmp_path, tag, "models", sub) for tag in ("one", "two")}
    assert checkpoint.latest_step(ckpts["one"]) == checkpoint.latest_step(ckpts["two"]) == 3
    states = {tag: torch.load(os.path.join(d, "step_3", "state.pt"), weights_only=True)
              for tag, d in ckpts.items()}
    one, two = states["one"], states["two"]
    assert one.keys() == two.keys()
    m = [k for k in one if k.startswith("opt_state/m/")]
    m_one, m_two = (torch.cat([s[k].reshape(-1) for k in m]) for s in (one, two))
    assert float((m_two - m_one).norm()) <= GRAD_REL * float(m_one.norm())
    for key, want in one.items():
        got = two[key]
        if key.startswith(("params/", "ema_params/")):
            limit = 2 * LR * 3 if key.endswith(".bias") else 1e-5
            assert float((got - want).abs().max()) <= limit, key
        elif key.startswith("batch_stats/"):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4, msg=key)
        elif key in ("step", "opt_state/count"):
            assert torch.equal(got, want), key
    # rank 0 alone wrote the metrics: one train and one test record
    records = {tag: [json.loads(line) for line in open(
        tmp_path / tag / "results" / "ljspeech" / "metrics.jsonl")] for tag in ckpts}
    assert [r["phase"] for r in records["two"]] == ["train", "test"]
    for one, two in zip(records["one"], records["two"]):
        assert two["loss"] == pytest.approx(one["loss"], rel=1e-4)

    # cli.evaluate on the one-rank checkpoint: one JSON line from rank 0,
    # the gathered reconstruction in --dump-npy
    ev = ["--datadir", datadir, "--ckpt-dir", ckpts["one"], "--dim", str(DIM), "--z-dim",
          str(Z_DIM), "--batch-size", "4", "--max-batches", "2", "--device", "cpu"]
    capsys.readouterr()
    want = evaluate.main(ev + ["--dump-npy", str(tmp_path / "one.npy")])
    printed = _torchrun("neural_sound_generation_tpu_torch.cli.evaluate",
                        ev + ["--mesh-data", str(WORLD), "--dump-npy", str(tmp_path / "two.npy")])
    lines = [json.loads(line) for line in printed.splitlines() if line.startswith("{")]
    assert len(lines) == 1 and lines[0].keys() == want.keys()
    for k, v in want.items():
        assert lines[0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    np.testing.assert_allclose(np.load(tmp_path / "two.npy"), np.load(tmp_path / "one.npy"),
                               atol=1e-5)

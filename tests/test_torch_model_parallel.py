"""Tensor parallelism (the mesh's ``model`` axis) for the flat VQ-VAE on the CPU.

Two gloo launches, (data 1 x model 2) and (data 2 x model 2), join through
``file://`` rendezvous in the test's directories (one spawn per world size
for the module), run every case of ``tests/torch_tp_worker.py``, and each
case is held against the same case function run here with no mesh: the
port's one-rank step. The flagship step is also held against the JAX
package's step on ``make_mesh(n_data=1|2, n_model=2)`` over the conftest's
virtual CPU devices, with the per-leaf optax chain JAX takes under tensor
parallelism. ``cli.main`` and ``cli.evaluate --mesh-model 2`` run under
``torchrun`` on two ranks against one rank.

Tolerances, with their reasons:
  * every gathered value bit-equal on every rank (one set of all-reduce
    results feeds the same kernels), the local buffers bit-equal across a
    data group, and the replicated leaves across a model group;
  * losses, perplexities 1e-5 relative (the issue's bound); bf16 losses
    2e-2 (each rank's convolutions round their own channels' sums);
  * the flat gradient within 1e-5 of the one-rank gradient's norm
    (relative to the norm: a convolution bias ahead of a BatchNorm has a
    true gradient of 0 and a computed one of rounding noise);
  * parameters, moments, the EMA codebook and BatchNorm statistics after
    steps from warm moments as ``test_torch_data_parallel.py`` holds them
    (1e-5 relative and 1e-6 absolute, or 2e-6 of the tensor's largest);
  * the sharded search's indices equal the whole codebook's (inputs and
    codes of small integers: every score is exact, so the order of sums
    cannot move a tie); a checkpoint's round trip between M 1 and M 2
    bit-exact;
  * against JAX: the loss 1e-5 relative, gradients 2e-4 of the largest
    gradient (JAX's BatchNorm takes E[x^2] - E[x]^2), the codebook 1e-6.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.flatten_util import ravel_pytree

import torch_tp_worker as worker
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu.parallel import make_mesh as jax_make_mesh
from neural_sound_generation_tpu.parallel import shard_batch as jax_shard_batch
from neural_sound_generation_tpu.parallel.mesh import model_param_shardings as jax_shardings
from neural_sound_generation_tpu.training import sharding as jsharding
from neural_sound_generation_tpu.training import train_state as jts
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import evaluate, main, prior, vocoder
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.ops import vq as vq_ops
from neural_sound_generation_tpu_torch.parallel import mesh as port_mesh
from neural_sound_generation_tpu_torch.training import checkpoint, sharding, train_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)  # (data 1 x model 2), (data 2 x model 2)
N_MODEL = 2
LOSS_RTOL, GRAD_REL, CODEBOOK_ATOL, STAT_ATOL, STAT_RTOL = 1e-5, 1e-5, 1e-6, 1e-6, 1e-5
SUM_FRAC, JAX_GRAD_FRAC, BF16_LOSS_RTOL = 2e-6, 2e-4, 2e-2
DIM, Z_DIM = worker.DIM, worker.Z_DIM


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _jax_pair():
    """The flagship VQ-VAE at dim 16 / 32 codes in JAX, its codebook drawn
    from train-mode encoder outputs (every code in reach)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, (8, 16, 16, 1)).astype(np.float32)
    jm = JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                                   train=False))
    (_, z_e, _), _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ze = np.asarray(z_e).reshape(-1, DIM)
    pick = rng.choice(ze.shape[0], Z_DIM, replace=False)
    v["params"]["codebook"] = (ze[pick] + 0.05 * rng.standard_normal(
        (Z_DIM, DIM))).astype(np.float32)
    return jm, v, x


def _search_inputs(rng):
    """Small-integer rows and codes (exact scores); code 3 repeated as code
    20 (the other shard at M 2 and 4) and as code 9 (the same shard at M 2,
    another at M 4), rows 0-3 equal to it, row 4 all NaN."""
    cb = rng.integers(-4, 5, (32, 8)).astype(np.float32)
    cb[20] = cb[9] = cb[3]
    x = rng.integers(-4, 5, (40, 8)).astype(np.float32)
    x[:4] = cb[3]
    x[4] = np.nan
    return torch.from_numpy(x), torch.from_numpy(cb)


def _inputs(v, x, work) -> dict:
    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    rvq = VQVAE(1, DIM, Z_DIM, num_quantizers=2, generator=torch.Generator().manual_seed(4))
    sx, scb = _search_inputs(rng)
    return {"x": t(x), "x2": t(rng.uniform(0.0, 1.0, x.shape).astype(np.float32)),
            "vqvae": dict(convert.flax_to_state_dict(v)), "rvq": dict(rvq.state_dict()),
            "search_x": sx, "search_cb": scb, "ckpt_m1": str(work / "ckpt_m1"),
            "work": str(work),
            "ema_cb": t(rng.standard_normal((Z_DIM, 8)).astype(np.float32)),
            "ema_cluster": t(rng.uniform(0.5, 2.0, Z_DIM).astype(np.float32)),
            "ema_esum": t(rng.standard_normal((Z_DIM, 8)).astype(np.float32)),
            "ema_x": t(rng.standard_normal((40, 8)).astype(np.float32)),
            "ema_idx": t(rng.integers(0, Z_DIM, 40).astype(np.int32)),
            # data rank 0's rows use codes 0-3, data rank 1's codes 0-19
            "codes": torch.cat([t(rng.integers(0, 4, (4, 7)).astype(np.int32)),
                                t(rng.integers(0, 20, (4, 7)).astype(np.int32))])}


def _spawn(work, world):
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"), str(r), str(world),
         str(N_MODEL), str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(world)]


def _wait(procs, what):
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what} rank {r} failed:\n{out}"


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp")
    jm, v, x = _jax_pair()
    inp = _inputs(v, x, work)
    # the one-rank checkpoint the ranks restore: the flagship state after a step
    _, _, state, _ = worker._step(inp, None)
    checkpoint.save(inp["ckpt_m1"], state, step=101, extra={"arch": "vqvae"})
    dirs = {w: work / f"w{w}" for w in WORLDS}
    procs = {}
    for w, d in dirs.items():
        d.mkdir()
        torch.save(inp, d / "inputs.pt")
        procs[w] = _spawn(d, w)
    one = {name: case(inp, None) for name, case in worker.CASES.items()}
    for w, p in procs.items():
        _wait(p, f"world {w}")
    ranks = {w: [torch.load(d / f"rank{r}.pt", weights_only=True) for r in range(w)]
             for w, d in dirs.items()}
    return {"ranks": ranks, "one": one, "jax": (jm, v, x), "inp": inp, "dirs": dirs}


def _assert_close(key, got, want, bf16=False):
    kind = key.split("/", 1)[0]
    if key in ("generator", "indices"):
        assert torch.equal(got, want), key
    elif kind in ("metric", "eval"):
        rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
        torch.testing.assert_close(got, want, rtol=rtol, atol=0, msg=key)
    elif kind == "restored":
        assert torch.equal(got, want), key
    elif kind == "grad" or bf16:
        return  # the whole gradient is held by its norm below; bf16 by its loss
    elif key in ("step", "opt_state/count"):
        assert torch.equal(got, want), key
    else:  # params, moments, EMA shadow, EMA codebook, BatchNorm statistics
        atol = max(STAT_ATOL, SUM_FRAC * float(want.abs().max()))
        torch.testing.assert_close(got.float(), want.float(), rtol=STAT_RTOL, atol=atol,
                                   msg=key)


def _grad(d: dict) -> torch.Tensor:
    return torch.cat([d[k].reshape(-1) for k in sorted(d) if k.startswith("grad/")])


CASE_IDS = [(w, c) for w in WORLDS for c in worker.CASES]


@pytest.mark.parametrize("world,case", CASE_IDS, ids=[f"w{w}-{c}" for w, c in CASE_IDS])
def test_tensor_parallel_ranks_compute_the_one_rank_step(tp, world, case):
    """Each case's gathered values bit-equal on every rank and equal to the
    one-rank run's; the flat gradient within 1e-5 of its norm."""
    ranks = [r[case] for r in tp["ranks"][world]]
    one = tp["one"][case]["whole"]
    assert ranks[0]["whole"].keys() == one.keys()
    for key, want in one.items():
        for r, rank in enumerate(ranks[1:], 1):
            assert torch.equal(rank["whole"][key], ranks[0]["whole"][key]), \
                f"{case} {key}: rank {r} differs from rank 0"
        _assert_close(key, ranks[0]["whole"][key], want, bf16=case == "bf16")
    if "grad/codebook" in one and case != "bf16":
        g1, g2 = _grad(one), _grad(ranks[0]["whole"])
        assert float((g2 - g1).norm()) <= GRAD_REL * float(g1.norm()), case
    if case == "search":
        idx = ranks[0]["whole"]["indices"]
        assert idx[:4].tolist() == [3, 3, 3, 3] and int(idx[4]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_local_buffers_agree_across_each_group(tp, world):
    """Everything a rank holds is bit-equal across its data group; its
    replicated leaves (past ``split_at``) across its model group."""
    for case in ("flagship", "ema_restart", "rvq", "bf16", "multistep"):
        locs = [r[case]["local"] for r in tp["ranks"][world]]
        for a in locs:
            for b in locs:
                (da, ma), (db, mb) = a["coord"].tolist(), b["coord"].tolist()
                if ma == mb:
                    for key in ("flat", "grad", "moments", "buffers"):
                        assert torch.equal(a[key], b[key]), f"{case} {key}: data group differs"
                if da == db:
                    cut = int(a["split_at"])
                    assert int(b["split_at"]) == cut and 0 < cut < a["flat"].numel()
                    for key in ("flat", "grad"):
                        assert torch.equal(a[key][cut:], b[key][cut:]), \
                            f"{case} {key}: replicated leaves differ in a model group"


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_only_its_shards(tp, world):
    """A rank's flat buffer, moments and EMA hold its slices of the split
    leaves and the replicated ones whole: about half the one-rank count."""
    one = tp["one"]["flagship"]["local"]
    for rank in tp["ranks"][world]:
        loc = rank["flagship"]["local"]
        assert one["flat"].numel() * 0.45 < loc["flat"].numel() < one["flat"].numel() * 0.55
        assert loc["moments"].numel() == 2 * loc["flat"].numel()


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_of_the_sharded_run_resumes_at_one_rank(tp, world):
    """Rank 0 wrote the whole tree from M 2; a one-rank state restores it
    and equals the ranks' gathered state bit for bit, and ``cli.serve``
    loads its weights without a mesh."""
    inp = tp["inp"]
    state = train_state.create_train_state(worker.vqvae(inp), worker.config().train)
    checkpoint.restore(str(tp["dirs"][world] / f"ckpt_w{world}"), state)
    got = checkpoint.state_tensors(state)
    want = worker.whole(worker._step(inp, None)[2])
    ranks_flagship = tp["ranks"][world][0]["flagship"]["whole"]
    for key, t in got.items():
        assert torch.equal(t, ranks_flagship[key]), key
        if key.startswith("params/"):
            torch.testing.assert_close(t, want[key], rtol=STAT_RTOL, atol=STAT_ATOL, msg=key)
    # cli.serve reads it without a mesh
    from neural_sound_generation_tpu_torch.cli import serve

    served = VQVAE(1, DIM, Z_DIM)
    serve.restore_weights(served, worker.config(), str(tp["dirs"][world] / f"ckpt_w{world}"),
                          ema=False)
    for name, p in served.named_parameters():
        assert torch.equal(p.detach(), ranks_flagship[f"params/{name}"]), name


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("num_quantizers", [1, 2])
def test_port_table_matches_jax_model_param_shardings(n_model, num_quantizers):
    """Every leaf JAX's ``model_param_shardings`` shards is sharded by the
    port on the same axis (through the weight bridge's layouts), the
    1-channel ``ConvTranspose_1`` stays whole, and the port's departures
    are a split layer's bias and the BatchNorm after it."""
    jm = JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM, num_quantizers=num_quantizers)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)), train=False)
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    specs = jax_shardings(v["params"], mesh, tensor_parallel=True)
    jax_axes = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        spec = tuple(sh.spec)
        if "model" in spec:
            jax_axes[jax.tree_util.keystr(path)] = spec.index("model")
    model = VQVAE(1, DIM, Z_DIM, num_quantizers=num_quantizers)
    port = port_mesh.model_param_shardings(model, n_model)
    mapped = {}
    for name, axis in port.items():
        path, to_torch = port_mesh.flax_leaf(model, name)
        mapped[path] = to_torch.index(axis)
    assert mapped == jax_axes
    assert "decoder.ConvTranspose_1.weight" not in port
    assert port["codebook"] == num_quantizers - 1
    layout = sharding.tensor_parallel_layout(model, n_model)
    extra = set(layout.params) - set(port)
    assert extra and all(k.endswith((".bias", ".weight")) and (
        ".BatchNorm_" in k or k.endswith(".bias")) for k in extra)
    assert "decoder.ConvTranspose_1.bias" not in layout.params
    assert set(layout.buffers) == {f"{n}.{s}" for n in layout.norms
                                   for s in ("running_mean", "running_var")}


@pytest.mark.parametrize("n_model", [2, 4])
def test_local_state_dict_is_the_sharded_modules_share(n_model):
    """``convert.local_state_dict`` of a converted JAX tree equals each
    rank's module after the state is sharded."""
    _, v, _ = _jax_pair()
    sd = convert.flax_to_state_dict(v)
    for rank in range(n_model):
        model = VQVAE(1, DIM, Z_DIM)
        model.load_state_dict(sd)
        layout = sharding.tensor_parallel_layout(model, n_model)
        sharding._shard_module(model, layout, rank, n_model)
        got = convert.local_state_dict(sd, VQVAE(1, DIM, Z_DIM), n_model, rank)
        want = model.state_dict()
        assert got.keys() == want.keys()
        for key in want:
            assert torch.equal(got[key], want[key]), key
        assert got["codebook"].shape == (Z_DIM // n_model, DIM)


@pytest.mark.parametrize("n_model", [2, 4])
def test_merge_of_shards_equals_the_whole_search(n_model):
    """In process: the shards' plain searches merged equal the whole
    codebook's, identical codes in other shards lose to the first, an
    all-NaN row gives 0."""
    x, cb = _search_inputs(np.random.default_rng(3))
    k = cb.shape[0] // n_model
    scores, idx = [], []
    for m in range(n_model):
        i, s = vq_ops.vq_kernel.nearest_codebook_indices(x, cb[m * k:(m + 1) * k].contiguous(),
                                                         return_scores=True)
        scores.append(s)
        idx.append(i.long() + m * k)
    got = vq_ops.merge_shards(torch.stack(scores), torch.stack(idx))
    want = vq_ops.vq_kernel.nearest_codebook_indices(x, cb)
    assert torch.equal(got, want)
    assert got[:4].tolist() == [3, 3, 3, 3] and int(got[4]) == 0


def _jax_tp_step(v, x, n_data):
    """JAX's flagship step on (n_data, model 2) with the per-leaf optax
    chain from warm moments: (loss, gradient in ravel order, codebook)."""
    jm = JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM)
    base = JaxConfig()
    jcfg = dataclasses.replace(
        base, train=dataclasses.replace(base.train, **worker.TRAIN),
        model=dataclasses.replace(base.model, dim=DIM, z_dim=Z_DIM, beta=0.25))
    model = VQVAE(1, DIM, Z_DIM)
    warm = worker.warm(train_state.create_train_state(model, worker.config().train))
    mu, nu = (convert.module_to_flax(model, warm.opt_state.named_moments(warm.flat, k))["params"]
              for k in ("m", "v"))
    state = jts.create_train_state(v, jcfg.train, fused=False)

    def put(entry):
        if isinstance(entry, optax.ScaleByAdamState):
            return optax.ScaleByAdamState(count=jnp.asarray(100, jnp.int32),
                                          mu=jax.tree_util.tree_map(jnp.asarray, mu),
                                          nu=jax.tree_util.tree_map(jnp.asarray, nu))
        if isinstance(entry, tuple) and not hasattr(entry, "_fields"):
            return tuple(put(e) for e in entry)
        return entry

    state = state.replace(step=jnp.asarray(100, jnp.int32), opt_state=put(state.opt_state))
    mesh = jax_make_mesh(n_data=n_data, n_model=N_MODEL)
    state_sh = jsharding.train_state_shardings(state, mesh, tensor_parallel=True)
    state = jsharding.shard_train_state(state, mesh, tensor_parallel=True)
    batch = jax_shard_batch({"x": jnp.asarray(x)}, mesh)
    loss_fn = jtrainer._vqvae_loss_fn(jm, jcfg.model.beta)
    (_, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.params, state.batch_stats, batch, None)
    step = jtrainer.make_train_step(jm, jcfg, mesh=mesh, donate=False, state_shardings=state_sh)
    key = jax.device_put(jax.random.PRNGKey(0), jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec()))
    jstate, metrics = step(state, batch, key)
    return (float(metrics["loss"]), np.asarray(ravel_pytree(grads)[0]),
            np.asarray(jstate.params["codebook"]))


@pytest.mark.parametrize("world", WORLDS)
def test_flagship_step_equals_the_jax_tensor_parallel_step(tp, world):
    """The ranks' step holds against JAX's GSPMD step on (world / 2, 2)."""
    jm, v, x = tp["jax"]
    loss, want_g, want_cb = _jax_tp_step(v, x, world // N_MODEL)
    got = tp["ranks"][world][0]["flagship"]["whole"]
    torch.testing.assert_close(float(got["metric/loss"]), loss, rtol=LOSS_RTOL, atol=0)
    model = VQVAE(1, DIM, Z_DIM)
    grads = {k[len("grad/"):]: t for k, t in got.items() if k.startswith("grad/")}
    got_g = convert.ravel_flax(convert.module_to_flax(model, grads)["params"])
    np.testing.assert_allclose(got_g, want_g, atol=JAX_GRAD_FRAC * np.abs(want_g).max())
    np.testing.assert_allclose(got["params/codebook"].numpy(), want_cb, atol=CODEBOOK_ATOL)


@pytest.mark.parametrize("run,exc,match", [
    (lambda: vocoder.main(["train", "--datadir", "x", "--mesh-model", "2", "--device", "cpu"]),
     SystemExit, r"--mesh-model 2: the model axis \(tensor parallel\) of 2 ranks needs a "
                 r"world of n_data x 2 ranks, but this run has 1"),
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch", "pixelcnn",
                         "--mesh-model", "4", "--mesh-data", "1", "--device", "cpu"]),
     SystemExit, r"--mesh-model 4: the model axis \(tensor parallel\) of 4 ranks needs a "
                 r"world of n_data x 4 ranks, but this run has 1: launch torchrun "
                 r"--nproc_per_node 4"),
    (lambda: main.main(["--model", "hiervqvae", "--mesh-model", "2", "--device", "cpu"]),
     SystemExit, r"--mesh-model 2: the model axis \(tensor parallel\) of 2 ranks needs a "
                 r"world of n_data x 2"),
    (lambda: main.main(["--model", "vqvae", "--mesh-model", "2", "--device", "cpu"]),
     SystemExit, r"--mesh-model 2: the model axis \(tensor parallel\) of 2 ranks needs a "
                 r"world of n_data x 2 ranks, but this run has 1"),
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch",
                         "transformer", "--mesh-model", "2", "--mesh-pipe", "2"]),
     SystemExit, r"--mesh-model 2 with --mesh-pipe 2: a mesh has a model axis or a pipe "
                 r"axis, not both"),
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch", "pixelcnn",
                         "--mesh-pipe", "2"]), SystemExit,
     r"--mesh-pipe stages the transformer prior's uniform block stack; use --arch "
     r"transformer"),
    (lambda: prior.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch",
                         "transformer", "--prior-layers", "3", "--mesh-pipe", "2"]),
     SystemExit, r"--prior-layers 3 does not stage evenly over --mesh-pipe 2"),
])
def test_model_axis_refusals_name_their_slice(run, exc, match):
    with pytest.raises(exc, match=match):
        run()


# ---------------------------------------------------------------------------
# The CLIs under torchrun
# ---------------------------------------------------------------------------


def _cli_args(tmp, datadir, tag, *extra):
    return ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", datadir,
            "--dim", str(DIM), "--z-dim", str(Z_DIM), "--batch-size", "4", "--epochs", "1",
            "--max-batches-per-epoch", "2", "--log-interval", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp / tag / "models"),
            "--sampledir", str(tmp / tag / "results"), *extra]


def _torchrun(module, args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(N_MODEL), "-m", module, *args]
    return subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_cli_main_and_evaluate_with_a_model_axis_match_one_rank(tmp_path, capsys):
    """``cli.main --mesh-model 2`` trains the one-rank run's steps (its
    checkpoint, whole, within the data-parallel CLI test's bounds of the
    one-rank one) and ``cli.evaluate --mesh-model 2`` reports the
    one-rank metrics within 1e-5."""
    import json

    from test_torch_cli_train import _corpus

    os.makedirs(tmp_path / "corpus")
    datadir = _corpus(tmp_path / "corpus", n=16)
    main.main(_cli_args(tmp_path, datadir, "one"))
    sub = os.path.join("vqvae", f"checkpoint_ljspeech_{DIM}_{Z_DIM}")
    ckpts = {tag: os.path.join(tmp_path, tag, "models", sub) for tag in ("one", "tp")}
    ev = ["--datadir", datadir, "--ckpt-dir", ckpts["one"], "--dim", str(DIM), "--z-dim",
          str(Z_DIM), "--batch-size", "4", "--max-batches", "2", "--device", "cpu"]
    procs = [_torchrun("neural_sound_generation_tpu_torch.cli.main",
                       _cli_args(tmp_path, datadir, "tp", "--mesh-model", str(N_MODEL))),
             _torchrun("neural_sound_generation_tpu_torch.cli.evaluate",
                       ev + ["--mesh-model", str(N_MODEL)])]
    capsys.readouterr()
    want = evaluate.main(ev)
    outs = []
    for p in procs:
        out = p.communicate(timeout=240)[0]
        assert p.returncode == 0, out
        outs.append(out)
    assert checkpoint.latest_step(ckpts["one"]) == checkpoint.latest_step(ckpts["tp"]) == 2
    one, two = (torch.load(os.path.join(d, "step_2", "state.pt"), weights_only=True)
                for d in (ckpts["one"], ckpts["tp"]))
    assert one.keys() == two.keys()
    for key, w in one.items():
        got = two[key]
        assert got.shape == w.shape, key
        if key.startswith(("params/", "ema_params/")):
            limit = 2 * worker.TRAIN["initial_learning_rate"] * 2 if key.endswith(".bias") \
                else 1e-5
            assert float((got - w).abs().max()) <= limit, key
        elif key in ("step", "opt_state/count"):
            assert torch.equal(got, w), key
    lines = [json.loads(line) for line in outs[1].splitlines() if line.startswith("{")]
    assert len(lines) == 1 and lines[0].keys() == want.keys()
    for k, v in want.items():
        assert lines[0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k

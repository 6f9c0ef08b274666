"""Tensor parallelism (the mesh's ``model`` axis) for the transformer prior
on the CPU: Megatron's layout for the dense blocks, expert parallelism for
the routed ones.

Three gloo launches, (data 1 x model 2), (data 2 x model 2) and (data 1 x
model 4), join through ``file://`` rendezvous in the test's directories,
run every case of ``tests/torch_prior_tp_worker.py`` inside
``distributed.process_group`` and report their native threads after it;
each case is held against the same case function run here with no mesh:
the port's one-rank step. The dense and the routed step are also held
against the JAX package's step on ``make_mesh(n_data=1|2, n_model=2)``
over the conftest's virtual CPU devices. ``cli.prior train --mesh-model 2``
runs under ``torchrun`` against one rank, and its checkpoint samples on
one rank.

Tolerances, with their reasons:
  * every gathered value bit-equal on every rank (one set of all-reduce
    results feeds the same arithmetic), the local buffers bit-equal across
    a data group, and the replicated leaves across a model group;
  * losses 1e-5 relative; bf16 losses 2e-2 (each rank rounds its own
    heads' and features' partial products to bf16, and a routing decision
    on a bf16 near-tie may go the other way);
  * the flat gradient within 1e-4 of the one-rank gradient's norm (a
    row-split product sums its partials over the ranks in another order);
  * parameters, moments and the EMA after a step from warm moments 1e-5
    relative and 1e-6 absolute, or 2e-6 of the tensor's largest;
  * a checkpoint's round trip between M 1 and M 2 bit-exact;
  * against JAX: the loss 1e-5 relative, gradients 2e-4 of the largest
    gradient;
  * the CLI's checkpoint after two steps 1e-5 absolute (steps of lr 1e-3
    from cold moments); the qkv bias 2 lr a step: its key third has a true
    gradient of zero (adding a constant to every key adds one constant to
    a query's scores, which the softmax drops), so its computed gradient
    is rounding noise, whose sign Adam's first steps turn into +-lr.
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

import torch_prior_tp_worker as worker
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import transformer_prior as jtp
from neural_sound_generation_tpu.parallel import make_mesh as jax_make_mesh
from neural_sound_generation_tpu.parallel import shard_batch as jax_shard_batch
from neural_sound_generation_tpu.parallel.mesh import model_param_shardings as jax_shardings
from neural_sound_generation_tpu.training import sharding as jsharding
from neural_sound_generation_tpu.training import train_state as jts
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import prior as prior_cli
from neural_sound_generation_tpu_torch.models import VQVAE, TransformerPrior
from neural_sound_generation_tpu_torch.parallel import mesh as port_mesh
from neural_sound_generation_tpu_torch.training import checkpoint, sharding, train_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the gloo launches: id -> (world, n_model)
LAUNCHES = {"w2": (2, 2), "w4": (4, 2), "w4m4": (4, 4)}
LOSS_RTOL, GRAD_REL, STAT_ATOL, STAT_RTOL, SUM_FRAC = 1e-5, 1e-4, 1e-6, 1e-5, 2e-6
JAX_GRAD_FRAC, BF16_LOSS_RTOL, CLI_ATOL = 2e-4, 2e-2, 1e-5
BF16_CASES = ("bf16", "routed_bf16")


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _jax_prior(kind):
    n_experts, cond_dim = worker.KINDS[kind]
    return jtp.TransformerPrior(input_dim=worker.K, dim=worker.DIM, n_layers=worker.LAYERS,
                                n_heads=worker.HEADS, n_classes=worker.CLASSES,
                                n_experts=n_experts, spatial_cond=cond_dim > 0, max_rows=8,
                                max_cols=8)


def _batch(rng):
    return {"codes": rng.integers(0, worker.K, (worker.B, worker.H, worker.W)).astype(np.int32),
            "labels": rng.integers(0, worker.CLASSES, worker.B).astype(np.int32),
            "cond": rng.standard_normal((worker.B, worker.H, worker.W,
                                         worker.COND)).astype(np.float32)}


def _variables(kind):
    """Each kind's weights as flax variables: the port's seeded init,
    through the bridge (flax's eager init of three priors costs seconds)."""
    n_experts, cond_dim = worker.KINDS[kind]
    model = TransformerPrior(worker.K, worker.DIM, worker.LAYERS, worker.HEADS,
                             worker.CLASSES, n_experts=n_experts, spatial_cond=cond_dim > 0,
                             cond_dim=cond_dim, max_rows=8, max_cols=8,
                             generator=torch.Generator().manual_seed(len(kind)))
    return {"params": convert.module_to_flax(model)["params"]}


def _inputs(work):
    rng = np.random.default_rng(0)
    b = _batch(rng)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    variables = {kind: _variables(kind) for kind in worker.KINDS}
    inp = {kind: dict(convert.flax_to_state_dict(v)) for kind, v in variables.items()}
    inp.update({k: t(v) for k, v in b.items()})
    inp["codes2"] = t(rng.integers(0, worker.K, b["codes"].shape).astype(np.int32))
    inp["ckpt_m1"], inp["work"] = str(work / "ckpt_m1"), str(work)
    return inp, variables, b


def _spawn(work, world, n_model):
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_prior_tp_worker.py"), str(r),
         str(world), str(n_model), str(work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env()) for r in range(world)]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    work = tmp_path_factory.mktemp("prior_tp")
    inp, variables, b = _inputs(work)
    # the one-rank checkpoint the ranks restore: the dense state after a step
    _, _, state, _ = worker._step(inp, None)
    checkpoint.save(inp["ckpt_m1"], state, step=101, extra={"arch": "transformer"})
    dirs = {key: work / key for key in LAUNCHES}
    procs = {}
    for key, d in dirs.items():
        d.mkdir()
        torch.save(inp, d / "inputs.pt")
        procs[key] = _spawn(d, *LAUNCHES[key])
    one = {name: case(inp, None) for name, case in worker.CASES.items()}
    threads = {}
    for key, ps in procs.items():
        try:
            outs = [p.communicate(timeout=240)[0] for p in ps]
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(ps, outs)):
            assert p.returncode == 0, f"launch {key} rank {r} failed:\n{out}"
        threads[key] = [json.loads([line for line in out.splitlines()
                                    if line.startswith('{"threads"')][-1])["threads"]
                        for out in outs]
    ranks = {key: [torch.load(d / f"rank{r}.pt", weights_only=True)
                   for r in range(LAUNCHES[key][0])] for key, d in dirs.items()}
    return {"ranks": ranks, "one": one, "inp": inp, "dirs": dirs, "threads": threads,
            "variables": variables, "batch": b}


def _assert_close(key, got, want, bf16=False):
    kind = key.split("/", 1)[0]
    if kind in ("metric", "eval"):
        if key.endswith("grad_norm") and bf16:
            return
        rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
        torch.testing.assert_close(got, want, rtol=rtol, atol=0, msg=key)
    elif kind == "restored" or key in ("step", "opt_state/count"):
        assert torch.equal(got, want), key
    elif kind == "grad" or bf16:
        return  # the whole gradient is held by its norm below; bf16 by its loss
    else:  # params, moments, the EMA shadow
        atol = max(STAT_ATOL, SUM_FRAC * float(want.abs().max()))
        torch.testing.assert_close(got.float(), want.float(), rtol=STAT_RTOL, atol=atol,
                                   msg=key)


def _grad(d: dict) -> torch.Tensor:
    return torch.cat([d[k].reshape(-1) for k in sorted(d) if k.startswith("grad/")])


CASE_IDS = [(key, c) for key in LAUNCHES for c in worker.CASES]


@pytest.mark.parametrize("launch,case", CASE_IDS, ids=[f"{k}-{c}" for k, c in CASE_IDS])
def test_ranks_compute_the_one_rank_prior_step(tp, launch, case):
    """Each case's gathered values bit-equal on every rank and equal to the
    one-rank run's; the flat gradient within 1e-4 of its norm."""
    ranks = [r[case] for r in tp["ranks"][launch]]
    one = tp["one"][case]["whole"]
    bf16 = case in BF16_CASES
    assert ranks[0]["whole"].keys() == one.keys()
    for key, want in one.items():
        for r, rank in enumerate(ranks[1:], 1):
            assert torch.equal(rank["whole"][key], ranks[0]["whole"][key]), \
                f"{case} {key}: rank {r} differs from rank 0"
        _assert_close(key, ranks[0]["whole"][key], want, bf16=bf16)
    if "grad/bos" in one and not bf16:
        g1, g2 = _grad(one), _grad(ranks[0]["whole"])
        assert float((g2 - g1).norm()) <= GRAD_REL * float(g1.norm()), case


@pytest.mark.parametrize("launch", LAUNCHES)
def test_prior_local_buffers_agree_across_each_group(tp, launch):
    """Everything a rank holds is bit-equal across its data group; its
    replicated leaves (past ``split_at``) across its model group."""
    for case in ("dense", "routed", "bf16", "routed_bf16", "bottom", "multistep"):
        locs = [r[case]["local"] for r in tp["ranks"][launch]]
        for a in locs:
            for b in locs:
                (da, ma), (db, mb) = a["coord"].tolist(), b["coord"].tolist()
                if ma == mb:
                    for key in ("flat", "grad", "moments"):
                        assert torch.equal(a[key], b[key]), f"{case} {key}: data group differs"
                if da == db:
                    cut = int(a["split_at"])
                    assert int(b["split_at"]) == cut and 0 < cut < a["flat"].numel()
                    for key in ("flat", "grad"):
                        assert torch.equal(a[key][cut:], b[key][cut:]), \
                            f"{case} {key}: replicated leaves differ in a model group"


@pytest.mark.parametrize("launch", LAUNCHES)
@pytest.mark.parametrize("kind", ["dense", "routed"])
def test_each_prior_rank_holds_only_its_share(tp, launch, kind):
    """A rank's flat buffer holds 1/M of each split leaf and the
    replicated leaves whole (its alignment padding aside); its moments
    mirror it."""
    n_model = LAUNCHES[launch][1]
    model = worker.prior(tp["inp"], kind)
    layout = sharding.tensor_parallel_layout(model, n_model)
    want = sum(p.numel() // (n_model if n in layout.params else 1)
               for n, p in model.named_parameters())
    n_leaves = len(list(model.parameters()))
    for rank in tp["ranks"][launch]:
        loc = rank[kind]["local"]
        assert want <= loc["flat"].numel() <= want + 4 * n_leaves
        assert loc["moments"].numel() == 2 * loc["flat"].numel()
    one = tp["one"][kind]["local"]["flat"].numel()
    assert loc["flat"].numel() < (0.6 if n_model == 2 else 0.5) * one


@pytest.mark.parametrize("launch", LAUNCHES)
def test_no_gloo_thread_outlives_the_process_group(tp, launch):
    """``distributed.process_group``'s teardown joins every gloo worker
    and transport thread: a gloo worker still alive at interpreter exit
    that frees a Python-owned tensor aborts the process (``terminate called
    without an active exception``)."""
    for r, names in enumerate(tp["threads"][launch]):
        assert not [n for n in names if "gloo" in n], f"rank {r}: {names}"


@pytest.mark.parametrize("launch", LAUNCHES)
def test_prior_checkpoint_of_the_sharded_run_resumes_at_one_rank(tp, launch):
    """Rank 0 wrote the whole tree from M 2 or 4; a one-rank state restores
    it and equals the ranks' gathered state bit for bit."""
    inp = tp["inp"]
    state = train_state.create_train_state(worker.prior(inp, "dense"), worker.config().train)
    world = LAUNCHES[launch][0]
    checkpoint.restore(str(tp["dirs"][launch] / f"ckpt_w{world}"), state)
    got = checkpoint.state_tensors(state)
    ranks_dense = tp["ranks"][launch][0]["dense"]["whole"]
    for key, t in got.items():
        assert torch.equal(t, ranks_dense[key]), key


def _jax_tp_step(kind, variables, batch, n_data):
    """The loss and gradient (in ravel order) of JAX's train step on
    (n_data, model 2): its loss function under jit on the state its CLI
    places under --mesh-model (the per-leaf optax state, parameters
    sharded by ``train_state_shardings``) and the batch sharded over
    'data'."""
    jm = _jax_prior(kind)
    base = JaxConfig()
    jcfg = dataclasses.replace(base, train=dataclasses.replace(base.train, **worker.TRAIN))
    state = jts.create_train_state(variables, jcfg.train, fused=False)
    mesh = jax_make_mesh(n_data=n_data, n_model=2)
    state_sh = jsharding.train_state_shardings(state, mesh, tensor_parallel=True)
    state = jsharding.shard_train_state(state, mesh, tensor_parallel=True)
    b = {"codes": batch["codes"], "labels": batch["labels"]}
    if worker.KINDS[kind][1]:
        b["cond"] = batch["cond"]
    b = jax_shard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh)
    loss_fn = jtrainer._pixelcnn_loss_fn(jm)
    (_, (metrics, _, _)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True),
        in_shardings=(state_sh.params, state_sh.batch_stats, None, None))(
        state.params, state.batch_stats, b, None)
    return float(metrics["loss"]), np.asarray(ravel_pytree(grads)[0])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "routed"])
def test_prior_step_equals_the_jax_tensor_parallel_step(tp, world, kind):
    """The ranks' step holds against JAX's GSPMD step on (world / 2, 2)."""
    loss, want_g = _jax_tp_step(kind, tp["variables"][kind], tp["batch"], world // 2)
    got = tp["ranks"][f"w{world}"][0][kind]["whole"]
    torch.testing.assert_close(float(got["metric/loss"]), loss, rtol=LOSS_RTOL, atol=0)
    model = worker.prior(tp["inp"], kind)
    grads = {k[len("grad/"):]: t for k, t in got.items() if k.startswith("grad/")}
    got_g = convert.ravel_flax(convert.module_to_flax(model, grads)["params"])
    np.testing.assert_allclose(got_g, want_g, atol=JAX_GRAD_FRAC * np.abs(want_g).max())


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("kind", list(worker.KINDS))
def test_port_prior_table_matches_jax_model_param_shardings(n_model, kind):
    """The port's table is JAX's ``model_param_shardings`` through the
    bridge's layouts; its layout departs only as ``training.sharding``
    says: the column splits' biases split, the attention whole where the
    heads do not divide (2 heads at M 4)."""
    batch = _batch(np.random.default_rng(0))
    args = [jnp.asarray(batch["codes"]), jnp.asarray(batch["labels"])]
    if worker.KINDS[kind][1]:
        args.append(jnp.asarray(batch["cond"]))
    # flax's own tree (names and shapes), traced without computing it
    shapes = jax.eval_shape(_jax_prior(kind).init, jax.random.PRNGKey(0), *args)["params"]
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    specs = jax_shardings(shapes, mesh, tensor_parallel=True)
    jax_axes = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        spec = tuple(sh.spec)
        if "model" in spec:
            jax_axes[jax.tree_util.keystr(path)] = spec.index("model")
    model = worker.prior({kind: convert.flax_to_state_dict(_variables(kind))}, kind)
    port = port_mesh.model_param_shardings(model, n_model)
    mapped = {}
    for name, axis in port.items():
        path, to_torch = port_mesh.flax_leaf(model, name)
        mapped[path] = to_torch.index(axis)
    assert mapped == jax_axes
    layout = sharding.tensor_parallel_layout(model, n_model)
    attention = {f"block_{i}.{leaf}" for i in range(worker.LAYERS)
                 for leaf in ("attn_qkv.weight", "attn_out.weight")}
    whole_heads = worker.HEADS % n_model == 0
    assert attention <= set(port)
    assert (attention <= set(layout.params)) == whole_heads
    for name, axis in layout.params.items():
        if name.endswith(".bias") and ".moe." not in name:
            assert name[:-len("bias")] + "weight" in layout.params and axis == 0, name
            prefix = name[:-len(".bias")]
            assert prefix == "cond_proj" or layout.linears[prefix] == "columns", name
        else:
            assert port[name] == axis, name
    missing = set(port) - set(layout.params)
    assert missing == (set() if whole_heads else attention)
    for name in ("attn_out", "mlp_out"):
        for i in range(worker.LAYERS):
            assert f"block_{i}.{name}.bias" not in layout.params
    if kind == "routed":
        assert layout.experts == [f"block_{i}.moe" for i in range(worker.LAYERS)]
        assert not any(".router." in n for n in layout.params)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("heads", [2, 4])
def test_qkv_split_is_head_aligned_and_round_trips(n_model, heads):
    """Rank r's ``attn_qkv`` rows are the q, k and v rows of heads [r H / M,
    (r + 1) H / M) with their biases; the ranks' slices put back in their
    blocks give the whole tree again. Where the heads do not divide (2 at
    M 4) the attention is whole on every rank while the MLP and the
    embeddings split."""
    model = TransformerPrior(worker.K, worker.DIM, worker.LAYERS, heads, worker.CLASSES,
                             max_rows=8, max_cols=8, generator=torch.Generator().manual_seed(0))
    sd = model.state_dict()
    parts = [convert.local_state_dict(sd, model, n_model, r) for r in range(n_model)]
    d, c = worker.DIM, worker.DIM // n_model
    assert all(p["block_0.mlp_in.weight"].shape[0] == 4 * d // n_model for p in parts)
    assert all(p["tok_embed.weight"].shape[1] == c for p in parts)
    for r, p in enumerate(parts):
        for leaf in ("weight", "bias"):
            whole = sd[f"block_0.attn_qkv.{leaf}"]
            want = whole if heads % n_model else torch.cat(
                [whole[j * d + r * c:j * d + (r + 1) * c] for j in range(3)])
            assert torch.equal(p[f"block_0.attn_qkv.{leaf}"], want), (r, leaf)
    layout = sharding.tensor_parallel_layout(model, n_model)
    for name, axis in layout.params.items():
        g = layout.groups.get(name, 1)
        blocks = [p[name].unflatten(axis, (g, -1)) for p in parts]
        assert torch.equal(torch.cat(blocks, dim=axis + 1).flatten(axis, axis + 1), sd[name]), \
            name


def test_pixelcnn_and_pipe_refusals_still_name_their_slice():
    """Both priors take --mesh-model (on one rank the mesh policy asks for
    two); a model axis with a pipe axis refuses, for either."""
    both = r"--mesh-model 2 with --mesh-pipe 2: a mesh has a model axis or a pipe axis"
    with pytest.raises(SystemExit, match=both):
        prior_cli.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch", "pixelcnn",
                        "--mesh-model", "2", "--mesh-pipe", "2"])
    with pytest.raises(SystemExit, match=r"--mesh-model 2: the model axis \(tensor parallel\)"):
        prior_cli.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch", "pixelcnn",
                        "--mesh-model", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match=both):
        prior_cli.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch",
                        "transformer", "--mesh-model", "2", "--mesh-pipe", "2"])
    with pytest.raises(SystemExit, match=r"--mesh-model 2: the model axis \(tensor parallel\)"):
        prior_cli.main(["train", "--datadir", "x", "--vqvae-ckpt", "y", "--arch",
                        "transformer", "--mesh-model", "2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# The CLI under torchrun
# ---------------------------------------------------------------------------

VQ_DIM, VQ_CODES = 16, 32


def _prior_args(datadir, vq_ckpt, ckpt, *extra):
    return ["train", "--datadir", datadir, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir", ckpt,
            "--arch", "transformer", "--prior-dim", str(worker.DIM), "--prior-layers",
            str(worker.LAYERS), "--prior-heads", str(worker.HEADS), "--dim", str(VQ_DIM),
            "--z-dim", str(VQ_CODES), "--batch-size", "4", "--epochs", "1",
            "--max-batches-per-epoch", "2", "--lr", "1e-3", "--device", "cpu", *extra]


def test_cli_prior_train_with_a_model_axis_matches_one_rank(tmp_path, capsys):
    """``cli.prior train --arch transformer --mesh-model 2`` trains the
    one-rank run's steps: its whole checkpoint within 1e-5 of the one-rank
    one, step and count equal; ``cli.prior sample`` draws from it on one
    rank."""
    from test_torch_cli_train import _corpus

    os.makedirs(tmp_path / "corpus")
    datadir = _corpus(tmp_path / "corpus", n=16)
    vq_ckpt = str(tmp_path / "vqvae")
    vq = VQVAE(1, VQ_DIM, VQ_CODES, generator=torch.Generator().manual_seed(3))
    checkpoint.save(vq_ckpt, train_state.create_train_state(vq, worker.config().train), step=1,
                    extra={"arch": "vqvae", "num_quantizers": 1})
    ckpts = {tag: str(tmp_path / tag / "prior") for tag in ("one", "tp")}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", "neural_sound_generation_tpu_torch.cli.prior",
           *_prior_args(datadir, vq_ckpt, ckpts["tp"], "--mesh-model", "2")]
    proc = subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    prior_cli.main(_prior_args(datadir, vq_ckpt, ckpts["one"]))
    out = proc.communicate(timeout=240)[0]
    assert proc.returncode == 0, out
    assert "(tensor parallel)" in out
    for sub in ("", "_ema", "_train"):
        assert checkpoint.latest_step(ckpts["one"] + sub) == 2
        assert checkpoint.latest_step(ckpts["tp"] + sub) == 2
    one, two = (torch.load(os.path.join(d + "_train", "step_2", "state.pt"), weights_only=True)
                for d in (ckpts["one"], ckpts["tp"]))
    assert one.keys() == two.keys()
    for key, want in one.items():
        got = two[key]
        assert got.shape == want.shape, key
        if key.startswith(("params/", "ema_params/")):
            limit = 2 * 1e-3 * 2 if key.endswith("attn_qkv.bias") else CLI_ATOL
            assert float((got - want).abs().max()) <= limit, key
        elif key in ("step", "opt_state/count"):
            assert torch.equal(got, want), key
    artifact = torch.load(os.path.join(ckpts["tp"], "step_2", "state.pt"), weights_only=True)
    for key, t in artifact.items():
        assert torch.equal(t, two[key]), key
    capsys.readouterr()
    prior_cli.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpts["tp"] + "_ema",
                    "--output-dir", str(tmp_path / "samples"), "--arch", "transformer",
                    "--prior-dim", str(worker.DIM), "--prior-layers", str(worker.LAYERS),
                    "--prior-heads", str(worker.HEADS), "--dim", str(VQ_DIM), "--z-dim",
                    str(VQ_CODES), "--code-shape", "20", "2", "--num-samples", "2",
                    "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "samples")) == [
        "prior_sample_000.wav", "prior_sample_001.wav"]

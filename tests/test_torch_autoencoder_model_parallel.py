"""Tensor parallelism (the mesh's ``model`` axis) for HierVQVAE, WaveVQVAE
and the VAE on the CPU.

Two gloo launches join through ``file://`` rendezvous in the test's
directories and run every case of ``tests/torch_ae_tp_worker.py``: a world
of 2 on (data 1 x model 2), a world of 4 on (data 2 x model 2) and then
(data 1 x model 4), which restores the checkpoint its M-2 mesh wrote and
leaves the bf16, multi-step and noise cases to the M-2 meshes. Each
case is held against the same case function run here with no mesh: the
port's one-rank step. The HierVQVAE and raw WaveVQVAE steps are also held
against the JAX package's gradient and loss on ``make_mesh(n_data=1|2,
n_model=2)`` over the conftest's virtual CPU devices, and each family's
table against JAX's ``model_param_shardings``. ``cli.main`` then
``cli.evaluate --mesh-model 2`` run the WaveVQVAE under ``torchrun`` on two
ranks against one rank.

Tolerances, with their reasons:
  * every gathered value bit-equal on every rank (one set of all-reduce
    results feeds the same arithmetic), the local buffers bit-equal across
    a data group, and the replicated leaves across a model group; the
    VAE's noise bit-equal to the one-rank draw;
  * losses and perplexities 1e-5 relative; the bf16 hierarchy's loss 2e-2
    (each rank's convolutions round their own channels' sums to bf16);
  * the flat gradient within 1e-5 of the one-rank gradient's norm (each
    rank's convolutions sum their own channels; a convolution bias ahead
    of a BatchNorm has a true gradient of 0 and a computed one of rounding
    noise);
  * parameters, moments, the EMA codebook and BatchNorm statistics after
    steps from warm moments 1e-5 relative and 1e-6 absolute, or 2e-6 of
    the tensor's largest (``test_torch_model_parallel.py``'s bounds);
  * a checkpoint's round trip between M 1, 2 and 4 bit-exact;
  * against JAX: the loss 1e-5 relative, gradients 2e-4 of the largest
    gradient (JAX's BatchNorm takes E[x^2] - E[x]^2);
  * the CLI's checkpoint after two steps 1e-5 absolute, a bias 2 lr a step
    (Adam's cold first steps turn a rounding-noise gradient into +-lr);
    ``cli.evaluate``'s means 1e-5 relative.
"""

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

import torch_ae_tp_worker as worker
from neural_sound_generation_tpu.models import HierVQVAE as JaxHierVQVAE
from neural_sound_generation_tpu.models import VAE as JaxVAE
from neural_sound_generation_tpu.models import WaveVQVAE as JaxWaveVQVAE
from neural_sound_generation_tpu.parallel import make_mesh as jax_make_mesh
from neural_sound_generation_tpu.parallel import shard_batch as jax_shard_batch
from neural_sound_generation_tpu.parallel.mesh import model_param_shardings as jax_shardings
from neural_sound_generation_tpu.parallel.mesh import replicated_sharding
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import evaluate, main
from neural_sound_generation_tpu_torch.models import VAE, HierVQVAE, WaveVQVAE
from neural_sound_generation_tpu_torch.parallel import mesh as port_mesh
from neural_sound_generation_tpu_torch.training import checkpoint, sharding

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: launch -> (world, the mesh tags it runs)
LAUNCHES = {"w2": (2, ("d1m2",)), "w4": (4, ("d2m2", "d1m4"))}
TAGS = ("d1m2", "d2m2", "d1m4")
LOSS_RTOL, GRAD_REL, STAT_ATOL, STAT_RTOL, SUM_FRAC, JAX_GRAD_FRAC = (
    1e-5, 1e-5, 1e-6, 1e-5, 2e-6, 2e-4)
BF16_LOSS_RTOL = 2e-2
CLI_ATOL = 1e-5
DIM, Z_DIM = worker.DIM, worker.Z_DIM
FAMILIES = ("hier", "hier_group", "wave_raw", "wave_mulaw", "wave_speaker", "vae")


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _model(family: str, seed: int = 0):
    """The family's port model, seeded, before the test's weights."""
    gen = torch.Generator().manual_seed(seed)
    if family in ("hier", "hier_group"):
        return HierVQVAE(1, DIM, Z_DIM, norm="group" if family == "hier_group" else "batch",
                         generator=gen)
    if family == "vae":
        return VAE(1, DIM, worker.VAE_Z, generator=gen)
    if family == "wave_mulaw":
        return WaveVQVAE(DIM, Z_DIM, worker.DOWN, input_type="mulaw-quantize",
                         quantize_channels=worker.QC, num_quantizers=2, generator=gen)
    if family == "wave_speaker":
        return WaveVQVAE(DIM, Z_DIM, worker.DOWN, n_speakers=worker.SPEAKERS,
                         gin_channels=worker.GIN, generator=gen)
    return WaveVQVAE(DIM, Z_DIM, worker.DOWN, generator=gen)


def _batches(rng) -> dict:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = {}
    for suffix in ("", "2"):
        out[f"hier_batch{suffix}"] = {
            "x": t(rng.uniform(0.0, 1.0, (8, 16, 24, 1)).astype(np.float32))}
        out[f"wave_batch{suffix}"] = {
            "x": t((0.3 * rng.standard_normal((8, 64, 1))).astype(np.float32)),
            "g": t(rng.integers(0, worker.SPEAKERS, 8).astype(np.int64))}
        out[f"mulaw_batch{suffix}"] = {
            "x": t(rng.integers(0, worker.QC, (8, 64)).astype(np.int64)),
            "input_lengths": t(rng.integers(40, 65, 8).astype(np.int64))}
        out[f"vae_batch{suffix}"] = {
            "x": t(rng.uniform(-1.0, 1.0, (8, 28, 28, 1)).astype(np.float32))}
    return out


def _inputs(work) -> dict:
    """The batches and each family's weights: seeded, with the hierarchy's
    and the raw wave model's codebooks drawn from their train-mode encoder
    outputs (every code in reach, codes in both shards chosen)."""
    inp = _batches(np.random.default_rng(0))
    for i, family in enumerate(FAMILIES):
        model = _model(family, seed=i)
        if family in ("hier", "wave_raw"):
            x = inp[f"{worker.BATCHES[family][0]}_batch"]["x"]
            main.apply_data_codebook_init(model, x, torch.Generator().manual_seed(i))
        inp[family] = dict(model.state_dict())
    for family in worker.SAVED:
        inp[f"ckpt_m1_{family}"] = str(work / f"ckpt_m1_{family}")
    inp["work"] = str(work)
    return inp


def _spawn(work, world):
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_ae_tp_worker.py"), str(r),
         str(world), str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(world)]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    work = tmp_path_factory.mktemp("ae_tp")
    inp = _inputs(work)
    # the one-rank checkpoints the ranks restore: each family's stepped state
    for family, meta in worker.SAVED.items():
        _, _, state, _ = worker._steps(inp, None, family, steps=2 if family in
                                       worker.EMA_FAMILIES else 1)
        checkpoint.save(inp[f"ckpt_m1_{family}"], state, step=101, extra=meta)
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


def _assert_close(key, got, want, bf16=False):
    kind = key.split("/", 1)[0]
    if key == "generator" or kind in ("restored", "from_m2") or key in (
            "step", "opt_state/count"):
        assert torch.equal(got, want), key
    elif kind in ("metric", "eval"):
        if not (bf16 and key.endswith("grad_norm")):
            rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
            torch.testing.assert_close(got, want, rtol=rtol, atol=0, msg=key)
    elif key == "noise":
        assert torch.equal(got, want), key
    elif kind == "grad" or bf16:
        return  # the whole gradient is held by its norm below; bf16 by its loss
    else:  # params, moments, EMA shadow, EMA codebook, BatchNorm statistics
        atol = max(STAT_ATOL, SUM_FRAC * float(want.abs().max()))
        torch.testing.assert_close(got.float(), want.float(), rtol=STAT_RTOL, atol=atol,
                                   msg=key)


def _grad(d: dict) -> torch.Tensor:
    return torch.cat([d[k].reshape(-1) for k in sorted(d) if k.startswith("grad/")])


CASE_IDS = [(t, c) for t in TAGS for c in worker.CASES
            if t != "d1m4" or c not in worker.M4_SKIPS]


@pytest.mark.parametrize("mesh,case", CASE_IDS, ids=[f"{t}-{c}" for t, c in CASE_IDS])
def test_ranks_compute_the_one_rank_step(tp, mesh, case):
    """Each case's gathered values bit-equal on every rank and equal to the
    one-rank run's; the flat gradient within 1e-5 of its norm."""
    ranks = [r[case] for r in tp["ranks"][mesh]]
    one = tp["one"][case]["whole"]
    want_keys = set(one)
    if case == "restore" and mesh == "d1m4":
        want_keys |= {k.replace("restored/", "from_m2/", 1) for k in one}
    assert set(ranks[0]["whole"]) == want_keys
    for key in ranks[0]["whole"]:
        for r, rank in enumerate(ranks[1:], 1):
            assert torch.equal(rank["whole"][key], ranks[0]["whole"][key]), \
                f"{case} {key}: rank {r} differs from rank 0"
        if key in one:
            _assert_close(key, ranks[0]["whole"][key], one[key], bf16=case == "hier_bf16")
    if any(k.startswith("grad/") for k in one) and case != "hier_bf16":
        g1, g2 = _grad(one), _grad(ranks[0]["whole"])
        assert float((g2 - g1).norm()) <= GRAD_REL * float(g1.norm()), case


@pytest.mark.parametrize("mesh", TAGS)
def test_local_buffers_agree_across_each_group(tp, mesh):
    """Everything a rank holds is bit-equal across its data group; its
    replicated leaves (past ``split_at``) across its model group; the
    VAE's whole buffer is replicated (``split_at`` 0) and its noise the
    same on a model group's ranks."""
    for case in ("hier", "hier_group", "hier_bf16", "wave_raw", "wave_mulaw", "wave_speaker",
                 "vae", "multistep"):
        if case not in tp["ranks"][mesh][0]:
            continue
        locs = [r[case]["local"] for r in tp["ranks"][mesh]]
        for a in locs:
            for b in locs:
                (da, ma), (db, mb) = a["coord"].tolist(), b["coord"].tolist()
                if ma == mb:
                    for key in ("flat", "grad", "moments", "buffers"):
                        assert torch.equal(a[key], b[key]), f"{case} {key}: data group differs"
                if da == db:
                    cut = int(a["split_at"])
                    assert int(b["split_at"]) == cut
                    assert cut == 0 if case == "vae" else 0 < cut < a["flat"].numel()
                    for key in ("flat", "grad"):
                        assert torch.equal(a[key][cut:], b[key][cut:]), \
                            f"{case} {key}: replicated leaves differ in a model group"
    noise = [r["vae_noise"]["local"] for r in tp["ranks"][mesh] if "vae_noise" in r]
    for a in noise:
        for b in noise:
            if a["coord"][0] == b["coord"][0]:
                assert torch.equal(a["noise"], b["noise"])


def _share(family: str, n_model: int) -> float:
    """A rank's share of the parameters under the port's table: the split
    leaves over M, the others whole."""
    model = _model(family)
    split = sharding.tensor_parallel_layout(model, n_model).params
    whole = sum(p.numel() for p in model.parameters())
    local = sum(p.numel() // (n_model if n in split else 1)
                for n, p in model.named_parameters())
    return local / whole


@pytest.mark.parametrize("mesh", TAGS)
def test_each_rank_holds_only_its_share(tp, mesh):
    """A rank's flat buffer, moments and EMA hold its slices of the split
    leaves and the replicated leaves whole: the table's share of the
    one-rank count (alignment padding aside); all of the VAE; the
    hierarchy's encoders and merges whole."""
    n_model = int(mesh[-1])
    for case, family in (("hier", "hier"), ("wave_raw", "wave_raw"), ("vae", "vae"),
                         ("wave_mulaw", "wave_mulaw")):
        one = tp["one"][case]["local"]["flat"].numel()
        want = _share(family, n_model)
        for rank in tp["ranks"][mesh]:
            loc = rank[case]["local"]
            assert abs(loc["flat"].numel() / one - want) < 2e-3, (case, loc["flat"].numel())
            assert loc["moments"].numel() == 2 * loc["flat"].numel()
    assert _share("vae", n_model) == 1.0
    assert 0.8 < _share("hier", 2) < 0.9 and 1 / 2 < _share("wave_raw", 2) < 0.52


@pytest.mark.parametrize("mesh", ["d1m2", "d2m2"])
@pytest.mark.parametrize("family", list(worker.SAVED))
def test_checkpoint_written_at_m2_resumes_at_m1_and_m4_and_serves(tp, mesh, family):
    """Rank 0 wrote the whole tree from M 2: a one-rank state restores it
    and equals the ranks' gathered state bit for bit; the M 4 mesh of the
    same launch restored the same tree (the W 4 launch's); the weights load
    into a model without a mesh and encode."""
    inp = tp["inp"]
    ckpt = str(tp["dirs"]["w2" if mesh == "d1m2" else "w4"] / f"ckpt_{mesh}_{family}")
    state = worker.fresh_state(inp, family, None)
    checkpoint.restore(ckpt, state)
    got = checkpoint.state_tensors(state)
    stepped = tp["ranks"][mesh][0][family]["whole"]  # the same steps, gathered
    for key, t in got.items():
        assert torch.equal(t, stepped[key]), key
        if key.startswith("params/"):
            _assert_close(key, t, tp["one"][family]["whole"][key])
    if mesh == "d2m2":
        m4 = tp["ranks"]["d1m4"][0]["restore"]["whole"]
        for key, t in got.items():
            assert torch.equal(m4[f"from_m2/{family}/{key}"], t), key
    model = worker.build(inp, family)
    checkpoint.restore_params(ckpt, model)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), got[f"params/{name}"]), name
    model.eval()
    with torch.no_grad():
        x = worker.batch(inp, family)["x"]
        codes = model.encode(x)
    if family == "hier":
        from neural_sound_generation_tpu_torch.cli import serve

        served = HierVQVAE(1, DIM, Z_DIM)
        serve.restore_weights(served, worker.config(), ckpt, ema=False)
        for name, p in served.named_parameters():
            assert torch.equal(p.detach(), got[f"params/{name}"]), name
        assert codes[0].shape == (8, 2, 3) and codes[1].shape == (8, 4, 6)
    else:
        assert codes.shape == (2, 8, 64 // 2**worker.DOWN)


def _jax_module(family: str):
    if family in ("hier", "hier_group"):
        return JaxHierVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM,
                            norm="group" if family == "hier_group" else "batch")
    if family == "vae":
        return JaxVAE(input_dim=1, dim=DIM, z_dim=worker.VAE_Z)
    if family == "wave_mulaw":
        return JaxWaveVQVAE(dim=DIM, z_dim=Z_DIM, num_downsample=worker.DOWN,
                            input_type="mulaw-quantize", quantize_channels=worker.QC,
                            num_quantizers=2)
    if family == "wave_speaker":
        return JaxWaveVQVAE(dim=DIM, z_dim=Z_DIM, num_downsample=worker.DOWN,
                            n_speakers=worker.SPEAKERS, gin_channels=worker.GIN)
    return JaxWaveVQVAE(dim=DIM, z_dim=Z_DIM, num_downsample=worker.DOWN)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_port_table_matches_jax_model_param_shardings(family, n_model):
    """Every leaf JAX's ``model_param_shardings`` shards is sharded by the
    port on the same axis (through the weight bridge's layouts) and no
    other kernel or codebook is; the port's departures are a split
    convolution's bias and the norm after it. The VAE splits nothing; the
    hierarchy splits its decoder and both codebooks; the raw wave model
    keeps its one-channel ``decoder.out``, every wave model its
    embeddings and speaker projection."""
    model = _model(family)
    params = convert.module_to_flax(model)["params"]
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    specs = jax_shardings(params, mesh, tensor_parallel=True)
    jax_axes = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        spec = tuple(sh.spec)
        if "model" in spec:
            jax_axes[jax.tree_util.keystr(path)] = spec.index("model")
    port = port_mesh.model_param_shardings(model, n_model)
    mapped = {}
    for name, axis in port.items():
        path, to_torch = port_mesh.flax_leaf(model, name)
        mapped[path] = to_torch.index(axis)
    assert mapped == jax_axes
    layout = sharding.tensor_parallel_layout(model, n_model)
    extra = set(layout.params) - set(port)
    assert all(k.endswith(".bias") or (k.endswith(".weight") and any(
        f".{n}_" in k for n in ("BatchNorm", "GroupNorm", "bn"))) for k in extra), extra
    assert set(layout.buffers) == {f"{n}.{s}" for n in layout.norms if "GroupNorm" not in n
                                   for s in ("running_mean", "running_var")}
    if family == "vae":
        assert not layout.params and not layout.buffers
    elif family.startswith("hier"):
        assert {k.split(".")[0] for k in layout.params} == {
            "decoder", "codebook_top", "codebook_bottom"}
    else:
        assert {k.split(".")[0] for k in layout.params} == {"encoder", "decoder", "codebook"}
        assert ("decoder.out.weight" in port) == (family == "wave_mulaw")
        assert not any(k.startswith(("input_embed", "speaker_")) for k in layout.params)
        assert port["codebook"] == (1 if family == "wave_mulaw" else 0)


def test_norm_groups_that_straddle_ranks_refuse():
    """GroupNorm's groups of 8 must not straddle the model ranks: 16
    channels over 4 ranks refuse."""
    model = HierVQVAE(1, 16, Z_DIM, norm="group")
    with pytest.raises(NotImplementedError, match="groups straddle"):
        sharding.tensor_parallel_layout(model, 4)
    assert sharding.tensor_parallel_layout(model, 2).norms


def _jax_tp_grads(family: str, inp: dict, n_data: int):
    """JAX's loss and gradient (ravel order) of the family's train step on
    (n_data, model 2) under ``model_param_shardings``, from the port's
    weights through the bridge."""
    model = worker.build(inp, family)
    variables = convert.module_to_flax(model)
    jm = _jax_module(family)
    beta = worker.config().model.beta
    loss_fn = (jtrainer._hier_vqvae_loss_fn(jm, beta) if family == "hier"
               else jtrainer._wave_vqvae_loss_fn(jm, beta))
    mesh = jax_make_mesh(n_data=n_data, n_model=2)
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                            jax_shardings(variables["params"], mesh, tensor_parallel=True))
    stats = jax.device_put(jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                           replicated_sharding(mesh))
    x = worker.batch(inp, family)["x"].numpy()
    batch = jax_shard_batch({"x": jnp.asarray(x)}, mesh)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, stats, batch, None)
    return float(loss), np.asarray(ravel_pytree(grads)[0])


@pytest.mark.parametrize("n_data", [1, 2])
@pytest.mark.parametrize("family", ["hier", "wave_raw"])
def test_step_equals_the_jax_tensor_parallel_step(tp, family, n_data):
    """The ranks' first step holds against JAX's GSPMD step on (n_data,
    2): the loss 1e-5 relative, the gathered gradient 2e-4 of the
    largest."""
    loss, want_g = _jax_tp_grads(family, tp["inp"], n_data)
    got = tp["ranks"][f"d{n_data}m2"][0][family]["whole"]
    torch.testing.assert_close(float(got["metric/loss"]), loss, rtol=LOSS_RTOL, atol=0)
    grads = {k[len("grad/"):]: t for k, t in got.items() if k.startswith("grad/")}
    got_g = convert.ravel_flax(convert.module_to_flax(_model(family), grads)["params"])
    np.testing.assert_allclose(got_g, want_g, atol=JAX_GRAD_FRAC * np.abs(want_g).max())


# ---------------------------------------------------------------------------
# The CLIs under torchrun
# ---------------------------------------------------------------------------

CLI_DIM, CLI_Z = 16, 32


def _cli_args(tmp, datadir, tag, *extra):
    return ["--model", "wavevqvae", "--dataset", "ljspeech", "--datadir", datadir,
            "--dim", str(CLI_DIM), "--z-dim", str(CLI_Z), "--batch-size", "4", "--epochs", "1",
            "--max-batches-per-epoch", "2", "--log-interval", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp / tag / "models"),
            "--sampledir", str(tmp / tag / "results"), *extra]


def _torchrun(module, args):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "-m", module, *args]
    return subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def test_cli_main_and_evaluate_wavevqvae_with_a_model_axis_match_one_rank(tmp_path, capsys):
    """``cli.main --model wavevqvae --mesh-model 2`` trains the one-rank
    run's steps (its checkpoint, whole, within 1e-5 of the one-rank one,
    a bias within 2 lr a step) and ``cli.evaluate --mesh-model 2`` reports
    the one-rank metrics within 1e-5."""
    from test_torch_wavevqvae import _corpus

    datadir = _corpus(str(tmp_path / "corpus"), n=16)
    main.main(_cli_args(tmp_path, datadir, "one"))
    sub = os.path.join("wavevqvae", f"checkpoint_ljspeech_{CLI_DIM}_{CLI_Z}")
    ckpts = {tag: os.path.join(tmp_path, tag, "models", sub) for tag in ("one", "tp")}
    ev = ["--model", "wavevqvae", "--datadir", datadir, "--ckpt-dir", ckpts["one"],
          "--dim", str(CLI_DIM), "--z-dim", str(CLI_Z), "--batch-size", "4",
          "--max-batches", "2", "--device", "cpu"]
    procs = [_torchrun("neural_sound_generation_tpu_torch.cli.main",
                       _cli_args(tmp_path, datadir, "tp", "--mesh-model", "2")),
             _torchrun("neural_sound_generation_tpu_torch.cli.evaluate",
                       ev + ["--mesh-model", "2"])]
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
    lr = 1e-3  # the CLI's default --lr-rate
    for key, w in one.items():
        got = two[key]
        assert got.shape == w.shape, key
        if key.startswith(("params/", "ema_params/")):
            limit = 2 * lr * 2 if key.endswith(".bias") else CLI_ATOL
            assert float((got - w).abs().max()) <= limit, key
        elif key in ("step", "opt_state/count"):
            assert torch.equal(got, w), key
    lines = [json.loads(line) for line in outs[1].splitlines() if line.startswith("{")]
    assert len(lines) == 1 and lines[0].keys() == want.keys()
    for k, v in want.items():
        assert lines[0][k] == pytest.approx(v, rel=1e-5, abs=1e-6), k
    # the whole checkpoint trains on at one rank
    main.main(_cli_args(tmp_path, datadir, "tp", "--epochs", "2", "--resume"))
    assert checkpoint.latest_step(ckpts["tp"]) == 4

"""Tensor parallelism (the mesh's ``model`` axis) for the gated families,
WaveNet and the GatedPixelCNN, on the CPU.

Two gloo launches join through ``file://`` rendezvous in the test's
directories and run every case of ``tests/torch_gated_tp_worker.py``: a
world of 2 on (data 1 x model 2), a world of 4 on (data 2 x model 2) and
then (data 1 x model 4), which restores the checkpoint its M-2 mesh wrote
and leaves the bf16 and multi-step cases to the M-2 meshes. Each case is
held against the same case function run here with no mesh: the port's
one-rank step. The vocoder's and the PixelCNN's steps are also held
against the JAX package's loss and gradient on ``make_mesh(n_data=1|2,
n_model=2)`` over the conftest's virtual CPU devices, and each family's
table against JAX's ``model_param_shardings``. ``cli.vocoder train`` and
``cli.prior train --hier`` at both levels then run with ``--mesh-model 2``
under ``torchrun`` on two ranks against one rank, and their checkpoints
synthesize and sample on one rank.

Tolerances, with their reasons:
  * every gathered value bit-equal on every rank (one set of all-reduce
    results feeds the same arithmetic), the local buffers bit-equal across
    a data group, and the replicated leaves across a model group;
  * losses 1e-5 relative; bf16 losses 2e-2 (each rank rounds its own
    channels' sums to bf16 and the backward sums bf16 gradients over the
    model group in float32);
  * the flat gradient within 1e-5 of the one-rank gradient's norm (each
    rank's convolutions sum their own channels, and the input gradients
    are summed over the ranks in another order); after ``--multi-steps 2``
    within 1e-4: the second step's gradient is taken at parameters that
    already differ from the one-rank run's by the first update's rounding
    (3e-8), and the MoL loss's sharp mixtures amplify that to 1e-5 of the
    norm, spread over every leaf;
  * parameters, moments and the EMA after steps from warm moments 1e-5
    relative and 1e-6 absolute, or 2e-6 of the tensor's largest
    (``test_torch_model_parallel.py``'s bounds);
  * a checkpoint's round trip between M 1, 2 and 4 bit-exact;
  * in float64 (the MoL vocoder, the speaker vocoder and the spatial
    PixelCNN, their gradient outside the train step) 1e-12 relative, and
    1e-12 of each leaf's largest: the model axis reorders sums, so
    float32's gaps above are rounding alone, and a permuted channel would
    show here at the size of the gradient itself; the loss 1e-5, as both
    models return float32 logits;
  * against JAX: the loss 1e-5 relative, gradients 2e-4 of the largest;
  * the CLIs' checkpoints 1e-5 absolute (steps of lr 1e-3 from cold
    moments); a bias, and the vocoder's upsampler, 2 lr a step: Adam's cold
    first steps are scale-free and turn a rounding-noise gradient into
    +-lr, and the upsampler's gradients on the CLI's 16-channel vocoder are
    1e-8-1e-7 (v 1e-16-1e-12 after four steps), sums over a clip of the
    conditioning's gradient that cancel to the rounding noise of their
    terms, whose order the model axis changes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

import torch_gated_tp_worker as worker
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import pixelcnn as jpc
from neural_sound_generation_tpu.models import wavenet as jwn
from neural_sound_generation_tpu.parallel import make_mesh as jax_make_mesh
from neural_sound_generation_tpu.parallel import shard_batch as jax_shard_batch
from neural_sound_generation_tpu.parallel.mesh import model_param_shardings as jax_shardings
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.models import GatedPixelCNN
from neural_sound_generation_tpu_torch.models.wavenet import WaveNet
from neural_sound_generation_tpu_torch.parallel import mesh as port_mesh
from neural_sound_generation_tpu_torch.training import checkpoint, sharding
from neural_sound_generation_tpu_torch.training.train_state import ALIGN

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: launch -> (world, the mesh tags it runs)
LAUNCHES = {"w2": (2, ("d1m2",)), "w4": (4, ("d2m2", "d1m4"))}
TAGS = ("d1m2", "d2m2", "d1m4")
LOSS_RTOL, GRAD_REL, STAT_ATOL, STAT_RTOL, SUM_FRAC, JAX_GRAD_FRAC = (
    1e-5, 1e-5, 1e-6, 1e-5, 2e-6, 2e-4)
MULTI_GRAD_REL = 1e-4
F64_RTOL = 1e-12
BF16_LOSS_RTOL = 2e-2
CLI_ATOL = 1e-5
FAMILIES = ("wavenet", "wavenet_mulaw", "wavenet_narrow", "pixelcnn", "pixelcnn_spatial")
ROWS, T, FRAMES, GRID = 8, 64, 16, (5, 6)  # a batch's rows, samples, mel frames, code grid
GATHER_C = 24  # the grouped gather's channels: two blocks of 12


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


def _batches(rng) -> dict:
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    h, w = GRID
    out = {}
    for suffix in ("", "2"):
        lengths = t(rng.integers(40, T + 1, ROWS).astype(np.int64))
        mel = t(rng.standard_normal((ROWS, FRAMES, worker.WAVENET["cin_channels"]))
                .astype(np.float32))
        out[f"mol_batch{suffix}"] = {
            "y": t(rng.uniform(-0.9, 0.9, (ROWS, T, 1)).astype(np.float32)),
            "c": mel, "input_lengths": lengths}
        out[f"mulaw_batch{suffix}"] = {
            "y": t(rng.integers(0, worker.QC, (ROWS, T)).astype(np.int64)), "c": mel,
            "g": t(rng.integers(0, worker.SPEAKERS, ROWS).astype(np.int64)),
            "input_lengths": lengths}
        codes = {"codes": t(rng.integers(0, worker.K, (ROWS, h, w)).astype(np.int64)),
                 "labels": t(rng.integers(0, worker.CLASSES, ROWS).astype(np.int64))}
        out[f"codes_batch{suffix}"] = codes
        out[f"codes_cond_batch{suffix}"] = {
            **codes, "cond": t(rng.standard_normal((ROWS, h, w, worker.COND))
                               .astype(np.float32))}
    return out


def _inputs(work) -> dict:
    rng = np.random.default_rng(0)
    inp = _batches(rng)
    for name in ("gather_x", "gather_grad"):
        inp[name] = torch.from_numpy(rng.standard_normal((2, GATHER_C, 3)).astype(np.float32))
    for i, family in enumerate(FAMILIES):
        inp[family] = _weights(family, i)
    for family in worker.SAVED:
        inp[f"ckpt_m1_{family}"] = str(work / f"ckpt_m1_{family}")
    inp["work"] = str(work)
    return inp


def _spawn(work, world):
    return [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_gated_tp_worker.py"), str(r),
         str(world), str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(world)]


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    work = tmp_path_factory.mktemp("gated_tp")
    inp = _inputs(work)
    # the one-rank checkpoints the ranks restore: each family's stepped state
    for family in worker.SAVED:
        _, _, state, _ = worker._steps(inp, None, family)
        checkpoint.save(inp[f"ckpt_m1_{family}"], state, step=101)
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
    if kind == "f64" and key.endswith("/loss"):  # of the float32 logits both models return
        torch.testing.assert_close(got, want, rtol=LOSS_RTOL, atol=0, msg=key)
        return
    if kind == "f64":
        scale = float(want.abs().max()) if want.numel() else 0.0
        torch.testing.assert_close(got, want, rtol=F64_RTOL, atol=F64_RTOL * scale, msg=key)
        return
    if kind in ("restored", "from_m2", "gather") or key in ("step", "opt_state/count"):
        assert torch.equal(got, want), key
    elif kind in ("metric", "eval"):
        if not (bf16 and key.endswith("grad_norm")):
            rtol = BF16_LOSS_RTOL if bf16 else LOSS_RTOL
            torch.testing.assert_close(got, want, rtol=rtol, atol=0, msg=key)
    elif kind == "grad" or bf16:
        return  # the whole gradient is held by its norm below; bf16 by its loss
    else:  # params, moments, EMA shadow
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
    bf16 = case.endswith("_bf16")
    for key in ranks[0]["whole"]:
        for r, rank in enumerate(ranks[1:], 1):
            assert torch.equal(rank["whole"][key], ranks[0]["whole"][key]), \
                f"{case} {key}: rank {r} differs from rank 0"
        if key in one:
            _assert_close(key, ranks[0]["whole"][key], one[key], bf16=bf16)
    if any(k.startswith("grad/") for k in one) and not bf16:
        g1, g2 = _grad(one), _grad(ranks[0]["whole"])
        limit = MULTI_GRAD_REL if case == "multistep" else GRAD_REL
        assert float((g2 - g1).norm()) <= limit * float(g1.norm()), case


@pytest.mark.parametrize("mesh", TAGS)
def test_local_buffers_agree_across_each_group(tp, mesh):
    """Everything a rank holds is bit-equal across its data group; its
    replicated leaves (past ``split_at``) across its model group."""
    for case, result in tp["ranks"][mesh][0].items():
        if "coord" not in result["local"]:
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
                    assert int(b["split_at"]) == cut and 0 < cut <= a["flat"].numel()
                    for key in ("flat", "grad"):
                        assert torch.equal(a[key][cut:], b[key][cut:]), \
                            f"{case} {key}: replicated leaves differ in a model group"


def _local_count(family: str, n_model: int) -> int:
    """A rank's count of parameters under the port's table: the split
    leaves over M, the others whole."""
    model = worker.make(family)
    split = sharding.tensor_parallel_layout(model, n_model).params
    return sum(p.numel() // (n_model if n in split else 1) for n, p in model.named_parameters())


def _share(family: str, n_model: int) -> float:
    return _local_count(family, n_model) / _local_count(family, 1)


@pytest.mark.parametrize("mesh", TAGS)
def test_each_rank_holds_only_its_share(tp, mesh):
    """A rank's flat buffer, moments and EMA hold its slices of the split
    leaves and the replicated leaves whole: the table's count, up to the
    alignment padding of each leaf. The MoL vocoder and the PixelCNN split
    every leaf at M 2; at M 4 the vocoder keeps ``post2`` whole and the
    narrow vocoder its gates."""
    n_model = int(mesh[-1])
    for case in ("wavenet", "wavenet_mulaw", "wavenet_narrow", "pixelcnn", "pixelcnn_spatial"):
        want = _local_count(case, n_model)
        leaves = len(tp["inp"][case])
        for rank in tp["ranks"][mesh]:
            loc = rank[case]["local"]
            assert 0 <= loc["flat"].numel() - want < ALIGN * leaves, (case, loc["flat"].numel())
            assert loc["moments"].numel() == 2 * loc["flat"].numel()
    assert _share("wavenet", 2) == _share("pixelcnn", 2) == _share("pixelcnn", 4) * 2 == 0.5
    assert 0.25 < _share("wavenet", 4) < 0.5 and _share("wavenet_mulaw", 2) > 0.5
    assert _share("wavenet_narrow", 4) > _share("wavenet_narrow", 2) == 0.5


@pytest.mark.parametrize("mesh", ["d1m2", "d2m2"])
@pytest.mark.parametrize("family", worker.SAVED)
def test_checkpoint_written_at_m2_resumes_at_m1_and_m4_and_serves(tp, mesh, family):
    """Rank 0 wrote the whole tree from M 2: a one-rank state restores it
    and equals the ranks' gathered state bit for bit; the M 4 mesh of the
    same launch restored the same tree (the W 4 launch's); the weights load
    into a model without a mesh and run its incremental path."""
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
    b = worker.batch(inp, family)
    if family == "wavenet_mulaw":
        from neural_sound_generation_tpu_torch.models.wavenet import incremental_forward

        x, c, g = b["y"][:2, :8], b["c"][:2, :2], b["g"][:2]
        with torch.no_grad():
            want = model(WaveNet.shift_inputs(x, False), c, g)
        got_inc = incremental_forward(model, WaveNet.shift_inputs(x, False), c, g)
        torch.testing.assert_close(got_inc, want, rtol=1e-4, atol=1e-4)
    else:
        from neural_sound_generation_tpu_torch.models.pixelcnn import incremental_logits

        codes, labels, cond = b["codes"][:2], b["labels"][:2], b["cond"][:2]
        with torch.no_grad():
            want = model(codes, labels, cond)
        torch.testing.assert_close(incremental_logits(model, codes, labels, cond), want,
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_model", [2, 4])
def test_grouped_gather_returns_the_leaf_order_not_the_rank_order(tp, n_model):
    """Each rank's grouped slice of a gate's leaf holds its channels of both
    halves; put side by side in rank order they are not the leaf (so a
    plain gather would permute its channels), and the grouped gather of
    the ranks (the gather case, at this M) gives back the leaf itself,
    forward and backward, bit for bit."""
    x = tp["inp"]["gather_x"]
    parts = [sharding._slice(x, 1, r, n_model, groups=2) for r in range(n_model)]
    c = GATHER_C // (2 * n_model)
    assert all(torch.equal(p[:, :c], x[:, r * c:(r + 1) * c]) and torch.equal(
        p[:, c:], x[:, GATHER_C // 2 + r * c:GATHER_C // 2 + (r + 1) * c])
        for r, p in enumerate(parts))
    assert not torch.equal(torch.cat(parts, dim=1), x)
    blocks = [p.unflatten(1, (2, -1)) for p in parts]
    assert torch.equal(torch.cat(blocks, dim=2).flatten(1, 2), x)
    got = tp["ranks"]["d1m2" if n_model == 2 else "d1m4"][0]["gather"]["whole"]
    assert torch.equal(got["gather/channels"], x)
    assert torch.equal(got["gather/channels_backward"], tp["inp"]["gather_grad"])
    assert torch.equal(got["gather/last"], x.transpose(1, 2))
    assert torch.equal(got["gather/last_backward"], tp["inp"]["gather_grad"].transpose(1, 2))


def _jax_axes(model, n_model) -> dict:
    """{flax path: the flax axis JAX's ``model_param_shardings`` shards over
    'model'} of the port model's tree."""
    params = convert.module_to_flax(model)["params"]
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    specs = jax_shardings(params, mesh, tensor_parallel=True)
    out = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        spec = tuple(sh.spec)
        if "model" in spec:
            out[jax.tree_util.keystr(path)] = spec.index("model")
    return out


def _gate_leaves(model) -> set:
    gate = sharding._GATE_LEAVES[type(model)]
    return {k for k, _ in model.named_parameters() if gate.match(k)}


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_port_table_matches_jax_model_param_shardings(family, n_model):
    """Every leaf JAX's ``model_param_shardings`` shards is sharded by the
    port's ``model_param_shardings`` on the same axis (through the weight
    bridge's layouts) and no other. The layout departs from it only as
    documented: a split convolution's bias and the raw gate biases split
    with their kernels; every gate leaf split in two blocks, or, where a
    half does not divide, none; ``g_i`` and the embeddings of the vocoder
    whole."""
    model = worker.make(family)
    port = port_mesh.model_param_shardings(model, n_model)
    mapped = {}
    for name, axis in port.items():
        path, to_torch = port_mesh.flax_leaf(model, name)
        mapped[path] = to_torch.index(axis)
    assert mapped == _jax_axes(model, n_model)
    layout = sharding.tensor_parallel_layout(model, n_model)
    gates = _gate_leaves(model)
    half = model.gate_channels // 2 if isinstance(model, WaveNet) else model.dim
    split_gates = half % n_model == 0
    assert set(layout.groups) == (gates if split_gates else set())
    assert set(layout.groups.values()) <= {2}
    missing = set(port) - set(layout.params)
    assert missing == (set() if split_gates else gates & set(port))
    extra = set(layout.params) - set(port)
    assert all(k.endswith("bias") for k in extra), extra
    for name in extra:
        prefix = name[:-len("bias")]
        assert prefix + "weight" in layout.params or prefix + "kernel" in layout.params, name
    assert not any(k.startswith(("g_", "speaker_embed", "input_embed")) for k in layout.params)
    assert ("post2.weight" in layout.params) == (model.out_channels % n_model == 0
                                                  if isinstance(model, WaveNet) else False)


@pytest.mark.parametrize("family,n_model", [("wavenet_narrow", 4), ("pixelcnn_odd", 4)])
def test_a_gate_whose_half_does_not_divide_stays_whole(family, n_model):
    """``gate_channels`` 4 at M 4 (halves of 2) and a PixelCNN of dim 6 at
    M 4 (2C = 12): JAX would split the gate's leaves, whose width divides;
    the port keeps every leaf of every gate whole, and its local state
    holds them whole."""
    model = (GatedPixelCNN(worker.K, 6, 2, worker.CLASSES) if family == "pixelcnn_odd"
             else worker.make(family))
    gates = _gate_leaves(model)
    jax_split = {port_mesh.flax_leaf(model, k)[0] for k in gates} & set(_jax_axes(model, n_model))
    assert jax_split, "JAX splits some of the gate's leaves"
    layout = sharding.tensor_parallel_layout(model, n_model)
    assert not gates & set(layout.params) and not layout.groups
    sd = model.state_dict()
    for r in range(n_model):
        local = convert.local_state_dict(sd, model, n_model, r)
        for k in gates:
            assert torch.equal(local[k], sd[k]), k


def _jax_module(family: str):
    if family.startswith("pixelcnn"):
        return jpc.GatedPixelCNN(input_dim=worker.K, dim=worker.DIM, n_layers=worker.LAYERS,
                                 n_classes=worker.CLASSES,
                                 spatial_cond=family == "pixelcnn_spatial")
    if family == "wavenet_mulaw":
        return jwn.WaveNet(out_channels=worker.QC, scalar_input=False,
                           quantize_channels=worker.QC, gin_channels=worker.GIN,
                           n_speakers=worker.SPEAKERS, **worker.WAVENET)
    return jwn.WaveNet(out_channels=worker.MOL_OUT, **worker.WAVENET)


def _jax_tp_grads(family: str, inp: dict, n_data: int):
    """JAX's loss and gradient (ravel order) of the family's train step on
    (n_data, model 2) under ``model_param_shardings``, from the port's
    weights through the bridge."""
    model = worker.build(inp, family)
    variables = convert.module_to_flax(model)
    jm = _jax_module(family)
    loss_fn = (jtrainer._pixelcnn_loss_fn(jm) if family.startswith("pixelcnn")
               else jtrainer._wavenet_loss_fn(jm, JaxConfig()))
    mesh = jax_make_mesh(n_data=n_data, n_model=2)
    params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                            jax_shardings(variables["params"], mesh, tensor_parallel=True))
    batch = {k: jnp.asarray(v.numpy().astype(np.int32) if not v.is_floating_point()
                            else v.numpy()) for k, v in worker.batch(inp, family).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, {}, jax_shard_batch(batch, mesh), None)
    return float(loss), np.asarray(ravel_pytree(grads)[0])


@pytest.mark.parametrize("family,n_data", [("wavenet", 1), ("wavenet", 2), ("wavenet_mulaw", 2),
                                           ("pixelcnn", 1), ("pixelcnn_spatial", 2)])
def test_step_equals_the_jax_tensor_parallel_step(tp, family, n_data):
    """The ranks' first step holds against JAX's GSPMD step on (n_data,
    2): the loss 1e-5 relative, the gathered gradient 2e-4 of the
    largest."""
    loss, want_g = _jax_tp_grads(family, tp["inp"], n_data)
    got = tp["ranks"][f"d{n_data}m2"][0][family]["whole"]
    torch.testing.assert_close(float(got["metric/loss"]), loss, rtol=LOSS_RTOL, atol=0)
    grads = {k[len("grad/"):]: t for k, t in got.items() if k.startswith("grad/")}
    got_g = convert.ravel_flax(convert.module_to_flax(worker.make(family), grads)["params"])
    np.testing.assert_allclose(got_g, want_g, atol=JAX_GRAD_FRAC * np.abs(want_g).max())


# ---------------------------------------------------------------------------
# The CLIs under torchrun
# ---------------------------------------------------------------------------

CLI_LR = 1e-3  # both CLIs' learning rate (the vocoder's default, the prior's --lr)
VOC_WIDTHS = ["--layers", "4", "--stacks", "2", "--residual-channels", "16"]
HIER_DIM, HIER_CODES = 16, 32
PRIOR_WIDTHS = ["--prior-dim", str(worker.DIM), "--prior-layers", str(worker.LAYERS)]


def _torchrun(module, *argv) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            "2", "-m", module, *argv]


def _vocoder_args(datadir, ckpt, *extra):
    return ["train", "--datadir", datadir, "--ckpt-dir", ckpt, "--batch-size", "4",
            "--max-batches-per-epoch", "2", "--device", "cpu", *VOC_WIDTHS, *extra]


def _prior_args(datadir, vq, ckpt, level, *extra):
    return ["train", "--datadir", datadir, "--vqvae-ckpt", vq, "--ckpt-dir", ckpt, "--hier",
            "--hier-level", level, "--dim", str(HIER_DIM), "--z-dim", str(HIER_CODES),
            "--batch-size", "4", "--epochs", "1", "--max-batches-per-epoch", "2", "--lr",
            str(CLI_LR), "--device", "cpu", *PRIOR_WIDTHS, *extra]


@pytest.fixture(scope="module")
def clis(tmp_path_factory):
    """``cli.vocoder train --mesh-model 2`` (an epoch of two steps as one
    ``--multi-steps 2`` super-batch, then a ``--resume`` epoch of two) and
    ``cli.prior train --hier --mesh-model 2`` at both levels (two steps
    each) under torchrun on two ranks, the three launches at once, while
    the same runs go on one rank here."""
    from neural_sound_generation_tpu_torch.cli import prior, vocoder
    from neural_sound_generation_tpu_torch.models import HierVQVAE
    from neural_sound_generation_tpu_torch.training import train_state
    from test_torch_hiervqvae import _corpus
    from test_torch_vocoder_train import write_corpus

    root = tmp_path_factory.mktemp("gated_clis")
    wav_dir = write_corpus(str(root / "wav_corpus"), n=16)
    os.makedirs(root / "mel_corpus")
    mel_dir = _corpus(str(root / "mel_corpus"), n=16)
    vq = str(root / "hier")
    model = HierVQVAE(1, HIER_DIM, HIER_CODES, generator=torch.Generator().manual_seed(3))
    checkpoint.save(vq, train_state.create_train_state(model, worker.config().train), step=1,
                    extra={"arch": "hiervqvae", "num_quantizers": 1})
    ckpt = {(run, tag): str(root / tag / run) for run in ("wavenet", "top", "bottom")
            for tag in ("one", "tp")}
    mesh = ["--mesh-model", "2"]
    voc = "neural_sound_generation_tpu_torch.cli.vocoder"
    first = ["--epochs", "1", "--multi-steps", "2"]
    second = ["--epochs", "2", "--resume"]
    commands = {
        "wavenet": ["sh", "-c", " ".join([
            *_torchrun(voc, *_vocoder_args(wav_dir, ckpt["wavenet", "tp"], *first, *mesh)),
            "&&", *_torchrun(voc, *_vocoder_args(wav_dir, ckpt["wavenet", "tp"], *second,
                                                 *mesh))])],
        **{level: _torchrun("neural_sound_generation_tpu_torch.cli.prior",
                            *_prior_args(mel_dir, vq, ckpt[level, "tp"], level, *mesh))
           for level in ("top", "bottom")}}
    procs = {run: subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
             for run, cmd in commands.items()}
    try:
        vocoder.main(_vocoder_args(wav_dir, ckpt["wavenet", "one"], *first))
        vocoder.main(_vocoder_args(wav_dir, ckpt["wavenet", "one"], *second))
        for level in ("top", "bottom"):
            prior.main(_prior_args(mel_dir, vq, ckpt[level, "one"], level))
        outs = {run: p.communicate(timeout=240)[0] for run, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    for run, p in procs.items():
        assert p.returncode == 0, f"{run}:\n{outs[run]}"
    return {"ckpt": ckpt, "outs": outs, "vq": vq, "wav_dir": wav_dir, "root": root}


def _assert_train_states_match(one_dir: str, tp_dir: str, step: int, steps: int) -> None:
    """The whole ``_train`` checkpoints at ``step``: every parameter and
    EMA leaf within 1e-5, a bias within 2 lr a step; step and count equal;
    the artifact the tensor-parallel run wrote is its state's parameters."""
    one, two = (torch.load(os.path.join(d + "_train", f"step_{step}", "state.pt"),
                           weights_only=True) for d in (one_dir, tp_dir))
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
    artifact = torch.load(os.path.join(tp_dir, f"step_{step}", "state.pt"), weights_only=True)
    assert artifact.keys() == {k for k in two if k.startswith("params/")}
    for key, t in artifact.items():
        assert torch.equal(t, two[key]), key


def test_cli_vocoder_train_with_a_model_axis_matches_one_rank_and_synthesizes(clis, tmp_path):
    """``cli.vocoder train --mesh-model 2 --multi-steps 2``, then
    ``--resume``: the one-rank run's four steps (whole checkpoints within
    1e-5, step and count equal); the M-2 artifact synthesizes on one rank
    and loads into ``serve --vocoder-ckpt``'s model."""
    from neural_sound_generation_tpu_torch.cli import serve, vocoder
    from neural_sound_generation_tpu_torch.config import Config

    one, two = clis["ckpt"]["wavenet", "one"], clis["ckpt"]["wavenet", "tp"]
    assert "(tensor parallel)" in clis["outs"]["wavenet"]
    for d in (one, two):
        assert checkpoint.latest_step(d + "_train") == 4 and checkpoint.latest_step(d) == 4
    _assert_train_states_match(one, two, 4, 4)
    mel = np.load(os.path.join(clis["wav_dir"], "m0.npy"))
    np.save(tmp_path / "mel.npy", mel)
    out = str(tmp_path / "out.wav")
    vocoder.main(["synthesize", "--ckpt-dir", two, "--mel-npy", str(tmp_path / "mel.npy"),
                  "--output", out, "--max-frames", "2", "--device", "cpu", *VOC_WIDTHS])
    from scipy.io import wavfile

    _, wav = wavfile.read(out)
    assert wav.shape == (2 * Config().audio.effective_hop_size,) and np.isfinite(wav).all()
    args = serve.parse_args(["--device", "cpu", "--vocoder", "wavenet", "--vocoder-ckpt", two,
                             "--vocoder-layers", "4", "--vocoder-stacks", "2",
                             "--vocoder-residual-channels", "16"])
    model = serve.load_serving_vocoder(args, Config(), torch.device("cpu"))
    artifact = torch.load(os.path.join(two, "step_4", "state.pt"), weights_only=True)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), artifact[f"params/{name}"]), name


@pytest.mark.parametrize("level", ["top", "bottom"])
def test_cli_prior_train_pixelcnn_with_a_model_axis_matches_one_rank(clis, level):
    """``cli.prior train --hier --hier-level top|bottom --mesh-model 2``
    (the default ``--arch pixelcnn``; the bottom level spatially
    conditioned) trains the one-rank run's two steps: whole checkpoints
    within 1e-5, step and count equal."""
    one, two = clis["ckpt"][level, "one"], clis["ckpt"][level, "tp"]
    assert "(tensor parallel)" in clis["outs"][level]
    for d in (one, two):
        for sub in ("", "_ema", "_train"):
            assert checkpoint.latest_step(d + sub) == 2
    _assert_train_states_match(one, two, 2, 2)


def test_cli_prior_sample_hier_from_the_model_axis_checkpoints(clis, tmp_path):
    """``cli.prior sample --hier`` draws from the two M-2 checkpoints on one
    rank: finite WAVs."""
    from scipy.io import wavfile

    from neural_sound_generation_tpu_torch.cli import prior

    ckpt = clis["ckpt"]
    prior.main(["sample", "--hier", "--vqvae-ckpt", clis["vq"], "--prior-ckpt",
                ckpt["top", "tp"] + "_ema", "--bottom-ckpt", ckpt["bottom", "tp"] + "_ema",
                "--output-dir", str(tmp_path / "s"), "--code-shape", "10", "2",
                "--num-samples", "2", "--dim", str(HIER_DIM), "--z-dim", str(HIER_CODES),
                "--device", "cpu", *PRIOR_WIDTHS])
    names = sorted(os.listdir(tmp_path / "s"))
    assert names == ["hier_sample_000.wav", "hier_sample_001.wav"]
    for name in names:
        _, wav = wavfile.read(tmp_path / "s" / name)
        assert wav.size and np.isfinite(wav).all()

"""The tensor-parallel cases of ``tests/test_torch_model_parallel.py``, and
the rank process that runs them.

``python tests/torch_tp_worker.py <rank> <world> <n_model> <dir>`` joins a
gloo group through ``file://<dir>/init``, lays a (world / n_model,
n_model) mesh over it, reads the inputs the test wrote to
``<dir>/inputs.pt``, runs every case of ``CASES`` and writes
``<dir>/rank<r>.pt``. The test runs the same case functions in its own
process with ``mesh=None``: the one-rank reference each rank's result is
held against.

A case returns ``{"whole": {...}, "local": {...}}``: ``whole`` holds
tensors gathered over the model group into the one-rank layout (the
checkpoint's names: ``params/<name>``, ``opt_state/m/<name>``, ...; and
``grad/<name>`` for the flat gradient), which must equal the one-rank
values and be bit-equal on every rank; ``local`` holds this rank's own
flat buffers, which must be bit-equal across each data group and, past
``split_at`` (the replicated leaves), across each model group. This file
imports torch and the port, never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.ops import vq as vq_ops
from neural_sound_generation_tpu_torch.parallel import distributed, make_mesh, shard_batch
from neural_sound_generation_tpu_torch.parallel.mesh import active
from neural_sound_generation_tpu_torch.training import checkpoint, losses
from neural_sound_generation_tpu_torch.training.sharding import (
    gather_train_state,
    shard_train_state,
)
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import (
    make_eval_step,
    make_multistep_train,
    make_train_step,
)

DIM, Z_DIM = 16, 32
TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, initial_learning_rate=1e-3)


def config(**model) -> Config:
    cfg = Config()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **TRAIN),
        model=dataclasses.replace(cfg.model, dim=DIM, z_dim=Z_DIM, beta=0.25, **model))


def vqvae(inp, num_quantizers: int = 1, dtype: torch.dtype = torch.float32) -> VQVAE:
    model = VQVAE(1, DIM, Z_DIM, num_quantizers=num_quantizers, dtype=dtype)
    model.load_state_dict(inp["rvq" if num_quantizers > 1 else "vqvae"])
    return model


def warm(state):
    """Warm Adam moments (count 100, m and v drawn by parameter name from
    a fixed seed), so that an update is a smooth function of the gradient
    (see ``torch_dp_worker._warm``)."""
    gen = torch.Generator().manual_seed(11)
    with torch.no_grad():
        state.step.fill_(100)
        state.opt_state.count.fill_(100)
        m = state.opt_state.named_moments(state.flat, "m")
        v = state.opt_state.named_moments(state.flat, "v")
        for name in sorted(m):
            m[name].copy_(1e-3 * torch.randn(m[name].shape, generator=gen))
            v[name].copy_(torch.empty(v[name].shape).uniform_(1e-6, 1e-5, generator=gen))
    return state


def place(state, mesh):
    """This rank's slices under the model axis; the state itself otherwise."""
    if mesh is not None and mesh.tensor_parallel:
        state = shard_train_state(state, mesh)
    return state


def rank_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.detach().clone()
    return t if mesh is None else mesh.mean_(t)


def whole(state) -> dict:
    """The state and the flat gradient, whole, by checkpoint name."""
    out = {k: t.detach().clone() for k, t in gather_train_state(state).items()}
    grads = {f"params/{k}": g for k, g in state.flat.named(state.flat.grad).items()}
    if state.shards is not None:
        grads = state.shards.gather_tensors(grads)
    out.update({f"grad/{k[len('params/'):]}": g.clone() for k, g in grads.items()})
    return out


def local(state, mesh) -> dict:
    flat = state.flat
    coord = (0, 0) if mesh is None else (mesh.data_rank, mesh.model_rank)
    return {"flat": flat.flat.clone(), "grad": flat.grad.clone(),
            "moments": torch.cat([t.reshape(-1).float() for t in state.opt_state.moments()]),
            "buffers": torch.cat([torch.zeros(0)]
                                 + [b.reshape(-1).float() for b in state.model.buffers()]),
            "split_at": torch.tensor(flat.split_at), "coord": torch.tensor(coord)}


def _step(inp, mesh, num_quantizers=1, dtype=torch.float32, steps=1):
    cfg = config(num_quantizers=num_quantizers)
    model = vqvae(inp, num_quantizers, dtype)
    state = place(warm(create_train_state(model, cfg.train)), mesh)
    if steps == 1:
        _, m = make_train_step(model, cfg, mesh)(state, shard_batch({"x": inp["x"]}, mesh))
    else:
        xs = torch.stack([shard_batch({"x": x}, mesh)["x"] for x in (inp["x"], inp["x2"])])
        _, stacked = make_multistep_train(model, cfg, steps, mesh)(state, {"x": xs})
        m = {"loss": stacked["loss"]}
    out = {f"metric/{k}": rank_mean(v, mesh) for k, v in m.items()}
    out.update(whole(state))
    return model, cfg, state, {"whole": out, "local": local(state, mesh)}


def flagship(inp, mesh):
    """The flagship VQ-VAE's train step (f32, one codebook), then its eval
    step on the same batch."""
    model, cfg, state, out = _step(inp, mesh)
    _, em = make_eval_step(model, cfg, mesh)(state, shard_batch({"x": inp["x"]}, mesh))
    out["whole"].update({f"eval/{k}": rank_mean(v, mesh) for k, v in em.items()})
    return out


def rvq(inp, mesh):
    """A residual-VQ step, two stages of (Q, K, D) sharded by codes."""
    return _step(inp, mesh, num_quantizers=2)[3]


def bf16(inp, mesh):
    """A --bf16 step: the convolutions and the gathers in bfloat16."""
    return _step(inp, mesh, dtype=torch.bfloat16)[3]


def multistep(inp, mesh):
    """--multi-steps 2 over a stacked super-batch."""
    return _step(inp, mesh, steps=2)[3]


def ema_restart(inp, mesh):
    """Two EMA-codebook steps with dead-code restarts after a data init
    of the whole codebook (as cli.main seeds it, before sharding)."""
    from neural_sound_generation_tpu_torch.cli.main import apply_data_codebook_init

    cfg = config(ema_codebook=True, restart_dead_threshold=1.0, ema_codebook_decay=0.9)
    model = vqvae(inp)
    apply_data_codebook_init(model, inp["x"], torch.Generator().manual_seed(5))
    state = place(warm(create_train_state(model, cfg.train, ema_codebook=True)), mesh)
    step = make_train_step(model, cfg, mesh)
    gen = torch.Generator().manual_seed(6)
    for x in (inp["x"], inp["x2"]):
        _, m = step(state, shard_batch({"x": x}, mesh), gen)
    out = {"metric/loss": rank_mean(m["loss"], mesh), "generator": gen.get_state()}
    out.update(whole(state))
    return {"whole": out, "local": local(state, mesh)}


def perplexity(inp, mesh):
    """The code perplexity of rows whose codes differ by data rank: from
    the histogram of every data rank's codes (the model ranks' are the
    same codes)."""
    idx = shard_batch({"i": inp["codes"]}, mesh)["i"]
    with active(mesh):
        p = losses.codebook_perplexity(idx, Z_DIM)
    return {"whole": {"metric/perplexity": p}, "local": {}}


def ema_update(inp, mesh):
    """One EMA update of a codebook sharded by rows, under heavy smoothing
    (eps 1: the total count over every code shows), from every data rank's
    rows and their global indices."""
    cb, cluster, esum = inp["ema_cb"], inp["ema_cluster"], inp["ema_esum"]
    x = shard_batch({"x": inp["ema_x"]}, mesh)["x"]
    idx = shard_batch({"i": inp["ema_idx"]}, mesh)["i"]
    if mesh is not None:
        k = cb.shape[0] // mesh.n_model
        rows = slice(mesh.model_rank * k, (mesh.model_rank + 1) * k)
        cb, cluster, esum = cb[rows], cluster[rows], esum[rows]
    with active(mesh):
        out = vq_ops.codebook_ema_update(cb, cluster, esum, x, idx, decay=0.9, eps=1.0)
    if mesh is not None:
        out = [mesh.model_concat(t, 0) for t in out]
    return {"whole": dict(zip(("codebook", "codebook_ema/cluster", "codebook_ema/embed_sum"),
                              out)), "local": {}}


def search(inp, mesh):
    """The sharded nearest-code search (plain versions) against the whole
    codebook's: identical codes in different shards, an all-NaN row."""
    cb = inp["search_cb"]
    shard = cb
    if mesh is not None:
        k = cb.shape[0] // mesh.n_model
        shard = cb[mesh.model_rank * k:(mesh.model_rank + 1) * k].contiguous()
    with active(mesh):
        idx = vq_ops.vq(inp["search_x"], shard)
    return {"whole": {"indices": idx}, "local": {}}


def restore(inp, mesh):
    """A one-rank checkpoint (written by the test) restored into a fresh
    sharded state, then this rank's stepped flagship state saved (rank 0
    writes the whole tree, gathered) for the test to restore at M 1."""
    cfg = config()
    state = place(create_train_state(vqvae(inp), cfg.train), mesh)
    checkpoint.restore(inp["ckpt_m1"], state)
    out = {f"restored/{k}": t for k, t in whole(state).items() if not k.startswith("grad/")}
    _, _, stepped, _ = _step(inp, mesh)
    if mesh is not None:
        world = mesh.n_data * mesh.n_model
        checkpoint.save(os.path.join(inp["work"], f"ckpt_w{world}"), stepped, step=101,
                        extra={"arch": "vqvae"})
    return {"whole": out, "local": {}}


CASES = {f.__name__: f for f in (search, perplexity, ema_update, flagship, ema_restart, rvq, bf16,
                                 multistep, restore)}


def main(argv) -> None:
    rank, world, n_model, work = int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    torch.set_num_threads(1)
    distributed.initialize(f"file://{os.path.join(work, 'init')}", world, rank, device="cpu",
                           log=None)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    inp["work"] = work
    mesh = make_mesh(n_data=world // n_model, n_model=n_model)
    out = {name: case(inp, mesh) for name, case in CASES.items()}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv)

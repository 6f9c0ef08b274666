"""The transformer prior's tensor-parallel cases of
``tests/test_torch_prior_model_parallel.py``, and the rank process that
runs them.

``python tests/torch_prior_tp_worker.py <rank> <world> <n_model> <dir>``
joins a gloo group through ``file://<dir>/init`` inside
``distributed.process_group`` (the entry points' teardown), lays a (world /
n_model, n_model) mesh over it, reads the inputs the test wrote to
``<dir>/inputs.pt``, runs every case of ``CASES`` and writes
``<dir>/rank<r>.pt``. After the group is left it prints one JSON line,
``{"threads": [...]}``: the names of the process's native threads, in
which no gloo thread may remain. The test runs the same case functions in
its own process with ``mesh=None``: the one-rank reference.

A case returns ``{"whole": {...}, "local": {...}}`` as in
``tests/torch_tp_worker.py``, whose helpers it uses. This file imports
torch and the port, never JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import torch

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import TransformerPrior
from neural_sound_generation_tpu_torch.parallel import distributed, make_mesh, shard_batch
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import (
    make_eval_step,
    make_multistep_train,
    make_train_step,
)

from torch_tp_worker import place, rank_mean, warm, whole

K, DIM, HEADS, LAYERS, CLASSES, COND = 64, 32, 2, 2, 4, 8
B, H, W = 4, 4, 5
TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, initial_learning_rate=1e-3)
#: the priors the cases train: {kind: (n_experts, cond_dim)}
KINDS = {"dense": (0, 0), "routed": (4, 0), "bottom": (0, COND)}


def config() -> Config:
    cfg = Config()
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **TRAIN))


def prior(inp, kind: str, dtype: torch.dtype = torch.float32) -> TransformerPrior:
    """The kind's prior with the test's weights (converted from JAX)."""
    n_experts, cond_dim = KINDS[kind]
    model = TransformerPrior(K, DIM, LAYERS, HEADS, CLASSES, n_experts=n_experts,
                             spatial_cond=cond_dim > 0, cond_dim=cond_dim, max_rows=8,
                             max_cols=8, dtype=dtype)
    model.load_state_dict(inp[kind])
    return model


def batch(inp, kind: str, mesh, key: str = "codes") -> dict:
    out = {"codes": inp[key], "labels": inp["labels"]}
    if KINDS[kind][1]:
        out["cond"] = inp["cond"]
    return shard_batch(out, mesh)


def local(state, mesh) -> dict:
    """This rank's flat buffers and its (data, model) coordinates."""
    flat = state.flat
    coord = (0, 0) if mesh is None else (mesh.data_rank, mesh.model_rank)
    return {"flat": flat.flat.clone(), "grad": flat.grad.clone(),
            "moments": torch.cat([t.reshape(-1) for t in state.opt_state.moments()]),
            "split_at": torch.tensor(flat.split_at), "coord": torch.tensor(coord)}


def _step(inp, mesh, kind="dense", dtype=torch.float32, steps=1):
    cfg = config()
    model = prior(inp, kind, dtype)
    state = place(warm(create_train_state(model, cfg.train)), mesh)
    if steps == 1:
        _, m = make_train_step(model, cfg, mesh)(state, batch(inp, kind, mesh))
    else:
        b1, b2 = batch(inp, kind, mesh), batch(inp, kind, mesh, "codes2")
        stacked = {k: torch.stack([b1[k], b2[k]]) for k in b1}
        _, m = make_multistep_train(model, cfg, steps, mesh)(state, stacked)
        m = {"loss": m["loss"]}
    out = {f"metric/{k}": rank_mean(v, mesh) for k, v in m.items()}
    out.update(whole(state))
    return model, cfg, state, {"whole": out, "local": local(state, mesh)}


def dense(inp, mesh):
    """The dense prior's f32 step, then its eval step on the same batch."""
    model, cfg, state, out = _step(inp, mesh)
    _, em = make_eval_step(model, cfg, mesh)(state, batch(inp, "dense", mesh))
    out["whole"].update({f"eval/{k}": rank_mean(v, mesh) for k, v in em.items()})
    return out


def routed(inp, mesh):
    """The routed prior (4 experts: expert parallelism) in f32."""
    return _step(inp, mesh, "routed")[3]


def bf16(inp, mesh):
    """The dense prior's --bf16 step."""
    return _step(inp, mesh, dtype=torch.bfloat16)[3]


def routed_bf16(inp, mesh):
    """The routed prior's --bf16 step."""
    return _step(inp, mesh, "routed", dtype=torch.bfloat16)[3]


def bottom(inp, mesh):
    """The hierarchy's bottom level: a spatially conditioned prior
    (``cond_proj`` split with the embeddings)."""
    return _step(inp, mesh, "bottom")[3]


def multistep(inp, mesh):
    """--multi-steps 2 over a stacked super-batch."""
    return _step(inp, mesh, steps=2)[3]


def restore(inp, mesh):
    """A one-rank checkpoint (written by the test) restored into a fresh
    sharded state, then this rank's stepped dense state saved (rank 0
    writes the whole tree, gathered) for the test to restore at M 1."""
    cfg = config()
    state = place(create_train_state(prior(inp, "dense"), cfg.train), mesh)
    checkpoint.restore(inp["ckpt_m1"], state)
    out = {f"restored/{k}": t for k, t in whole(state).items() if not k.startswith("grad/")}
    _, _, stepped, _ = _step(inp, mesh)
    if mesh is not None:
        world = mesh.n_data * mesh.n_model
        checkpoint.save(os.path.join(inp["work"], f"ckpt_w{world}"), stepped, step=101,
                        extra={"arch": "transformer"})
    return {"whole": out, "local": {}}


CASES = {f.__name__: f for f in (dense, routed, bf16, routed_bf16, bottom, multistep, restore)}


def native_threads() -> list[str]:
    """The names of this process's threads (``/proc/self/task/*/comm``)."""
    names = []
    for tid in os.listdir("/proc/self/task"):
        with open(f"/proc/self/task/{tid}/comm", encoding="utf-8") as f:
            names.append(f.read().strip())
    return sorted(names)


def run(work: str, n_model: int) -> None:
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    inp["work"] = work
    mesh = make_mesh(n_model=n_model)
    out = {name: case(inp, mesh) for name, case in CASES.items()}
    torch.save(out, os.path.join(work, f"rank{mesh.rank}.pt"))


def main(argv) -> None:
    rank, world, n_model, work = int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    with distributed.process_group("cpu", log=None,
                                   coordinator_address=f"file://{os.path.join(work, 'init')}"):
        run(work, n_model)
    print(json.dumps({"threads": native_threads()}))


if __name__ == "__main__":
    main(sys.argv)

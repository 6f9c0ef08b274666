"""The sequence-parallel cases of ``tests/test_torch_sequence_parallel.py``,
and the rank process that runs them.

``python tests/torch_seq_worker.py <rank> <world> <dir>`` joins a gloo
group through ``file://<dir>/init`` inside ``distributed.process_group``,
reads the inputs the test wrote to ``<dir>/inputs.pt``, runs every case
of ``CASES`` on a (world, 1) mesh along its data axis and, at a world of
4, along the model axis of a (2, 2) mesh, then both refusals, and writes
``<dir>/rank<r>.pt``. After the group is left it prints one JSON line,
``{"threads": [...]}``: the names of the process's native threads, in
which no gloo thread may remain. This file imports torch and the port,
never JAX.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from neural_sound_generation_tpu_torch.parallel import distributed, make_mesh
from neural_sound_generation_tpu_torch.parallel.sequence import halo_conv1d, sharded_conv1d

from torch_prior_tp_worker import native_threads

B, T, CIN, COUT = 2, 32, 3, 5
#: name -> (K, dilation, causal)
CASES = {"causal_k5": (5, 1, True), "causal_k3_d4": (3, 4, True), "same_k5": (5, 1, False),
         "same_k4": (4, 1, False)}


def run_case(inp: dict, name: str, mesh, axis: str) -> dict:
    """``sharded_conv1d`` on the whole input, and ``halo_conv1d`` on this
    rank's shard, each with the gradients of sum(y * w)."""
    k, dilation, causal = CASES[name]
    kern = inp[f"kernel_k{k}"]
    x = inp["x"].clone().requires_grad_(True)
    kernel = kern.clone().requires_grad_(True)
    y = sharded_conv1d(x, kernel, mesh, causal=causal, dilation=dilation, axis=axis)
    (y * inp["w"]).sum().backward()
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    t = T // n
    x_local = inp["x"][:, i * t:(i + 1) * t].clone().requires_grad_(True)
    k_local = kern.clone().requires_grad_(True)
    y_local = halo_conv1d(x_local, k_local, axis, causal=causal, dilation=dilation, mesh=mesh)
    (y_local * inp["w"][:, i * t:(i + 1) * t]).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "kernel_grad": kernel.grad,
            "y_local": y_local.detach(), "x_local_grad": x_local.grad,
            "kernel_local_grad": k_local.grad, "index": i, "n": n}


def refusals(inp: dict, mesh) -> dict:
    """The messages of the two ``ValueError``s: a time axis that does not
    divide over the axis, and a halo longer than a shard."""
    out = {}
    short = inp["x"][:, :T - 1]
    try:
        sharded_conv1d(short, inp["kernel_k5"], mesh)
    except ValueError as e:
        out["indivisible"] = str(e)
    try:
        sharded_conv1d(inp["x"], inp["kernel_k5"], mesh, dilation=T)
    except ValueError as e:
        out["long_halo"] = str(e)
    return out


def run(work: str, world: int) -> None:
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    mesh = make_mesh(n_data=world)
    rec = {f"data.{name}": run_case(inp, name, mesh, "data") for name in CASES}
    rec["refusals"] = refusals(inp, mesh)
    if world == 4:
        inner = make_mesh(n_data=2, n_model=2)
        rec.update({f"model.{name}": run_case(inp, name, inner, "model") for name in CASES})
    torch.save(rec, os.path.join(work, f"rank{distributed.rank()}.pt"))


def main(argv) -> None:
    rank, world, work = int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank))
    with distributed.process_group("cpu", log=None,
                                   coordinator_address=f"file://{os.path.join(work, 'init')}"):
        run(work, world)
    print(json.dumps({"threads": native_threads()}))


if __name__ == "__main__":
    main(sys.argv)

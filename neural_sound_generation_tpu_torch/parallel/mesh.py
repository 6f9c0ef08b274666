"""The device mesh's ``data`` axis over the ranks of a process group.

Counterpart of the data half of ``neural_sound_generation_tpu/parallel/mesh.py``.
The JAX package builds one ``Mesh`` with ``data`` and ``model`` axes, shards
the batch over ``data`` and lets GSPMD insert the collectives, so the step
over a sharded batch computes the one-device step over the whole batch.
Here each rank is one process with one device (``parallel.distributed``),
and the collectives are explicit:

  * the batch: rank r keeps rows [r B / W, (r + 1) B / W) of the global
    batch B, the layout ``NamedSharding(mesh, P("data"))`` gives
    (``shard_batch``);
  * the state: every rank holds all of it, broadcast from rank 0 at the
    start and after a restore (``DataMesh.replicate``, the counterpart of
    ``replicated_sharding``);
  * the gradient: the train step all-reduces the flat gradient buffer once
    (SUM, then / W) ahead of the fused Adam kernel;
  * whatever the step computes over the batch rather than per row
    (BatchNorm's statistics, the masked means' denominators, the switch
    load-balance term, the EMA codebook's statistics and its restart
    candidates, the code histogram behind the perplexity) reads the mesh
    through ``current_mesh()`` and reduces over it. The train and eval
    steps make their mesh current (``active``) for their duration; outside them ``current_mesh()`` is None and every module
    computes over the rows it is given.

Every collective is an all-reduce or a broadcast: gloo, which serves ranks
that share a card, has no all-gather of CUDA tensors, so ``gather_rows``
all-reduces a zero-padded block (adding zeros is exact).

The ``model`` axis (``model_param_shardings``, ``_TP_RULES``, the per-leaf
optimizer, a codebook sharded by rows under the nearest-code kernel) and the
``pipe`` axis wait for later slices of the port; ``--mesh-model`` and
``--mesh-pipe`` refuse with ``MODEL_AXIS`` and ``PIPE_AXIS``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from neural_sound_generation_tpu_torch.parallel import distributed

MODEL_AXIS = ("the model axis (tensor and expert parallelism, the per-leaf optimizer) "
              "comes with a later parallel slice of the port")
PIPE_AXIS = ("the pipe axis (pipeline and sequence parallelism) comes with a later "
             "parallel slice of the port")

_CURRENT: contextvars.ContextVar[Optional["DataMesh"]] = contextvars.ContextVar(
    "nsg_data_mesh", default=None)


class _SumOverRanks(torch.autograd.Function):
    """y = sum over ranks of x on every rank; the backward sums the
    upstream gradients over ranks the same way."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g)
        return g


class DataMesh:
    """``n_data`` ranks along the ``data`` axis: the default process group,
    whose size it must be. Build it with ``make_mesh`` or
    ``mesh_from_args``."""

    def __init__(self, n_data: int):
        world = distributed.world_size()
        if n_data != world:
            raise ValueError(f"a data axis of {n_data} needs a group of {n_data} ranks, "
                             f"this one has {world}")
        self.n_data = n_data
        self.rank = distributed.rank()

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": 1}

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    # -- the batch -----------------------------------------------------------

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.n_data:
            raise ValueError(f"a batch of {n} rows does not split over {self.n_data} ranks")
        per = n // self.n_data
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard(self, x):
        """This rank's rows of one array or tensor (leading batch axis)."""
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1:
            return x[self.rows(x.shape[0])]
        raise TypeError(f"cannot shard a {type(x).__name__} over the batch axis")

    def shard_batch(self, batch: dict) -> dict:
        return {k: None if v is None else self.shard(v) for k, v in batch.items()}

    # -- collectives ---------------------------------------------------------

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over ranks, in place, outside autograd."""
        dist.all_reduce(t)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over ranks, in place: SUM, then / W (gloo has no AVG)."""
        return self.all_reduce_(t).div_(self.n_data)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks as a differentiable function: the backward
        sums the upstream gradients over ranks, so that with the train
        step's gradient average a quantity every rank computes from the
        global sum gets the gradient of the one-rank computation."""
        return _SumOverRanks.apply(t)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows, in rank order (the global batch order), on
        every rank; the ranks' row counts must be equal."""
        n = t.shape[0]
        out = t.new_zeros((self.n_data * n, *t.shape[1:]))
        out[self.rank * n:(self.rank + 1) * n] = t
        return self.all_reduce_(out)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Rank 0's values in place on every rank, sent as bytes (gloo
        broadcasts no bfloat16)."""
        if not t.is_contiguous():
            raise ValueError("broadcast needs a contiguous tensor")
        dist.broadcast(t.reshape(-1).view(torch.uint8), src=0)
        return t

    def replicate(self, state) -> None:
        """Rank 0's train state on every rank: the flat parameters, the
        step, the optimizer's count and moments, the EMA shadow, the EMA
        codebook statistics and the model's buffers (BatchNorm's running
        statistics)."""
        opt = state.opt_state
        tensors = [state.flat.flat, state.step, opt.count, opt.m, opt.v]
        if state.ema_params is not None:
            tensors.append(state.ema_params)
        tensors += list((state.codebook_ema or {}).values())
        tensors += list(state.model.buffers())
        for t in tensors:
            self.broadcast_(t)

    def build_first(self, device: torch.device, *kernel_modules) -> None:
        """On a CUDA ``device``, build each kernel's library on rank 0
        first; the others load it after a barrier (the build writes aside
        and renames, so a rank never reads half a library, but W ranks
        would run W compilers). Nothing on the CPU."""
        if device.type != "cuda":
            return
        if self.is_primary:
            for m in kernel_modules:
                m.load()
        distributed.barrier()
        if not self.is_primary:
            for m in kernel_modules:
                m.load()


def current_mesh() -> Optional[DataMesh]:
    """The data mesh of the step running in this context, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def active(mesh: Optional[DataMesh]) -> Iterator[Optional[DataMesh]]:
    """Make ``mesh`` ``current_mesh()`` for the body (None: a one-rank
    program)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DataMesh:
    """The data mesh over the process group (its whole world by default)."""
    if n_model != 1:
        raise NotImplementedError(MODEL_AXIS)
    return DataMesh(distributed.world_size() if n_data is None else n_data)


def mesh_from_args(mesh_data: Optional[int], mesh_model: int, batch_size: int,
                   log=print) -> Optional[DataMesh]:
    """The CLIs' shared mesh policy (the JAX ``mesh_from_args``): an
    explicit ``--mesh-data N`` must name the world's size; without it a
    world of more than one rank lays the data axis over all of them. The
    global batch must split evenly. A one-rank program gets no mesh.
    Exits (``SystemExit``) on a policy it cannot meet."""
    if mesh_model > 1:
        raise SystemExit(f"--mesh-model {mesh_model}: {MODEL_AXIS}")
    world = distributed.world_size()
    if mesh_data is not None and mesh_data != world:
        raise SystemExit(
            f"--mesh-data {mesh_data} asks for {mesh_data} data-parallel ranks, but this run "
            f"has {world}: launch one process per rank, torchrun --nproc_per_node "
            f"{mesh_data} -m ...")
    if world == 1:
        return None
    if batch_size % world:
        raise SystemExit(f"--batch-size {batch_size} does not split over {world} ranks")
    mesh = make_mesh(world)
    if mesh.is_primary and log is not None:
        log(f"Mesh: {mesh.shape} over {world} ranks, {batch_size // world} rows a rank")
    return mesh


def primary_print(mesh: Optional[DataMesh]):
    """``print`` on rank 0 (and without a mesh), a no-op on the others."""
    return print if mesh is None or mesh.is_primary else (lambda *a, **k: None)


def shard_batch(batch: Any, mesh: Optional[DataMesh]):
    """This rank's rows of a host or device batch (a dict of arrays or
    tensors with a leading batch axis); the batch itself without a mesh."""
    return batch if mesh is None else mesh.shard_batch(batch)

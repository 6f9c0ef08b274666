"""Process-group initialization and per-host data coordination.

Counterpart of ``neural_sound_generation_tpu/parallel/distributed.py``. The
JAX package connects the hosts of a pod slice with
``jax.distributed.initialize()`` and lets one mesh span every chip. Here
each process drives one device: ``torchrun`` (or the caller) starts one
process per card, ``initialize`` joins them into the default
``torch.distributed`` process group, ``subgroups`` splits it into the
data and model (or pipe) groups of a two-axis mesh, ``neighbour_groups``
into the two-rank groups of neighbours along an axis (pipeline stages,
the shards of a sequence), and
``parallel.mesh`` lays the ``data``, ``model`` and ``pipe`` axes over the
ranks. A single process stays a plain one-device
program, as in JAX: nothing is initialized.

The backend is a rule, logged when the group starts, never a fallback
taken on an error: NCCL when every rank of the host has a card of its own,
gloo on the CPU and where the ranks of one host outnumber its cards and so
share one (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class HostTopology:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    ``LOCAL_RANK``; the global rank where that is unset). Its card is
    ``local_rank() % torch.cuda.device_count()``."""
    local = _env_int("LOCAL_RANK")
    return local if local is not None else rank()


def choose_backend(device: str | torch.device | None, local_world: int) -> str:
    """``nccl`` when ``device`` is CUDA and each of the ``local_world``
    ranks of this host has a card of its own, else ``gloo``."""
    wants_cuda = device is None or torch.device(device).type == "cuda"
    if wants_cuda and torch.cuda.is_available() and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str | torch.device | None = None,
    log=print,
) -> HostTopology:
    """Join this process to the data-parallel group (a no-op for a single
    process) and return the topology.

    The arguments default to torchrun's environment: ``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``. ``coordinator_address`` is a
    ``host:port`` or any ``init_method`` URL (``tcp://``, ``file://``).
    ``device`` is what the entry point will run on (its ``--device``) and
    decides the backend; under NCCL this process's card is made current
    here, before any tensor exists. Call once, before the device is
    resolved."""
    world = num_processes if num_processes is not None else (_env_int("WORLD_SIZE") or 1)
    if world <= 1 or dist.is_initialized():
        return topology()
    rank_ = process_id if process_id is not None else _env_int("RANK")
    if rank_ is None:
        raise RuntimeError(f"a world of {world} processes needs this process's rank (RANK)")
    init_method = "env://"
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    backend = choose_backend(device, local_world)
    if backend == "nccl":
        torch.cuda.set_device(local_rank() % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_)
    if rank_ == 0 and log is not None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"Process group: {world} ranks over {backend} ({local_world} a host, "
            f"{cards} cards a host)")
    return topology()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def topology() -> HostTopology:
    """One device per process: the global device count is the world size."""
    world = world_size()
    return HostTopology(
        process_index=rank(),
        process_count=world,
        local_device_count=1,
        global_device_count=world,
    )


#: a group of one rank: its collectives are the identity and are not made
SOLO = object()

# (the default group, n_data, n_model) -> (data groups, model groups), so
# that a second mesh of the same shape creates no groups; ``shutdown``
# empties it
_SUBGROUPS: dict = {}


def subgroups(n_data: int, n_model: int):
    """This rank's (data group, model group) of a row-major (n_data,
    n_model) mesh over the world: rank r's model group is the n_model
    consecutive ranks of row r // n_model, its data group the ranks with
    the same r % n_model. Every rank creates every subgroup, in the same
    order (``dist.new_group`` is collective); a group of the whole world
    is the default group (None), one of a single rank ``SOLO``."""
    key = (dist.group.WORLD, n_data, n_model) if dist.is_initialized() else None
    if key is not None and key in _SUBGROUPS:
        made = _SUBGROUPS[key]
    else:
        world = n_data * n_model

        def make(ranks):
            if len(ranks) == 1:
                return SOLO
            return None if len(ranks) == world else dist.new_group(ranks)

        made = ([make(list(range(j, world, n_model))) for j in range(n_model)],
                [make(list(range(i * n_model, (i + 1) * n_model))) for i in range(n_data)])
        if key is not None:
            _SUBGROUPS[key] = made
    r = rank()
    return made[0][r % n_model], made[1][r // n_model]


def neighbour_groups(n_data: int, n_inner: int, along_data: bool = False):
    """This rank's two-rank groups with its neighbours along one axis of a
    row-major (n_data, n_inner) mesh: (the group with the rank before it on
    the axis, the group with the rank after it), each None (the default
    group) where it is the whole world and ``SOLO`` past either end. The
    inner axis (``along_data`` False: the pipe or model axis) pairs rank r
    at s = r % n_inner of row r // n_inner with s - 1 and s + 1 of its row;
    the data axis pairs it with the ranks of rows r // n_inner - 1 and + 1
    at its column. Every rank creates every pair of the axis, line by line
    and pair by pair, in the same order; they are cached as ``subgroups``'
    are."""
    kind = "data_pairs" if along_data else "pairs"
    key = (dist.group.WORLD, kind, n_data, n_inner) if dist.is_initialized() else None
    world = n_data * n_inner
    # (lines, length): the lines of ranks along the axis and their length
    lines, length = ((n_inner, n_data) if along_data else (n_data, n_inner))

    def member(line: int, pos: int) -> int:
        return pos * n_inner + line if along_data else line * n_inner + pos

    if key is not None and key in _SUBGROUPS:
        pairs = _SUBGROUPS[key]
    else:
        pairs = [[None if world == 2 else dist.new_group([member(i, s), member(i, s + 1)])
                  for s in range(length - 1)] for i in range(lines)]
        if key is not None:
            _SUBGROUPS[key] = pairs
    row, col = divmod(rank(), n_inner)
    line, s = (col, row) if along_data else (row, col)
    return (pairs[line][s - 1] if s > 0 else SOLO,
            pairs[line][s] if s < length - 1 else SOLO)


def is_primary() -> bool:
    return rank() == 0


def loader_shard_args() -> dict:
    """kwargs for ``data.sampler.shard_for_host``: this host's slice of
    the batch stream (the DistributedBucketingSampler rank semantics)."""
    t = topology()
    return {"num_hosts": t.process_count, "host_id": t.process_index}


def barrier() -> None:
    """Wait for every rank (no-op for a single process)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group and let go of every group object, so that
    gloo's worker threads are joined here, while the interpreter is whole.

    A gloo group runs each collective on a worker thread of its own, which
    drops its reference to the collective's tensors a moment after the
    caller's wait returns. A group still referenced when the interpreter
    finalizes (by ``_SUBGROUPS``, whose keys hold the default group, or by
    a mesh in a reference cycle) keeps those threads alive; one that then
    frees a tensor owned by Python takes the GIL, is ended by
    ``pthread_exit`` and unwinds through a ``noexcept`` destructor: the
    process aborts (``terminate called without an active exception``).
    Dropping the cache and collecting cycles before ``destroy_process_group``
    destroys the groups, whose destructors join their threads."""
    _SUBGROUPS.clear()
    gc.collect()
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def process_group(device: str | torch.device | None = None, log=print,
                  coordinator_address: Optional[str] = None):
    """``initialize`` for the body of an entry point: yields the topology.
    When the body returns, every rank waits at a barrier, so that what
    rank 0 wrote is whole before any rank goes on to read it; a group
    this call started is then left (``shutdown``). A group that already
    existed (a caller's) stays. ``coordinator_address`` is
    ``initialize``'s (torchrun's environment when None)."""
    owned = not dist.is_initialized()
    topo = initialize(coordinator_address, device=device, log=log)
    try:
        yield topo
        barrier()
    finally:
        if owned and dist.is_initialized():
            shutdown()

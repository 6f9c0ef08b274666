"""The device mesh's ``data``, ``model`` and ``pipe`` axes over the ranks of a process group.

Counterpart of ``neural_sound_generation_tpu/parallel/mesh.py``. The JAX
package builds one ``Mesh`` with ``data`` and ``model`` axes, shards the
batch over ``data`` and, under ``--mesh-model``, the codebook rows and the
convolutions' output channels over ``model``, and lets GSPMD insert the
collectives, so the sharded step computes the one-device step over the
whole batch. Here each rank is one process with one device
(``parallel.distributed``) and the collectives are explicit.

Crossing the mesh. ``make_mesh`` lays the world row-major over (n_data,
n_model), as JAX's ``make_mesh`` reshapes its devices: rank r sits at
(r // M, r % M), M = n_model. Its **model group** is the M consecutive
ranks of its row (the same rows of the batch, a slice each of every
sharded parameter); its **data group** is the D ranks of its column
(ranks with the same r % M: the same parameter slices, other rows). Every
rank creates every subgroup, in one order. Which collective runs over
which group:

  * the batch: a data-group rank d keeps rows [d B / D, (d + 1) B / D) of
    the global batch B, the layout ``NamedSharding(mesh, P("data"))``
    gives (``shard_batch``); the M ranks of a model group hold the same
    rows;
  * the gradient: the train step all-reduces the flat gradient buffer once
    over the **data group** (SUM, then / D) ahead of the fused Adam kernel;
  * whatever the step computes over the batch rather than per row
    (BatchNorm's statistics of the channels a rank holds, the masked
    means' denominators, the switch load-balance term, the EMA codebook's
    statistics of the rows a rank holds and its restart candidates, the
    code histogram behind the perplexity) reads the mesh through
    ``current_mesh()`` and reduces over the **data group**: a sum over the
    world would add the model ranks' copies of the same rows. The train
    and eval steps make their mesh current (``active``) for their
    duration; outside them ``current_mesh()`` is None and every module
    computes over the rows it is given;
  * tensor parallelism (``n_model`` > 1, ``training.sharding`` places the
    state): a column-split layer takes its whole input through
    ``copy_to_model`` (identity forward, an all-reduce of the input's
    gradient over the **model group** backward: each rank's gradient
    covers only its output channels) and its output slice through
    ``gather_channels`` (the whole channels forward, this rank's slice of
    the gradient backward); a row-split layer's partial product goes
    through ``reduce_from_model`` (an all-reduce over the **model group**
    forward, the identity backward: the whole output's gradient is already
    on every rank); the nearest-code search merges the ranks'
    (score, index) pairs and the lookup all-reduces the owners' rows over
    the **model group** (``ops.vq``); the gradient's global norm sums the
    sharded segment's squares over the **model group**;
  * the state: a data group's ranks hold the same values, broadcast from
    its first rank at the start and after a restore (``replicate``, the
    counterpart of ``replicated_sharding``); the ranks of a model group
    hold the same replicated leaves, computed alike, and a slice each of
    the sharded ones. On the card cuDNN's weight gradients are not
    bit-deterministic, so the model ranks' gradients of a replicated leaf
    can part in the last bits: the step takes model rank 0's
    (``model_broadcast_`` of the flat gradient's replicated segment after
    the data-group mean), and the replicated leaves stay bit-equal.

What each leaf's gradient must equal: the one-rank gradient over the
global batch. A replicated leaf is computed whole, from whole tensors, on
every rank of a model group, so its gradient there is already the whole
one and takes no model-group sum; a sharded leaf's gradient is the slice
of the one-rank gradient; the data-group mean then averages the rows.

Every collective is an all-reduce or a broadcast: gloo, which serves ranks
that share a card, has no all-gather of CUDA tensors and no bfloat16
broadcast, so ``gather_rows`` and ``gather_channels`` all-reduce a
zero-padded block (adding zeros is exact; a bfloat16 block goes as
float32) and ``broadcast_`` sends bytes.

The tensor-parallel table is JAX's ``_TP_RULES`` on its flax path names
(``model_param_shardings``, with ``flax_leaf`` mapping a port parameter to
its flax path and axes); ``training.sharding`` lays a state out by it. The
``model`` axis covers every family: the four autoencoders of ``cli.main``
(the flat mel VQ-VAE, HierVQVAE, WaveVQVAE, the VAE), the transformer
prior (dense or routed), and the gated families, WaveNet and the
GatedPixelCNN, whose gates split their pre-activation block-wise
(``gather_channels(..., groups=2)`` puts it back in the leaf's order).

The pipe axis (``n_pipe`` > 1; ``parallel.pipeline`` runs the stages)
takes the model axis's place in the same arithmetic, as JAX's
``make_pp_mesh`` lays (data, pipe) with pipe innermost: rank r sits at
stage r % S of data row r // S. Its **pipe group** is the S ranks of its
row (the same rows of the batch, a stage each); its **data group** the
ranks of its stage, which is what ``current_mesh()`` reduces over. A
stage hands its activations to the next stage, and their gradients back,
through a two-rank group per neighbouring pair (``send_along`` and
``recv_along`` on "pipe": the sender broadcasts, as bytes); the rest's
gradient and the clip norm's stage segments are summed
over the pipe group (``pipe_all_reduce_``). A mesh has a model axis or a
pipe axis, not both.

The same hand-off runs between neighbours along any axis
(``axis_size``, ``axis_index``, ``axis_group`` and ``axis_rank`` read an
axis by name): ``parallel.sequence`` exchanges its convolutions' halos
along the data axis by default.
"""

from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Any, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from neural_sound_generation_tpu_torch.parallel import distributed
from neural_sound_generation_tpu_torch.parallel.distributed import SOLO

_CURRENT: contextvars.ContextVar[Optional["Mesh"]] = contextvars.ContextVar(
    "nsg_mesh", default=None)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """SUM over ``group`` in place (``None``: the world; ``SOLO``: nothing)."""
    if group is not SOLO:
        dist.all_reduce(t, group=group)
    return t


class _SumOverGroup(torch.autograd.Function):
    """y = sum over the group of x on every rank; the backward sums the
    upstream gradients over the group the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward; the backward sums the input's
    gradient over the model group (each rank's covers its output channels
    only)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_all_reduce(grad), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g for a row split: the sum of the model group's partial
    products forward; the identity backward (the upstream gradient of the
    whole sum is the same on every rank, and each rank's partial takes it
    whole). ``_SumOverGroup``'s backward would sum it again, M times too
    much."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """Megatron's g for a column split: every rank's slice along ``dim``
    (1, a convolution's channels; -1, a linear layer's features), in rank
    order, forward; this rank's slice of the gradient backward (the
    gradient of a whole tensor is the same on every rank of the model
    group). With ``groups`` g the axis is g equal blocks, each split alike
    over the ranks (a gate's tanh and sigmoid halves): the output is block
    by block, every rank's slice of block 0, then of block 1, the leaf's
    own channel order."""

    @staticmethod
    def forward(ctx, x, mesh, dim, groups):
        dim = dim % x.dim()
        ctx.mesh, ctx.dim, ctx.groups = mesh, dim, groups
        ctx.c = x.shape[dim] // groups
        blocks = x.unflatten(dim, (groups, -1))
        return mesh.model_concat(blocks, dim=dim + 1).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, grad):
        c, dim = ctx.c, ctx.dim
        blocks = grad.unflatten(dim, (ctx.groups, -1))
        mine = blocks.narrow(dim + 1, ctx.mesh.model_rank * c, c).flatten(dim, dim + 1)
        return mine, None, None, None


def _axis(axis: str) -> str:
    if axis not in ("data", "model", "pipe"):
        raise ValueError(f"unknown mesh axis {axis!r}: data, model or pipe")
    return axis


class Mesh:
    """``n_data`` x ``n_model`` (or ``n_data`` x ``n_pipe``) ranks,
    row-major over the default process group, whose size must be their
    product. Build it with ``make_mesh``, ``mesh_from_args`` or
    ``parallel.pipeline.make_pp_mesh``."""

    def __init__(self, n_data: int, n_model: int = 1, n_pipe: int = 1):
        world = distributed.world_size()
        if n_model > 1 and n_pipe > 1:
            raise ValueError("a mesh has a model axis or a pipe axis, not both")
        inner = n_model * n_pipe
        if n_data < 1 or n_model < 1 or n_pipe < 1 or n_data * inner != world:
            raise ValueError(f"a mesh of {n_data} x {inner} needs a group of "
                             f"{n_data * inner} ranks, this one has {world}")
        self.n_data, self.n_model, self.n_pipe = n_data, n_model, n_pipe
        self.rank = distributed.rank()
        # the column: this rank's place in its row, and the global rank of
        # the first rank of its data group
        self.data_rank, self.column = divmod(self.rank, inner)
        self.model_rank = self.column if n_model > 1 else 0
        self.stage = self.column if n_pipe > 1 else 0
        self.data_group, inner_group = distributed.subgroups(n_data, inner)
        self.model_group = inner_group if n_model > 1 else SOLO
        self.pipe_group = inner_group if n_pipe > 1 else SOLO
        # {axis: (the pair group with the rank before, the one after)},
        # made at first use (the pipe axis's here: every stage hands off)
        self._pairs: dict = {}
        if n_pipe > 1:
            self.neighbour_group("pipe", 1)

    @property
    def shape(self) -> dict:
        if self.n_pipe > 1:
            return {"data": self.n_data, "pipe": self.n_pipe}
        return {"data": self.n_data, "model": self.n_model}

    @property
    def tensor_parallel(self) -> bool:
        return self.n_model > 1

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    # -- the batch -----------------------------------------------------------

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.n_data:
            raise ValueError(f"a batch of {n} rows does not split over {self.n_data} ranks")
        per = n // self.n_data
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def shard(self, x):
        """This rank's rows of one array or tensor (leading batch axis)."""
        if isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1:
            return x[self.rows(x.shape[0])]
        raise TypeError(f"cannot shard a {type(x).__name__} over the batch axis")

    def shard_batch(self, batch: dict) -> dict:
        return {k: None if v is None else self.shard(v) for k, v in batch.items()}

    # -- collectives over the data group ---------------------------------------

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the data group, in place, outside autograd."""
        return _all_reduce(t, self.data_group)

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data group, in place: SUM, then / D (gloo has
        no AVG)."""
        return self.all_reduce_(t).div_(self.n_data)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data group as a differentiable function: the
        backward sums the upstream gradients over the group, so that with
        the train step's gradient average a quantity every rank computes
        from the global sum gets the gradient of the one-rank computation."""
        return _SumOverGroup.apply(t, self.data_group)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data-group rank's rows, in rank order (the global batch
        order), on every rank; the ranks' row counts must be equal."""
        n = t.shape[0]
        out = t.new_zeros((self.n_data * n, *t.shape[1:]))
        out[self.data_rank * n:(self.data_rank + 1) * n] = t
        return self.all_reduce_(out)

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's first rank's values in place on every rank of
        the group, sent as bytes (gloo broadcasts no bfloat16)."""
        if not t.is_contiguous():
            raise ValueError("broadcast needs a contiguous tensor")
        if self.data_group is not SOLO:
            # src is a global rank: the first of this data group
            dist.broadcast(t.reshape(-1).view(torch.uint8), src=self.column,
                           group=self.data_group)
        return t

    def replicate(self, state) -> None:
        """The data group's first rank's train state on every rank of the
        group: the flat parameters, the step, the optimizer's count and
        moments, the EMA shadow, the EMA codebook statistics and the
        model's buffers (BatchNorm's running statistics). Under the model
        axis each data group holds one set of slices."""
        opt = state.opt_state
        tensors = [state.flat.flat, state.step, opt.count, *opt.moments()]
        if state.ema_params is not None:
            tensors.append(state.ema_params)
        tensors += list((state.codebook_ema or {}).values())
        tensors += list(state.model.buffers())
        for t in tensors:
            self.broadcast_(t)

    # -- collectives over the model group --------------------------------------

    def model_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the model group, out of place, outside autograd; a
        bfloat16 tensor is summed in float32 and rounded once."""
        if t.dtype == torch.bfloat16:
            return _all_reduce(t.float(), self.model_group).to(t.dtype)
        return _all_reduce(t.clone(), self.model_group)

    def model_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the model group, in place, outside autograd (float32)."""
        return _all_reduce(t, self.model_group)

    def model_broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """Model rank 0's values in place on every rank of the model group,
        sent as bytes."""
        if self.model_group is not SOLO:
            dist.broadcast(t.reshape(-1).view(torch.uint8), src=self.data_rank * self.n_model,
                           group=self.model_group)
        return t

    def model_concat(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every model-group rank's ``t`` concatenated along ``dim`` in rank
        order, on every rank, outside autograd: a zero-padded all-reduce
        (bfloat16 as float32: adding zeros is exact either way)."""
        c = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = c * self.n_model
        wide = t.float() if t.dtype == torch.bfloat16 else t
        out = wide.new_zeros(shape)
        out.narrow(dim, self.model_rank * c, c).copy_(wide)
        return _all_reduce(out, self.model_group).to(t.dtype)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """A column-split layer's whole input: the identity forward, the
        gradient summed over the model group backward."""
        return _CopyToModel.apply(x, self)

    def gather_channels(self, x: torch.Tensor, dim: int = 1, groups: int = 1) -> torch.Tensor:
        """A column-split layer's output slice (B, C / M, ...) -> the whole
        (B, C, ...) (``dim`` 1; -1 for a linear layer's (..., C / M)),
        differentiable (the backward keeps this rank's slice). With
        ``groups`` g the slice is g blocks of C / (g M), each rank's slice
        of each of the leaf's g blocks (``training.sharding``'s grouped
        split), and the whole comes back in the leaf's order: for a gate's
        g = 2, [tanh 0..C/2 | sigmoid 0..C/2], not the ranks' slices side
        by side."""
        return _GatherChannels.apply(x, self, dim, groups)

    def reduce_from_model(self, x: torch.Tensor) -> torch.Tensor:
        """A row-split layer's partial product -> the whole one, summed over
        the model group (bfloat16 in float32, rounded once), differentiable
        (the backward passes the gradient through)."""
        return _ReduceFromModel.apply(x, self)

    # -- the pipe axis -----------------------------------------------------------

    def pipe_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the pipe group, in place, outside autograd."""
        return _all_reduce(t, self.pipe_group)

    def pipe_broadcast_(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        """``stage``'s values in place on every rank of the pipe group,
        sent as bytes."""
        if self.pipe_group is not SOLO:
            dist.broadcast(t.reshape(-1).view(torch.uint8), src=self.axis_rank("pipe", stage),
                           group=self.pipe_group)
        return t

    # -- any axis ----------------------------------------------------------------

    def axis_size(self, axis: str) -> int:
        """The number of ranks along ``axis`` ("data", "model" or "pipe")."""
        return {"data": self.n_data, "model": self.n_model, "pipe": self.n_pipe}[_axis(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's place along ``axis``."""
        return {"data": self.data_rank, "model": self.model_rank,
                "pipe": self.stage}[_axis(axis)]

    def axis_group(self, axis: str):
        """The group of the ranks along ``axis`` through this rank."""
        return {"data": self.data_group, "model": self.model_group,
                "pipe": self.pipe_group}[_axis(axis)]

    def axis_rank(self, axis: str, index: int) -> int:
        """The global rank at ``index`` along ``axis`` on this rank's line."""
        inner = self.n_model * self.n_pipe
        if _axis(axis) == "data":
            return index * inner + self.column
        return self.data_rank * inner + index

    def neighbour_group(self, axis: str, step: int):
        """The two-rank group of this rank and its neighbour at ``step``
        (-1 or +1) along ``axis``; ``SOLO`` past either end. Every rank
        makes an axis's pairs at the first call for that axis, together."""
        if axis not in self._pairs:
            n_inner = self.n_model * self.n_pipe
            if _axis(axis) == "data":
                self._pairs[axis] = distributed.neighbour_groups(self.n_data, n_inner, True)
            elif self.axis_size(axis) > 1:
                self._pairs[axis] = distributed.neighbour_groups(self.n_data, n_inner)
            else:
                self._pairs[axis] = (SOLO, SOLO)
        return self._pairs[axis][0 if step < 0 else 1]

    def _hand(self, t: torch.Tensor, axis: str, step: int, src: int) -> torch.Tensor:
        if not t.is_contiguous():
            raise ValueError("a hand-off needs a contiguous tensor")
        group = self.neighbour_group(axis, step)
        if group is SOLO:
            raise ValueError(f"rank {self.rank} has no neighbour at {step:+d} along {axis!r}")
        dist.broadcast(t.reshape(-1).view(torch.uint8), src=src, group=group)
        return t

    def send_along(self, t: torch.Tensor, axis: str, step: int) -> None:
        """Hand ``t`` to the neighbour at ``step`` (-1 or +1) along ``axis``
        (its ``recv_along(buf, axis, -step)``): the sender broadcasts over
        their two-rank group, as bytes."""
        self._hand(t, axis, step, self.rank)

    def recv_along(self, buf: torch.Tensor, axis: str, step: int) -> torch.Tensor:
        """The neighbour at ``step`` along ``axis``'s ``send_along`` into
        ``buf``, in place."""
        return self._hand(buf, axis, step, self.axis_rank(axis, self.axis_index(axis) + step))

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


def current_mesh() -> Optional[Mesh]:
    """The mesh of the step running in this context, or None."""
    return _CURRENT.get()


def model_axis() -> Optional[Mesh]:
    """The current mesh when it has a model axis (``n_model`` > 1), else
    None: what the sharded layers and the sharded search read."""
    mesh = _CURRENT.get()
    return mesh if mesh is not None and mesh.n_model > 1 else None


@contextlib.contextmanager
def active(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` ``current_mesh()`` for the body (None: a one-rank
    program)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) mesh over the process group; ``n_data``
    defaults to the world's size over ``n_model``."""
    if n_data is None:
        n_data = distributed.world_size() // max(n_model, 1)
    return Mesh(n_data, n_model)


def mesh_from_args(mesh_data: Optional[int], mesh_model: int, batch_size: int,
                   log=print) -> Optional[Mesh]:
    """The CLIs' shared mesh policy (the JAX ``mesh_from_args``): a world
    of W ranks lays a (W / M, M) mesh, M = ``--mesh-model``, which must
    divide W; an explicit ``--mesh-data D`` must make D x M = W. The
    global batch must split over the data axis. A one-rank program gets no
    mesh. Exits (``SystemExit``) on a policy it cannot meet."""
    world = distributed.world_size()
    if mesh_model < 1:
        raise SystemExit(f"--mesh-model {mesh_model}: must be at least 1")
    if world % mesh_model:
        raise SystemExit(
            f"--mesh-model {mesh_model}: the model axis (tensor parallel) of {mesh_model} ranks "
            f"needs a world of n_data x {mesh_model} ranks, but this run has {world}: launch "
            f"torchrun --nproc_per_node {mesh_model * (mesh_data or 1)} -m ...")
    if mesh_data is not None and mesh_data * mesh_model != world:
        if mesh_model == 1:
            raise SystemExit(
                f"--mesh-data {mesh_data} asks for {mesh_data} data-parallel ranks, but this "
                f"run has {world}: launch one process per rank, torchrun --nproc_per_node "
                f"{mesh_data} -m ...")
        raise SystemExit(
            f"--mesh-data {mesh_data} --mesh-model {mesh_model} asks for "
            f"{mesh_data * mesh_model} ranks, but this run has {world}: launch one process "
            f"per rank, torchrun --nproc_per_node {mesh_data * mesh_model} -m ...")
    if world == 1:
        return None
    n_data = world // mesh_model
    if batch_size % n_data:
        raise SystemExit(f"--batch-size {batch_size} does not split over {n_data} ranks")
    mesh = make_mesh(n_data, mesh_model)
    if mesh.is_primary and log is not None:
        log(f"Mesh: {mesh.shape} over {world} ranks, {batch_size // n_data} rows a rank"
            + (" (tensor parallel)" if mesh.tensor_parallel else ""))
    return mesh


# JAX's _TP_RULES (parallel/mesh.py there): a flax path pattern -> the dim
# of the leaf that shards over 'model' (-2 the codes axis of a flat or a
# residual codebook, -1 a kernel's output channels, 0 the experts' axis)
_TP_RULES = (
    (re.compile(r"\['codebook(_top|_bottom)?'\]$"), -2),
    (re.compile(r"\['(encoder|decoder)'\].*\['kernel'\]$"), -1),
    (
        re.compile(
            r"\['(dilated|cond|res|skip)_\d+'\]\['kernel'\]$|"
            r"\['(post1|post2|first_conv)'\]\['kernel'\]$|"
            r"\['upsampler'\].*\['kernel'\]$"
        ),
        -1,
    ),
    (
        re.compile(
            r"\['layer_\d+'\]\['(vert|horiz)_kernel'\]$|"
            r"\['(vert_to_horiz|horiz_resid|spatial_cond"
            r"|out_hidden|out_logits)'\]\['kernel'\]$|"
            r"\['(embedding|class_cond_embedding)'\]\['embedding'\]$"
        ),
        -1,
    ),
    (re.compile(r"\['block_\d+'\]\['(attn_qkv|mlp_in)'\]\['kernel'\]$"), -1),
    (re.compile(r"\['block_\d+'\]\['(attn_out|mlp_out)'\]\['kernel'\]$"), -2),
    (
        re.compile(
            r"\['(head|cond_proj)'\]\['kernel'\]$|"
            r"\['(tok_embed|class_embed|row_embed|col_embed)'\]"
            r"\['embedding'\]$"
        ),
        -1,
    ),
    (re.compile(r"\['block_\d+'\]\['moe'\]\['(w_in|w_out|b_in|b_out)'\]$"), 0),
)

_CONV = (nn.Conv1d, nn.Conv2d)
_TRANSPOSE = (nn.ConvTranspose1d, nn.ConvTranspose2d)
_NORMS = (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)
# the PixelCNN's raw kernels: flax HWIO, the port OIHW
_RAW_KERNELS = ("vert_kernel", "horiz_kernel")


def flax_leaf(model: nn.Module, name: str) -> tuple[str, list[int]]:
    """A parameter of the port's ``model`` as JAX sees it: its flax path
    (``jax.tree_util.keystr`` of the params tree) and, for each flax axis,
    the torch axis it is (the ``convert.py`` layouts)."""
    prefix, _, leaf = name.rpartition(".")
    module = model.get_submodule(prefix) if prefix else model
    param = getattr(module, leaf)
    ndim = param.dim()
    path = [p for p in prefix.split(".") if p]
    same = list(range(ndim))
    if isinstance(module, _CONV + _TRANSPOSE) and leaf == "weight":
        spatial = list(range(2, ndim))
        io = [0, 1] if isinstance(module, _TRANSPOSE) else [1, 0]  # flax (..., in, out)
        return _keystr(path + ["kernel"]), spatial + io
    if isinstance(module, nn.Linear) and leaf == "weight":
        return _keystr(path + ["kernel"]), [1, 0]
    if isinstance(module, nn.Embedding):
        return _keystr(path + ["embedding"]), same
    if isinstance(module, _NORMS) and leaf == "weight":
        return _keystr(path + ["scale"]), same
    if leaf in _RAW_KERNELS:
        return _keystr(path + [leaf]), [2, 3, 1, 0]
    return _keystr(path + [leaf]), same


def _keystr(path: list[str]) -> str:
    return "".join(f"['{p}']" for p in path)


def model_param_shardings(model: nn.Module, n_model: int) -> dict[str, int]:
    """JAX's ``model_param_shardings`` with ``tensor_parallel`` on, for the
    port's module: {parameter name: the torch axis split over the model
    axis} for the leaves ``_TP_RULES`` shard; every other leaf is
    replicated. As in JAX, a rule whose axis does not divide by
    ``n_model`` passes to the next, and a leaf no rule shards stays whole."""
    out: dict[str, int] = {}
    if n_model <= 1:
        return out
    for name, param in model.named_parameters():
        path, to_torch = flax_leaf(model, name)
        for pattern, dim in _TP_RULES:
            if not pattern.search(path) or param.dim() == 0:
                continue
            flax_axis = dim if dim >= 0 else param.dim() + dim
            if not 0 <= flax_axis < param.dim():
                continue
            axis = to_torch[flax_axis]
            if param.shape[axis] % n_model == 0:
                out[name] = axis
                break
    return out


def primary_print(mesh: Optional[Mesh]):
    """``print`` on rank 0 (and without a mesh), a no-op on the others."""
    return print if mesh is None or mesh.is_primary else (lambda *a, **k: None)


def shard_batch(batch: Any, mesh: Optional[Mesh]):
    """This rank's rows of a host or device batch (a dict of arrays or
    tensors with a leading batch axis); the batch itself without a mesh."""
    return batch if mesh is None else mesh.shard_batch(batch)

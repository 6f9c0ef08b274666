"""Train-state placement over the mesh's model axis (tensor parallelism).

Counterpart of ``neural_sound_generation_tpu/training/sharding.py`` and of
the tensor-parallel half of ``neural_sound_generation_tpu/parallel/mesh.py``
(``_TP_RULES``, ``model_param_shardings``). The JAX package places one
state on the mesh with the codebook rows and every encoder/decoder
kernel's output channels sharded over ``model`` and lets GSPMD insert the
collectives. Here each rank keeps its own slices (``shard_train_state``):

  * the table (``parallel.mesh``). ``_TP_RULES`` is JAX's, on JAX's flax
    path names; ``model_param_shardings`` maps each parameter of the
    port's module to its flax path and the rule's flax axis to the torch
    axis of the leaf (a flax Conv ``kernel``'s output axis, -1, is dim 0
    of a ``Conv2d.weight`` and dim 1 of a ``ConvTranspose2d.weight``; a
    codebook's codes axis, -2, is dim 0 of (K, D) and dim 1 of (Q, K,
    D)). As in JAX, a leaf whose axis does not divide by M stays whole:
    the decoder's last ``ConvTranspose_1``, whose output is the input's
    one channel.
  * where the port departs from ``_TP_RULES`` (``tensor_parallel_layout``):
    a column-split convolution's bias, and the scale, offset and running
    statistics of the BatchNorm after it (or GroupNorm, whose groups of 8
    must then not straddle ranks), are split with its kernel, Megatron's
    layout. JAX keeps them whole and GSPMD reshards around them; a rank
    that used a slice of a whole leaf would hold only part of its
    gradient, where a split leaf's gradient is whole for its slice.
  * the state. Each rank's flat buffer holds its slices (first) and the
    whole replicated leaves (``FlatParams(first=...)``); its Adam moments
    and EMA shadow mirror the parameters, and the EMA codebook statistics
    the codebook's rows. The step, the count and the hyperparameters are
    whole. ``gather_train_state`` inverts it over the model group, for
    rank 0's checkpoint (``training.checkpoint`` writes the whole tree in
    its one format, so a checkpoint from an M-way run resumes at any M and
    serves without a mesh) and restore slices a whole tree
    (``ModelShards.slice_tensors``).

Crossing the 2-D mesh (``parallel.mesh`` has the groups): rank r sits at
(r // M, r % M); a model group's M ranks hold the same rows and one slice
each, a data group's D ranks the same slices and other rows. What each
leaf's gradient must equal is the one-rank gradient over the global batch:
a split leaf's is the slice of it, which only its owner computes (the
model runs every split layer's input through ``copy_to_model``, whose
backward sums the input's gradient over the model group, and gathers the
outputs); a replicated leaf's is computed whole, alike, on every rank of
the model group and takes no model-group sum. The step then averages the
flat gradient over the data group, and the clip's global norm sums the
split segment's squares over the model group.

The layout covers the flat mel ``VQVAE`` (one codebook or residual VQ);
the other families wait for later slices (``parallel.mesh.
MODEL_AXIS_FAMILIES``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import BatchNorm, GroupNorm
from neural_sound_generation_tpu_torch.models.vqvae import VQVAE
from neural_sound_generation_tpu_torch.parallel.mesh import (
    MODEL_AXIS_FAMILIES,
    model_param_shardings,
)
from neural_sound_generation_tpu_torch.training.train_state import (
    FlatParams,
    FusedOptState,
    LeafOptState,
    TrainState,
)

_TRANSPOSE = (nn.ConvTranspose1d, nn.ConvTranspose2d)
_CONVS = (nn.Conv1d, nn.Conv2d, *_TRANSPOSE)


def _norm_after(model: nn.Module, conv_name: str) -> Optional[str]:
    """The norm that normalizes a convolution's output in the VQ-VAE's
    modules: ``Conv_i`` or ``ConvTranspose_i`` -> the norm of index i of
    the same module, where it has one."""
    prefix, _, conv = conv_name.rpartition(".")
    parent = model.get_submodule(prefix) if prefix else model
    index = conv.rpartition("_")[2]
    for norm in (f"BatchNorm_{index}", f"GroupNorm_{index}"):
        if hasattr(parent, norm):
            return f"{prefix}.{norm}" if prefix else norm
    return None


@dataclasses.dataclass
class Layout:
    """The port's tensor-parallel table for one model and M: the split
    axis of each sharded parameter and buffer, and the column-split
    convolutions and norms."""

    params: dict
    buffers: dict
    convs: list
    norms: list


def tensor_parallel_layout(model: nn.Module, n_model: int) -> Layout:
    """``model_param_shardings`` plus the port's departure: a column-split
    convolution's bias and the norm after it (scale, offset, BatchNorm's
    running statistics) split with its kernel."""
    if not isinstance(model, VQVAE):
        raise NotImplementedError(f"{type(model).__name__}: {MODEL_AXIS_FAMILIES}")
    params = model_param_shardings(model, n_model)
    buffers: dict[str, int] = {}
    convs, norms = [], []
    for name, axis in list(params.items()):
        prefix, _, leaf = name.rpartition(".")
        module = model.get_submodule(prefix) if prefix else model
        if not isinstance(module, _CONVS):
            continue
        if axis != (1 if isinstance(module, _TRANSPOSE) else 0):
            raise NotImplementedError(f"{name}: only output-channel splits are laid out")
        convs.append(prefix)
        if module.bias is not None:
            params[f"{prefix}.bias"] = 0
        norm = _norm_after(model, prefix)
        if norm is None:
            continue
        norm_module = model.get_submodule(norm)
        if isinstance(norm_module, GroupNorm) and (
                norm_module.num_channels // n_model) % (norm_module.num_channels
                                                        // norm_module.num_groups):
            raise NotImplementedError(f"{norm}: its groups straddle the model ranks")
        norms.append(norm)
        params[f"{norm}.weight"] = params[f"{norm}.bias"] = 0
        if isinstance(norm_module, BatchNorm):
            buffers[f"{norm}.running_mean"] = buffers[f"{norm}.running_var"] = 0
    return Layout(params, buffers, convs, norms)


def _slice(t: torch.Tensor, axis: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[axis] // n
    return t.narrow(axis, rank * size, size).contiguous()


@dataclasses.dataclass
class ModelShards:
    """Which of a rank's tensors are slices of which whole ones, keyed as
    the checkpoint names them (``training.checkpoint.state_tensors``)."""

    mesh: object
    layout: Layout

    def axis(self, key: str) -> Optional[int]:
        """The split axis of a checkpoint tensor, None if it is whole."""
        kind, _, name = key.partition("/")
        if kind == "codebook_ema":
            return self.layout.params.get("codebook")
        if kind == "batch_stats":
            return self.layout.buffers.get(name)
        if kind == "opt_state":
            name = name.partition("/")[2]
        return self.layout.params.get(name)

    def slice_tensors(self, whole: dict) -> dict:
        """This rank's slices of a whole named tree (a checkpoint's)."""
        mesh = self.mesh
        out = {}
        for k, t in whole.items():
            axis = self.axis(k)
            out[k] = t if axis is None else _slice(t, axis, mesh.model_rank, mesh.n_model)
        return out

    def gather_tensors(self, local: dict) -> dict:
        """The whole named tree from every model-group rank's slices (a
        collective: every rank of the group calls it)."""
        out = {}
        for k, t in local.items():
            axis = self.axis(k)
            out[k] = t if axis is None else self.mesh.model_concat(t.detach(), axis)
        return out


def _shard_module(model: nn.Module, layout: Layout, rank: int, n: int) -> None:
    """Replace the split parameters and buffers by this rank's slices and
    mark the column-split convolutions, in place."""
    with torch.no_grad():
        for name, axis in layout.params.items():
            prefix, _, leaf = name.rpartition(".")
            module = model.get_submodule(prefix) if prefix else model
            setattr(module, leaf, nn.Parameter(_slice(getattr(module, leaf), axis, rank, n)))
        for name, axis in layout.buffers.items():
            prefix, _, leaf = name.rpartition(".")
            module = model.get_submodule(prefix)
            setattr(module, leaf, _slice(getattr(module, leaf), axis, rank, n))
    for prefix in layout.convs:
        conv = model.get_submodule(prefix)
        conv.model_split = True
        conv.out_channels //= n
    for prefix in layout.norms:
        norm = model.get_submodule(prefix)
        if isinstance(norm, GroupNorm):
            norm.num_groups //= n
            norm.num_channels //= n
        else:
            norm.num_features //= n


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """This rank's train state under the mesh's model axis, from a whole
    one (every rank builds the same whole state from one seed): the model's
    split parameters and buffers become its slices, in place; a new flat
    buffer holds the slices first, then the replicated leaves; moments,
    EMA shadow and EMA codebook statistics are sliced to match; the step
    and count carry over. The whole state is not used afterwards."""
    from neural_sound_generation_tpu_torch.training.checkpoint import (
        load_state_tensors,
        state_tensors,
    )

    whole = {k: t.detach().clone() for k, t in state_tensors(state).items()}
    layout = tensor_parallel_layout(state.model, mesh.n_model)
    shards = ModelShards(mesh, layout)
    _shard_module(state.model, layout, mesh.model_rank, mesh.n_model)
    flat = FlatParams(state.model, first=layout.params)
    opt = state.opt_state
    if isinstance(opt, FusedOptState):
        dtype = opt.m.dtype
        opt = dataclasses.replace(
            opt, count=opt.count.clone(),
            m=torch.zeros(flat.numel, dtype=dtype, device=flat.flat.device),
            v=torch.zeros(flat.numel, dtype=dtype, device=flat.flat.device))
    else:
        views = flat.named(flat.flat)
        opt = dataclasses.replace(
            opt, count=opt.count.clone(),
            m={k: torch.zeros_like(t) for k, t in views.items()},
            v={k: torch.zeros_like(t) for k, t in views.items()})
    local = shards.slice_tensors(whole)
    cb_ema = None
    if state.codebook_ema is not None:
        cb_ema = {k: local[f"codebook_ema/{k}"].clone() for k in state.codebook_ema}
    out = dataclasses.replace(
        state, flat=flat, step=state.step.clone(), opt_state=opt,
        ema_params=None if state.ema_params is None else torch.zeros_like(flat.flat),
        codebook_ema=cb_ema, shards=shards)
    load_state_tensors(out, whole)
    return out


def gather_train_state(state: TrainState) -> dict:
    """The whole train state as the checkpoint's named tensors, gathered
    over the model group (a collective); the state's own tensors without a
    model axis."""
    from neural_sound_generation_tpu_torch.training.checkpoint import state_tensors

    tensors = state_tensors(state)
    return tensors if state.shards is None else state.shards.gather_tensors(tensors)

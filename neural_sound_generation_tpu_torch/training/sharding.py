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

The layout covers the autoencoders of ``cli.main`` and the
``TransformerPrior``, dense or routed (Megatron's layout and expert
parallelism). The autoencoders take ``_TP_RULES`` as it falls on their
flax names, with the convolutions' departures above:

  * the flat mel ``VQVAE`` (one codebook or residual VQ): every encoder
    and decoder convolution and the codebook's rows;
  * the ``WaveVQVAE``: every encoder and decoder convolution, 1-D (a
    ``Conv1d.weight`` (Cout, Cin, K) splits on dim 0, a
    ``ConvTranspose1d.weight`` (Cin, Cout, K) on dim 1), with the
    ``bn_i`` after ``conv_i``; ``decoder.out`` where its outputs divide
    (the mulaw-quantize logits, not a scalar's one channel); the (K, D)
    or (Q, K, D) codebook's codes; ``input_embed``, ``speaker_embed`` and
    ``speaker_proj`` stay whole, as no rule names them;
  * the ``HierVQVAE``: only ``decoder`` and both codebooks (``_TP_RULES``
    names ``['decoder']`` and ``codebook_top``/``codebook_bottom``; the
    bottom encoder, the top encoder and decoder and the two merges are
    ``enc_bottom``, ``enc_top``, ``dec_top``, ``bottom_merge`` and
    ``decode_merge``, which it does not name, so they stay whole as in
    JAX);
  * the ``VAE``: nothing (its layers are top-level ``Conv_i`` and
    ``ConvTranspose_i``, which no rule names). Every model rank holds and
    computes the whole model on its data group's rows: the flat buffer is
    all replicated segment (``split_at`` 0), the clip's norm counts it
    once and the gradient is model rank 0's, as for any replicated leaf.

Where the prior's layout departs from ``_TP_RULES``:

  * heads, not contiguous columns. JAX's ``attn_qkv`` kernel is (D, 3 D),
    columns ``[q | k | v]``, each head-major, and ``_TP_RULES`` split it by
    contiguous output columns, which are not a set of heads; GSPMD
    reshards around that, the port cannot. Rank r holds the q, k and v
    columns (and biases) of heads [r H / M, (r + 1) H / M): the leaf is
    split in three blocks, each block alike (``Layout.groups``), so the
    whole tree, and the checkpoint, keep JAX's column order.
  * heads that do not divide. Where H % M != 0 the attention's leaves stay
    whole on every rank (the counterpart of JAX's "shard only where it
    divides"); the MLP, the experts, the embeddings and the head still
    split.
  * biases. A column-split layer's bias (``attn_qkv``, ``mlp_in``, ``head``,
    ``cond_proj``) is split with its kernel, as the convolutions' are
    above; a row-split layer's (``attn_out``, ``mlp_out``) stays whole and
    is added once, after the model group's sum. ``bos`` stays whole and
    each rank adds its slice of it to the embeddings' slices.

The gated families, WaveNet and the GatedPixelCNN, take ``_TP_RULES`` as
it falls on their flax names, with the convolutions' bias departure above
and these:

  * a gate's grouped split. Both gate a 2G-channel pre-activation with
    tanh(a) * sigmoid(b), a and b its two halves; ``_TP_RULES`` splits the
    leaves that make it by contiguous output channels, which gives rank 0
    the tanh half and rank 1 the sigmoid half, and GSPMD reshards around
    that; the port cannot. Rank r holds channels [r G / M, (r + 1) G / M)
    of each half (``Layout.groups`` 2, as the prior's qkv is split in
    three), so it gates its own G / M channels, and the whole tree, and the
    checkpoint, keep JAX's channel order. The leaves: WaveNet's
    ``dilated_i`` (kernel and bias) and ``cond_i``; the PixelCNN's
    ``vert_kernel``, ``vert_bias``, ``horiz_kernel``, ``horiz_bias``,
    ``vert_to_horiz``, ``spatial_cond`` and each layer's
    ``class_cond_embedding`` (its 2C feature axis), every one a
    ``layer_i``'s.
  * gates whose half does not divide. Where G % M != 0 every leaf of the
    gates stays whole on every rank (the counterpart of JAX's "shard only
    where it divides", the prior's heads' rule), and every rank computes
    the gates whole: ``gate_channels`` 4 at M 4 has halves of 2, where JAX
    would still split the 4-wide leaf. The other leaves still split where
    they divide.
  * leaves that no rule names stay whole, as in JAX: WaveNet's ``g_i``,
    ``speaker_embed`` and ``input_embed``. A rank that uses only its
    grouped slice of a whole leaf's output (``g_i``'s) takes it through
    ``copy_to_model`` first, so that the leaf's gradient is the whole one,
    as the prior's ``bos`` does.
  * outputs that do not divide stay whole, as in JAX: ``post2`` of a
    10-mixture MoL head (30 channels) at M 4.

Each rank then runs the one-rank forward on its slices, gathering the
channels where the next layer needs them whole (``models.wavenet``,
``models.pixelcnn``).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
from torch import nn

from neural_sound_generation_tpu_torch.models.hiervqvae import HierVQVAE
from neural_sound_generation_tpu_torch.models.layers import BatchNorm, GroupNorm
from neural_sound_generation_tpu_torch.models.pixelcnn import GatedPixelCNN
from neural_sound_generation_tpu_torch.models.transformer_prior import TransformerPrior
from neural_sound_generation_tpu_torch.models.vae import VAE
from neural_sound_generation_tpu_torch.models.vqvae import VQVAE
from neural_sound_generation_tpu_torch.models.wavenet import WaveNet
from neural_sound_generation_tpu_torch.models.wavevqvae import WaveVQVAE
from neural_sound_generation_tpu_torch.parallel.mesh import model_param_shardings
from neural_sound_generation_tpu_torch.training.train_state import (
    FlatParams,
    FusedOptState,
    LeafOptState,
    TrainState,
)

_TRANSPOSE = (nn.ConvTranspose1d, nn.ConvTranspose2d)
_CONVS = (nn.Conv1d, nn.Conv2d, *_TRANSPOSE)
#: the families whose convolutions and codebooks the layout splits
_AUTOENCODERS = (VQVAE, HierVQVAE, WaveVQVAE, VAE)
#: the leaves that make a gated family's pre-activation, split block-wise
_GATE_LEAVES = {
    WaveNet: re.compile(r"^(dilated|cond)_\d+\.(weight|bias)$"),
    GatedPixelCNN: re.compile(
        r"^layer_\d+\.((vert|horiz)_(kernel|bias)|(vert_to_horiz|spatial_cond)\.(weight|bias)"
        r"|class_cond_embedding\.weight)$"),
}


def _norm_after(model: nn.Module, conv_name: str) -> Optional[str]:
    """The norm that normalizes a convolution's output in the
    autoencoders' modules: ``Conv_i`` or ``ConvTranspose_i`` (the wave
    model's ``conv_i``) -> the norm of index i of the same module
    (``BatchNorm_i``, ``GroupNorm_i``; the wave model's ``bn_i``), where
    it has one."""
    prefix, _, conv = conv_name.rpartition(".")
    parent = model.get_submodule(prefix) if prefix else model
    index = conv.rpartition("_")[2]
    for norm in (f"BatchNorm_{index}", f"GroupNorm_{index}", f"bn_{index}"):
        if hasattr(parent, norm):
            return f"{prefix}.{norm}" if prefix else norm
    return None


@dataclasses.dataclass
class Layout:
    """The port's tensor-parallel table for one model and M: the split
    axis of each sharded parameter and buffer, the column-split
    convolutions and norms; the leaves split block by block (``groups``:
    the transformer prior's qkv projection's three, a gate's two halves);
    for the transformer prior the split linear layers ({prefix: "columns"
    or "rows"}) and the routed blocks whose experts split; whether the
    embeddings split (the prior's, the PixelCNN's code embedding)."""

    params: dict
    buffers: dict
    convs: list
    norms: list
    groups: dict = dataclasses.field(default_factory=dict)
    linears: dict = dataclasses.field(default_factory=dict)
    experts: list = dataclasses.field(default_factory=list)
    embed: bool = False


def _prior_layout(model: TransformerPrior, n_model: int) -> Layout:
    """The transformer prior's table: ``model_param_shardings`` unit by
    unit (a block's attention, its MLP or experts, the embeddings, the
    head), each split whole or kept whole, with the departures of the
    module docstring."""
    table = model_param_shardings(model, n_model)
    layout = Layout({}, {}, [], [])

    def split(prefix: str, kind: str) -> None:
        layout.params[f"{prefix}.weight"] = table[f"{prefix}.weight"]
        layout.linears[prefix] = kind
        if kind == "columns":
            layout.params[f"{prefix}.bias"] = 0

    for i, blk in enumerate(model.blocks):
        p = f"block_{i}"
        if blk.n_heads % n_model == 0:
            split(f"{p}.attn_qkv", "columns")
            layout.groups[f"{p}.attn_qkv.weight"] = layout.groups[f"{p}.attn_qkv.bias"] = 3
            split(f"{p}.attn_out", "rows")
        if blk.routed:
            experts = [f"{p}.moe.{leaf}" for leaf in ("w_in", "b_in", "w_out", "b_out")]
            if all(name in table for name in experts):
                layout.params.update({name: 0 for name in experts})
                layout.experts.append(f"{p}.moe")
        elif f"{p}.mlp_in.weight" in table:
            split(f"{p}.mlp_in", "columns")
            split(f"{p}.mlp_out", "rows")
    embeds = ["tok_embed", "class_embed", "row_embed", "col_embed"]
    embeds += ["cond_proj"] if model.spatial_cond else []
    if all(f"{e}.weight" in table for e in embeds):
        layout.params.update({f"{e}.weight": table[f"{e}.weight"] for e in embeds})
        if model.spatial_cond:
            layout.params["cond_proj.bias"] = 0
        layout.embed = True
    if "head.weight" in table:
        split("head", "columns")
    return layout


def _conv_layout(model: nn.Module, params: dict, n_model: int) -> Layout:
    """The convolutions' table from ``params`` (a ``model_param_shardings``
    subset): each split convolution's bias and the norm after it split
    with its kernel; every other leaf as ``params`` has it."""
    params = dict(params)
    buffers: dict[str, int] = {}
    convs, norms = [], []
    for name, axis in list(params.items()):
        prefix, _, leaf = name.rpartition(".")
        module = model.get_submodule(prefix) if prefix else model
        if not isinstance(module, _CONVS) or leaf != "weight":
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


def _gated_layout(model: nn.Module, n_model: int) -> Layout:
    """WaveNet's or the GatedPixelCNN's table: ``model_param_shardings``
    with its convolutions' biases, and the gates' leaves split block-wise
    in two where a half divides by M, else whole (the module docstring)."""
    gate = _GATE_LEAVES[type(model)]
    half = model.gate_channels // 2 if isinstance(model, WaveNet) else model.dim
    params = {k: a for k, a in model_param_shardings(model, n_model).items()
              if not gate.match(k)}
    leaves = [k for k, _ in model.named_parameters() if gate.match(k)]
    if half % n_model == 0:
        # every gate leaf on its output channels: dim 0 of a kernel or a
        # bias, dim 1 of a class table (n_classes, 2C)
        params.update({k: 1 if "class_cond_embedding" in k else 0 for k in leaves})
    layout = _conv_layout(model, params, n_model)
    if half % n_model == 0:
        layout.groups.update({k: 2 for k in layout.params if gate.match(k)})
    layout.embed = "embedding.weight" in layout.params
    return layout


def tensor_parallel_layout(model: nn.Module, n_model: int) -> Layout:
    """``model_param_shardings`` plus the port's departures: a column-split
    convolution's bias and the norm after it (scale, offset, BatchNorm's
    running statistics) split with its kernel; the transformer prior's
    heads, biases and embeddings, and the gated families' gates, as the
    module docstring says."""
    if isinstance(model, TransformerPrior):
        return _prior_layout(model, n_model)
    if type(model) in _GATE_LEAVES:
        return _gated_layout(model, n_model)
    if not isinstance(model, _AUTOENCODERS):
        raise NotImplementedError(f"{type(model).__name__}: no tensor-parallel layout")
    return _conv_layout(model, model_param_shardings(model, n_model), n_model)


def _slice(t: torch.Tensor, axis: int, rank: int, n: int, groups: int = 1) -> torch.Tensor:
    """Rank ``rank``'s slice of ``t`` along ``axis`` of n; with ``groups``
    the axis is that many equal blocks, each sliced alike."""
    blocks = t.unflatten(axis, (groups, -1))
    size = blocks.shape[axis + 1] // n
    return blocks.narrow(axis + 1, rank * size, size).flatten(axis, axis + 1).contiguous()


@dataclasses.dataclass
class ModelShards:
    """Which of a rank's tensors are slices of which whole ones, keyed as
    the checkpoint names them (``training.checkpoint.state_tensors``)."""

    mesh: object
    layout: Layout

    def sum_sharded(self, t: torch.Tensor) -> torch.Tensor:
        """A partial sum over this rank's slices -> the whole one (the clip
        norm's squares), summed over the model group."""
        return self.mesh.model_all_reduce(t)

    def split(self, key: str) -> tuple[Optional[int], int]:
        """The split axis of a checkpoint tensor (None if it is whole) and
        its number of blocks."""
        kind, _, name = key.partition("/")
        if kind == "codebook_ema":
            return self.layout.params.get("codebook"), 1
        if kind == "batch_stats":
            return self.layout.buffers.get(name), 1
        if kind == "opt_state":
            name = name.partition("/")[2]
        return self.layout.params.get(name), self.layout.groups.get(name, 1)

    def slice_tensors(self, whole: dict) -> dict:
        """This rank's slices of a whole named tree (a checkpoint's)."""
        mesh = self.mesh
        out = {}
        for k, t in whole.items():
            axis, groups = self.split(k)
            out[k] = t if axis is None else _slice(t, axis, mesh.model_rank, mesh.n_model,
                                                   groups)
        return out

    def gather_tensors(self, local: dict) -> dict:
        """The whole named tree from every model-group rank's slices (a
        collective: every rank of the group calls it)."""
        out = {}
        for k, t in local.items():
            axis, groups = self.split(k)
            if axis is None:
                out[k] = t
                continue
            blocks = t.detach().unflatten(axis, (groups, -1))
            out[k] = self.mesh.model_concat(blocks, axis + 1).flatten(axis, axis + 1)
        return out


def _shard_module(model: nn.Module, layout: Layout, rank: int, n: int) -> None:
    """Replace the split parameters and buffers by this rank's slices and
    mark the split convolutions, linear layers, experts and embeddings,
    in place."""
    with torch.no_grad():
        for name, axis in layout.params.items():
            prefix, _, leaf = name.rpartition(".")
            module = model.get_submodule(prefix) if prefix else model
            whole = getattr(module, leaf)
            setattr(module, leaf, nn.Parameter(_slice(whole, axis, rank, n,
                                                      layout.groups.get(name, 1))))
        for name, axis in layout.buffers.items():
            prefix, _, leaf = name.rpartition(".")
            module = model.get_submodule(prefix)
            setattr(module, leaf, _slice(getattr(module, leaf), axis, rank, n))
    for prefix in layout.convs:
        conv = model.get_submodule(prefix)
        conv.model_split = True
        conv.model_groups = layout.groups.get(f"{prefix}.weight", 1)
        conv.out_channels //= n
    for prefix in layout.norms:
        norm = model.get_submodule(prefix)
        if isinstance(norm, GroupNorm):
            norm.num_groups //= n
            norm.num_channels //= n
        else:
            norm.num_features //= n
    for prefix, kind in layout.linears.items():
        linear = model.get_submodule(prefix)
        linear.model_split = kind
        if kind == "columns":
            linear.out_features //= n
        else:
            linear.in_features //= n
    for prefix in layout.experts:
        model.get_submodule(prefix).expert_split = True
    if layout.embed:
        model.embed_split = True


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

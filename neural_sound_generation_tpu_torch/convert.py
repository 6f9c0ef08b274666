"""Weight bridge between the JAX package's flax variables and the port.

``flax_to_state_dict`` turns flax's nested ``{"params": ..., "batch_stats":
...}`` tree (leaves as numpy arrays) into a PyTorch ``state_dict`` for the
port's module of the same structure; ``module_to_flax`` reads such a module
back into that tree. Both take the transpose convolutions from the module's
layer types; ``flax_to_state_dict`` without a module takes them from
flax's auto-names (``ConvTranspose_i``), which ``WaveDecoder``'s ``conv_i``
and ``out`` are not. The
port's modules carry the flax names (``encoder.ResBlock_0.Conv_0``), so the
bridge only changes each leaf's name and layout:

  flax leaf                          port (state_dict key suffix)
  Conv        kernel (kh,kw,in,out)  .weight (out,in,kh,kw)
  Conv (1-D)  kernel (k,in,out)      .weight (out,in,k)
  ConvTranspose kernel (kh,kw,in,out) .weight (in,out,kh,kw), kh and kw
                                     flipped: flax's SAME transpose conv
                                     correlates with the unflipped kernel,
                                     ConvTranspose2d(4, 2, 1) with the flipped
  ConvTranspose (1-D) (k,in,out)     .weight (in,out,k), k flipped
                                     (``layers.ConvTranspose1dSame``)
  Dense       kernel (in,out)        .weight (out,in)
  Embed       embedding (n,d)        .weight (n,d)
  norms       scale, bias            .weight, .bias (BatchNorm, GroupNorm,
                                     LayerNorm)
  BatchNorm   mean, var (stats)      .running_mean, .running_var
  top-level leaves (codebook, bos)   the same name, the same layout: a
                                     (K, D) codebook or a residual-VQ
                                     (Q, K, D) stack
  PixelCNN raw kernels               the same name, (out,in,kh,kw): the
    vert_kernel, horiz_kernel        gated layer's ``self.param``s
    (kh,kw,in,out)
  PixelCNN raw biases                the same name, the same layout
    vert_bias, horiz_bias
  SwitchMoE expert leaves            the same name, the same layout: w_in
    w_in, b_in, w_out, b_out         (E, D, F), b_in (E, F), w_out (E, F, D),
                                     b_out (E, D) (``models/moe.py``)

Both directions copy values exactly, so a round trip is bit-exact.

EMA-codebook statistics (``TrainState.codebook_ema`` on both sides):
``cluster`` (K,) or (Q, K) and ``embed_sum`` (K, D) or (Q, K, D) keep their
layouts; ``codebook_ema_to_port`` and ``codebook_ema_to_flax`` carry them
over and check that the two agree.

Tensor parallelism. ``local_state_dict`` slices a whole ``state_dict`` (a
converted JAX tree) into one model-axis rank's share by the port's table
(``training.sharding.tensor_parallel_layout``), so that every rank of a
test holds the same weights as the one-rank model.

Pipeline parallelism. ``stage_state_dict`` gives one pipe stage its share
of a JAX tree through ``parallel.pipeline``'s split (its layers and the
rest whole), which loads strictly into the model cut to that stage.

Flat vectors. The JAX package keeps the fused optimizer's moments and the
parameter EMA as one vector in ``ravel_pytree`` order (the params tree
flattened with sorted keys); the port keeps them in its flat buffer's
order (``FlatParams``: ``named_parameters()`` order, PyTorch layouts, each
parameter at a 16-byte-aligned offset).
``flax_flat_to_port`` and ``port_flat_to_flax`` map any param-shaped
vector between the two through the named tree, never index to index.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch

from neural_sound_generation_tpu_torch.training.train_state import flat_offsets

#: HWIO kernels that are parameters of a module rather than a conv's
#: ``kernel`` (the PixelCNN's gated layer); the port keeps them OIHW
RAW_KERNELS = ("vert_kernel", "horiz_kernel")
RAW_BIASES = ("vert_bias", "horiz_bias")
#: a switch-MoE's expert weights and biases, kept in flax's layouts
EXPERT_LEAVES = ("w_in", "b_in", "w_out", "b_out")


def _walk(tree: Mapping[str, Any], prefix=()) -> Iterator[tuple[tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _transpose_rule(model: torch.nn.Module | None):
    """Whether the flax module at a path is a transpose convolution. With the
    target ``model``, its layer type at that path decides; without one,
    flax's auto-name (``ConvTranspose_i``) does, which holds for every tree
    that does not name its transpose convs itself (``WaveDecoder``'s
    ``conv_i`` and ``out`` do)."""
    if model is None:
        return lambda module: bool(module) and module[-1].startswith("ConvTranspose")

    def from_model(module: tuple[str, ...]) -> bool:
        try:
            layer = model.get_submodule(".".join(module))
        except AttributeError as e:
            raise ValueError(f"no port module at {'/'.join(module)}") from e
        return isinstance(layer, (torch.nn.ConvTranspose1d, torch.nn.ConvTranspose2d))

    return from_model


def _param_to_torch(path: tuple[str, ...], leaf: np.ndarray, is_transpose) -> tuple[str, np.ndarray]:
    module, name = path[:-1], path[-1]
    prefix = ".".join(module) + "." if module else ""
    if name == "kernel":
        if leaf.ndim == 4 and is_transpose(module):
            return prefix + "weight", leaf[::-1, ::-1].transpose(2, 3, 0, 1)
        if leaf.ndim == 4:
            return prefix + "weight", leaf.transpose(3, 2, 0, 1)
        if leaf.ndim == 3 and is_transpose(module):
            return prefix + "weight", leaf[::-1].transpose(1, 2, 0)
        if leaf.ndim == 3:
            return prefix + "weight", leaf.transpose(2, 1, 0)
        if leaf.ndim == 2:
            return prefix + "weight", leaf.T
    elif name in RAW_KERNELS:
        return prefix + name, leaf.transpose(3, 2, 0, 1)
    elif name in ("scale", "embedding"):
        return prefix + "weight", leaf
    elif name == "bias" or name in RAW_BIASES or name in EXPERT_LEAVES or not module:
        return prefix + name, leaf
    raise ValueError(f"no port counterpart for flax leaf {'/'.join(path)}")


def flax_to_state_dict(
    variables: Mapping[str, Any], model: torch.nn.Module | None = None
) -> dict[str, torch.Tensor]:
    """flax variables (numpy leaves) -> the port's ``state_dict``. With the
    target ``model``, its layer types decide which kernels are transpose
    convolutions (as in ``module_to_flax``); without one, flax's
    auto-names do (see ``_transpose_rule``)."""
    is_transpose = _transpose_rule(model)
    sd: dict[str, torch.Tensor] = {}
    for path, leaf in _walk(variables["params"]):
        key, value = _param_to_torch(path, np.asarray(leaf), is_transpose)
        sd[key] = torch.from_numpy(np.array(value, order="C"))
    for path, leaf in _walk(variables.get("batch_stats", {})):
        module = ".".join(path[:-1])
        stat = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        sd[f"{module}.{stat}"] = torch.from_numpy(np.array(leaf))
        sd[f"{module}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def _set(tree: dict, path: list[str], value: np.ndarray) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def module_to_flax(
    model: torch.nn.Module, tensors: Mapping[str, torch.Tensor] | None = None
) -> dict[str, Any]:
    """The port's module -> flax variables (numpy leaves). ``tensors``
    (parameter name -> tensor of the parameter's shape) stands in for the
    module's own parameter values, e.g. an Adam moment split by name."""
    params: dict = {}
    stats: dict = {}
    names = {id(p): n for n, p in model.named_parameters()}

    def put(tree, prefix, name, tensor, layout=lambda a: a):
        if tensors is not None and id(tensor) in names:
            tensor = tensors[names[id(tensor)]]
        value = np.ascontiguousarray(layout(tensor.detach().float().cpu().numpy()))
        _set(tree, (prefix.split(".") if prefix else []) + [name], value)

    for prefix, m in model.named_modules():
        if isinstance(m, torch.nn.ConvTranspose2d):
            put(params, prefix, "kernel", m.weight, lambda w: w.transpose(2, 3, 0, 1)[::-1, ::-1])
        elif isinstance(m, torch.nn.Conv2d):
            put(params, prefix, "kernel", m.weight, lambda w: w.transpose(2, 3, 1, 0))
        elif isinstance(m, torch.nn.ConvTranspose1d):
            put(params, prefix, "kernel", m.weight, lambda w: w.transpose(2, 0, 1)[::-1])
        elif isinstance(m, torch.nn.Conv1d):
            put(params, prefix, "kernel", m.weight, lambda w: w.transpose(2, 1, 0))
        elif isinstance(m, torch.nn.Linear):
            put(params, prefix, "kernel", m.weight, lambda w: w.T)
        elif isinstance(m, torch.nn.Embedding):
            put(params, prefix, "embedding", m.weight)
            continue
        elif isinstance(m, (torch.nn.BatchNorm2d, torch.nn.GroupNorm, torch.nn.LayerNorm)):
            put(params, prefix, "scale", m.weight)
            if isinstance(m, torch.nn.BatchNorm2d):
                put(stats, prefix, "mean", m.running_mean)
                put(stats, prefix, "var", m.running_var)
        else:
            for name, p in m.named_parameters(recurse=False):
                if name in RAW_KERNELS:
                    put(params, prefix, name, p, lambda w: w.transpose(2, 3, 1, 0))
                else:
                    put(params, prefix, name, p)
            continue
        if m.bias is not None:
            put(params, prefix, "bias", m.bias)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def _check_codebook_ema(cluster_shape, embed_sum_shape) -> None:
    if len(embed_sum_shape) not in (2, 3) or tuple(cluster_shape) != tuple(embed_sum_shape[:-1]):
        raise ValueError(
            f"EMA-codebook statistics cluster {tuple(cluster_shape)} and embed_sum "
            f"{tuple(embed_sum_shape)}: expected (K,) and (K, D), or (Q, K) and (Q, K, D)"
        )


def codebook_ema_to_port(stats: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The JAX train state's ``codebook_ema`` (numpy leaves) -> the port's
    ``TrainState.codebook_ema`` (float32 tensors of the same layouts)."""
    cluster, esum = np.asarray(stats["cluster"]), np.asarray(stats["embed_sum"])
    _check_codebook_ema(cluster.shape, esum.shape)
    return {"cluster": torch.from_numpy(np.array(cluster, np.float32)),
            "embed_sum": torch.from_numpy(np.array(esum, np.float32))}


def codebook_ema_to_flax(stats: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's ``TrainState.codebook_ema`` -> numpy leaves in the JAX
    train state's layout."""
    out = {k: stats[k].detach().float().cpu().numpy() for k in ("cluster", "embed_sum")}
    _check_codebook_ema(out["cluster"].shape, out["embed_sum"].shape)
    return out


def ravel_flax(tree: Mapping[str, Any]) -> np.ndarray:
    """A tree of arrays as one float32 vector in ``jax.flatten_util.
    ravel_pytree`` order (dict keys sorted at every level)."""
    leaves = []

    def walk(node):
        if isinstance(node, Mapping):
            for key in sorted(node):
                walk(node[key])
        else:
            leaves.append(np.asarray(node, np.float32).reshape(-1))

    walk(tree)
    return np.concatenate(leaves) if leaves else np.zeros(0, np.float32)


def unravel_flax(flat: np.ndarray, template: Mapping[str, Any]) -> dict[str, Any]:
    """Inverse of ``ravel_flax``: a vector back into ``template``'s shapes."""
    flat = np.asarray(flat, np.float32)
    offset = 0

    def walk(node):
        nonlocal offset
        if isinstance(node, Mapping):
            return {key: walk(node[key]) for key in sorted(node)}
        shape = np.shape(node)
        size = int(np.prod(shape))
        out = flat[offset : offset + size].reshape(shape)
        offset += size
        return out

    out = walk(template)
    if offset != flat.size:
        raise ValueError(f"vector of {flat.size} for a tree of {offset} values")
    return out


def flax_flat_to_port(
    flat: np.ndarray, params_template: Mapping[str, Any], names: list[str],
    model: torch.nn.Module | None = None,
) -> torch.Tensor:
    """A JAX ``ravel_pytree``-order vector over ``params_template`` (the
    flax params tree) -> the port's flat layout for parameters ``names``
    (``FlatParams.names``: their order, each at its aligned offset, zeros
    between), float32. ``model`` lays out the kernels as in
    ``flax_to_state_dict``."""
    sd = flax_to_state_dict({"params": unravel_flax(flat, params_template)}, model)
    offsets, n = flat_offsets([tuple(sd[name].shape) for name in names])
    out = torch.zeros(n, dtype=torch.float32)
    for name, offset in zip(names, offsets):
        out[offset : offset + sd[name].numel()] = sd[name].reshape(-1)
    return out


def port_flat_to_flax(vector: torch.Tensor, model: torch.nn.Module, flat_params) -> np.ndarray:
    """The port's flat vector (``flat_params`` layout) -> the JAX
    ``ravel_pytree``-order vector of the same values, float32."""
    params = module_to_flax(model, flat_params.named(vector.detach()))["params"]
    return ravel_flax(params)


def local_state_dict(
    state_dict: Mapping[str, torch.Tensor], model: torch.nn.Module, n_model: int,
    model_rank: int,
) -> dict[str, torch.Tensor]:
    """Rank ``model_rank``'s share of a whole ``state_dict`` for ``model``
    under a model axis of ``n_model``: each split parameter and BatchNorm
    statistic sliced along its axis by the port's tensor-parallel table
    (the transformer prior's qkv projection head by head: its q, k and v
    blocks each sliced alike; a gated family's gate leaves by the channels
    of each half), every other entry whole."""
    from neural_sound_generation_tpu_torch.training.sharding import (
        _slice,
        tensor_parallel_layout,
    )

    layout = tensor_parallel_layout(model, n_model)
    axes = {**layout.params, **layout.buffers}
    out = {}
    for key, t in state_dict.items():
        axis = axes.get(key)
        out[key] = t if axis is None else _slice(t, axis, model_rank, n_model,
                                                 layout.groups.get(key, 1))
    return out


def stage_state_dict(
    variables: Mapping[str, Any], model: torch.nn.Module, stage: int, n_stages: int,
) -> dict[str, torch.Tensor]:
    """Pipeline stage ``stage`` of ``n_stages``'s share of a JAX tree for the
    whole ``model`` (a ``TransformerPrior`` or a ``WaveNet``): the entries
    the stage holds under ``parallel.pipeline``'s split (its layers [s L /
    S, (s + 1) L / S), the rest whole), which load strictly into the model
    cut to that stage (``pp_prior_partition``, ``pp_wavenet_partition``)."""
    from neural_sound_generation_tpu_torch.parallel.pipeline import Stage, holds

    at = Stage(stage, n_stages)
    return {k: t for k, t in flax_to_state_dict(variables, model).items()
            if holds(model, at, k)}

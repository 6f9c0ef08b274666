"""Sequence-axis parallelism: a sharded 1-D convolution with halo exchange.

Counterpart of ``neural_sound_generation_tpu/parallel/sequence.py``. The
JAX package shards the time axis of a (B, T, Cin) array over a mesh axis
inside ``shard_map`` and hands each shard its neighbours' boundary samples
with ``ppermute``. Here each rank of the axis holds one shard and the
halos go through the mesh's neighbour hand-off (``Mesh.send_along``,
``Mesh.recv_along``: two-rank groups, the sender broadcasting bytes, so
that ranks sharing one card over gloo exchange CUDA tensors too):

  * causal: a shard takes the last (K - 1) dilation samples of its left
    neighbour; shard 0 takes zeros (the sequence start's padding);
  * "same": a shard takes its left neighbour's last ``halo // 2`` samples
    and its right neighbour's first ``halo - halo // 2``; the end shards
    take zeros.

The exchange is an autograd function whose backward hands each halo's
gradient back to the rank that sent the halo, so that a shard's input
gradient is the slice of the whole-array convolution's. The convolution
itself is ``torch.nn.functional.conv1d`` (cuDNN on the card), as it is
XLA's in JAX: no hand-written kernel lies on this path.

``halo_conv1d`` is the per-shard primitive (every rank of the axis calls
it at once, with equal shard shapes); ``sharded_conv1d`` takes the whole
array on every rank, keeps the rank's slice of T and returns the whole
(B, T, Cout) on every rank: the port's counterpart of JAX's global array,
gathered by a zero-padded all-reduce over the axis (gloo has no
all-gather of CUDA tensors). Its backward sums the kernel's gradient over
the axis, as JAX's replicated in-spec ``P()`` does, and gives every rank
the whole input gradient. With no process group both are the plain causal
or "same" convolution.

Layouts are JAX's: ``x`` (B, T, Cin), ``kernel`` (K, Cin, Cout).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from neural_sound_generation_tpu_torch.parallel import distributed
from neural_sound_generation_tpu_torch.parallel.mesh import (
    Mesh,
    _all_reduce,
    current_mesh,
    make_mesh,
)


def _conv(padded: torch.Tensor, kernel: torch.Tensor, dilation: int) -> torch.Tensor:
    """(B, T + halo, Cin) * (K, Cin, Cout) -> (B, T, Cout), no padding."""
    out = F.conv1d(padded.transpose(1, 2), kernel.permute(2, 1, 0), dilation=dilation)
    return out.transpose(1, 2)


def _pads(k: int, dilation: int, causal: bool) -> tuple[int, int]:
    """(left, right): the samples a shard takes from each neighbour."""
    halo = (k - 1) * dilation
    return (halo, 0) if causal else (halo // 2, halo - halo // 2)


def conv1d(x: torch.Tensor, kernel: torch.Tensor, causal: bool = True,
           dilation: int = 1) -> torch.Tensor:
    """The whole-array causal or "same" convolution (the one-rank program)."""
    left, right = _pads(kernel.shape[0], dilation, causal)
    return _conv(F.pad(x, (0, 0, left, right)), kernel, dilation)


def _swap(mesh: Mesh, axis: str, up: Optional[torch.Tensor], down: Optional[torch.Tensor],
          up_shape: tuple, down_shape: tuple, like: torch.Tensor):
    """Each rank i along ``axis`` hands ``up`` to i + 1 and ``down`` to
    i - 1; returns (what i - 1 handed up, what i + 1 handed down), None
    past either end or for an empty shape. Every pair (p, p + 1) moves its
    upward tensor, then its downward one; the even pairs go first, then the
    odd, so no rank waits on a chain."""
    i, n = mesh.axis_index(axis), mesh.axis_size(axis)
    from_below = from_above = None
    moves_up, moves_down = up_shape[1] > 0, down_shape[1] > 0
    for p in sorted((p for p in (i - 1, i) if 0 <= p < n - 1), key=lambda p: (p % 2, p)):
        if p == i:  # this rank is the pair's lower end
            if moves_up:
                mesh.send_along(up.contiguous(), axis, 1)
            if moves_down:
                from_above = mesh.recv_along(like.new_empty(down_shape), axis, 1)
        else:  # its upper end
            if moves_up:
                from_below = mesh.recv_along(like.new_empty(up_shape), axis, -1)
            if moves_down:
                mesh.send_along(down.contiguous(), axis, -1)
    return from_below, from_above


class _Halo(torch.autograd.Function):
    """x_local (B, T, C) -> (B, left + T + right, C): the left neighbour's
    last ``left`` samples, the shard, the right neighbour's first
    ``right`` (zeros past the ends). The backward hands each halo's
    gradient to the rank that sent it and adds what comes back to the
    shard's own."""

    @staticmethod
    def forward(ctx, x, mesh, axis, left, right):
        ctx.mesh, ctx.axis, ctx.left, ctx.right = mesh, axis, left, right
        b, t, c = x.shape
        below, above = _swap(mesh, axis, x[:, t - left:], x[:, :right],
                             (b, left, c), (b, right, c), x)
        below = x.new_zeros((b, left, c)) if below is None else below
        above = x.new_zeros((b, right, c)) if above is None else above
        return torch.cat([below, x, above], dim=1)

    @staticmethod
    def backward(ctx, g):
        left, right = ctx.left, ctx.right
        b, tp, c = g.shape
        t = tp - left - right
        # the left halo's gradient goes down to its sender, the right's up
        from_below, from_above = _swap(ctx.mesh, ctx.axis, g[:, left + t:], g[:, :left],
                                       (b, right, c), (b, left, c), g)
        gx = g[:, left:left + t].clone()
        if from_above is not None:  # the right neighbour's left halo: my tail
            gx[:, t - left:] += from_above
        if from_below is not None:  # the left neighbour's right halo: my head
            gx[:, :right] += from_below
        return gx, None, None, None, None


class _SumGradAlong(torch.autograd.Function):
    """The identity forward; the gradient summed over the axis's group
    backward (a replicated input that each rank uses on its shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


class _SliceAlong(torch.autograd.Function):
    """The whole (B, T, C) -> this rank's slice of T forward; backward, the
    slices' gradients put together on every rank (a zero-padded
    all-reduce over the axis)."""

    @staticmethod
    def forward(ctx, x, group, index, n):
        t = x.shape[1] // n
        ctx.group, ctx.index, ctx.t, ctx.shape = group, index, t, x.shape
        return x[:, index * t:(index + 1) * t]

    @staticmethod
    def backward(ctx, g):
        whole = g.new_zeros(ctx.shape)
        whole[:, ctx.index * ctx.t:(ctx.index + 1) * ctx.t] = g
        return _all_reduce(whole, ctx.group), None, None, None


class _GatherAlong(torch.autograd.Function):
    """This rank's slice of T -> the whole (B, T, C) on every rank (a
    zero-padded all-reduce over the axis) forward; this rank's slice of
    the gradient backward (the whole gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, y, group, index, n):
        b, t, c = y.shape
        ctx.index, ctx.t = index, t
        whole = y.new_zeros((b, n * t, c))
        whole[:, index * t:(index + 1) * t] = y
        return _all_reduce(whole, group)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.index * ctx.t:(ctx.index + 1) * ctx.t], None, None, None


def _mesh_of(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``mesh``, else the current step's, else one over the whole process
    group; None without a group."""
    if mesh is not None:
        return mesh
    mesh = current_mesh()
    if mesh is None and distributed.world_size() > 1:
        mesh = make_mesh()
    return mesh


def halo_conv1d(
    x_local: torch.Tensor,
    kernel: torch.Tensor,
    axis_name: str = "data",
    causal: bool = True,
    dilation: int = 1,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Per-shard 1-D convolution with neighbour halo exchange.

    Every rank along ``axis_name`` of ``mesh`` (the current mesh, or one
    over the whole process group, by default) calls it at once with its
    shard of the time axis: ``x_local`` (B, T_local, Cin), ``kernel`` (K,
    Cin, Cout). Output: (B, T_local, Cout), the slice at this shard's
    position of the whole sequence's convolution. causal=True pads on the
    left only (WaveNet's convention); causal=False ("same") takes halos
    from both sides. ``x_local``'s gradient is the whole convolution's at
    this shard; ``kernel``'s covers this shard's outputs only (sum it over
    the axis, as ``sharded_conv1d`` does, for the whole one)."""
    k = kernel.shape[0]
    halo = (k - 1) * dilation
    mesh = _mesh_of(mesh)
    if mesh is None or mesh.axis_size(axis_name) == 1:
        return conv1d(x_local, kernel, causal, dilation)
    if halo > x_local.shape[1]:
        raise ValueError(
            f"a halo of (K - 1) x dilation = ({k} - 1) x {dilation} = {halo} samples exceeds "
            f"a shard's {x_local.shape[1]}: the halo would span more than one neighbour")
    left, right = _pads(k, dilation, causal)
    padded = _Halo.apply(x_local, mesh, axis_name, left, right)
    return _conv(padded, kernel, dilation)


def sharded_conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    mesh: Optional[Mesh] = None,
    causal: bool = True,
    dilation: int = 1,
    axis: str = "data",
) -> torch.Tensor:
    """Whole-array entry: every rank along ``axis`` holds the same (B, T,
    Cin) ``x`` and ``kernel``, convolves its slice of T with halo
    exchange, and gets the whole (B, T, Cout) back. T must divide evenly
    by the axis size. Differentiable: ``x``'s gradient is the whole one on
    every rank and ``kernel``'s is summed over the axis."""
    mesh = _mesh_of(mesh)
    if mesh is None or mesh.axis_size(axis) == 1:
        return conv1d(x, kernel, causal, dilation)
    n, index = mesh.axis_size(axis), mesh.axis_index(axis)
    if x.shape[1] % n:
        raise ValueError(f"time axis {x.shape[1]} must divide over {n} shards of {axis!r}")
    group = mesh.axis_group(axis)
    x_local = _SliceAlong.apply(x, group, index, n)
    y = halo_conv1d(x_local, _SumGradAlong.apply(kernel, group), axis, causal, dilation, mesh)
    return _GatherAlong.apply(y, group, index, n)

"""Switch-routed mixture-of-experts feed-forward of the transformer prior.

Counterpart of ``neural_sound_generation_tpu/models/moe.py``: top-1
routing in float32 (router, softmax, argmax with the first index on ties,
the gate the top probability), per-expert capacity ``ceil(cf * T / E)`` per
batch row, tokens past capacity dropped (zero output, the residual carries
them), and the Switch load-balance term E * sum_e(frac_e * mean_prob_e).

The JAX package dispatches with one-hot einsums over a (B, T, E, C) slot
tensor, the static-shape form XLA wants. Here the dispatch is indexed: each
kept token is copied into its (expert, row, queue position) slot of an
(E, B * C, D) block, the experts run as two batched products over the
(E, D, F) and (E, F, D) weights, and each slot's output is copied back to
its token, times the token's gate (a dropped token keeps a zero row). A
slot holds at most one token, so the sums of the einsums have one nonzero
term and both forms give the same values; the empty slots of the JAX form
are multiplied by a zero combine and reach neither the output nor a
gradient.

Compute dtype (``dtype``, bfloat16 under ``cli.prior --bf16``): the
experts run in it on their float32 weights cast per call, each product
rounded once and its bias added in the compute dtype (flax's
``promote_dtype``); the router, the dispatch, the combine and the
load-balance term stay float32. The router reads the activation as the
block hands it (rounded to the compute dtype); the gate multiplies the
expert's output in float32, and the product is rounded once to the input's
dtype.

The load-balance term is returned by ``forward``, not kept in module
state, or, for the pipeline's microbatches, each row's two statistics
(``forward(..., per_row=True)``, JAX's ``sow("moe_stats", "rows", ...)``),
from which ``load_balance`` takes the term over the whole batch. Inside a data-parallel step (``parallel.mesh.current_mesh()``) its
two means are the global batch's, taken over the ranks before their
product (the product is not linear in the rows); capacity is per row, so
routing and drops need no collective. Under the model axis (expert
parallelism, ``expert_split``) a rank holds E / M experts, rank r those
from r E / M. Every rank of a model group routes the same tokens with the
replicated router, so queues, drops and the load-balance term are alike on
every rank; a rank fills only its experts' slots, from the input taken
through ``Mesh.copy_to_model``, and the model group's sum of the ungated
outputs (``Mesh.reduce_from_model``; each kept token has one owner) is
multiplied by the gate on every rank. The gate multiplies after the sum:
before it, a rank's router gradient would miss the other ranks' experts.
``step`` is the causal one-position form for the KV-cached sampler:
it carries each row's per-expert counts of *dispatched* tokens, so with the
full sequence's capacity it drops exactly what ``forward`` drops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import gelu, split_mesh
from neural_sound_generation_tpu_torch.parallel.mesh import current_mesh

__all__ = ["SwitchMoE", "load_balance"]


class SwitchMoE(nn.Module):
    """Top-1 routed expert MLP: (B, T, D) -> ((B, T, D), load-balance term).

    Parameters carry the flax names: ``router`` (a Linear D -> E),
    ``w_in`` (E, D, F), ``b_in`` (E, F), ``w_out`` (E, F, D), ``b_out``
    (E, D), F = mlp_ratio * D, in flax's layouts. Each batch row is a
    routing group (capacity is per row)."""

    #: set by ``training.sharding``: this rank holds a slice of the experts
    expert_split = False

    def __init__(self, dim: int, n_experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_experts < 1:
            raise ValueError(f"a switch MoE needs at least one expert, not {n_experts}")
        e, d, f = n_experts, dim, mlp_ratio * dim
        self.dim, self.n_experts, self.capacity_factor = dim, n_experts, capacity_factor
        self.compute_dtype = dtype
        self.router = nn.Linear(d, e)
        self.w_in = nn.Parameter(torch.empty(e, d, f))
        self.b_in = nn.Parameter(torch.zeros(e, f))
        self.w_out = nn.Parameter(torch.empty(e, f, d))
        self.b_out = nn.Parameter(torch.zeros(e, d))

    def capacity(self, t: int) -> int:
        """Per-expert queue capacity of a length-``t`` sequence: what
        ``step`` must be given so sampling reproduces the forward's drops."""
        return max(1, int(math.ceil(self.capacity_factor * t / self.n_experts)))

    def _route(self, h: torch.Tensor):
        """(..., D) -> (probs (..., E), expert (...,), gate (...,)), in
        float32 whatever the compute dtype."""
        probs = torch.softmax(self.router(h.float()), dim=-1)
        expert = torch.argmax(probs, dim=-1)
        gate = probs.gather(-1, expert[..., None])[..., 0]
        return probs, expert, gate

    def _experts(self, xs: torch.Tensor) -> torch.Tensor:
        """Every expert's MLP on its own rows, in the compute dtype:
        (E, N, D) -> (E, N, D)."""
        dt = self.compute_dtype
        hh = gelu(torch.bmm(xs.to(dt), self.w_in.to(dt)) + self.b_in.to(dt)[:, None, :])
        return torch.bmm(hh, self.w_out.to(dt)) + self.b_out.to(dt)[:, None, :]

    def dispatch(self, h: torch.Tensor):
        """The routing of a (B, T, D) sequence: (probs (B, T, E), expert
        (B, T), gate (B, T), pos (B, T), keep (B, T)). ``pos`` is each
        token's 0-based place in its expert's queue within its row (a
        cumulative sum over T), ``keep`` whether it is within capacity."""
        probs, expert, gate = self._route(h)
        onehot = F.one_hot(expert, self.n_experts)
        pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
        return probs, expert, gate, pos, pos < self.capacity(h.shape[1])

    def forward(self, h: torch.Tensor, per_row: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        """(y, the load-balance term); with ``per_row`` (y, each row's
        statistics (B, 2, E): the fraction of its tokens dispatched to each
        expert and its mean router probability, both over T), which
        ``load_balance`` turns into the term over any set of rows (the
        pipeline's microbatches, JAX's ``moe_stats`` ``rows``)."""
        b, t, d = h.shape
        e, cap = self.n_experts, self.capacity(t)
        probs, expert, gate, pos, keep = self.dispatch(h)
        # Switch aux: E * sum_e(fraction dispatched_e * mean prob_e); the
        # dispatched one-hot carries no gradient, the mean probabilities do
        dispatched = (F.one_hot(expert, e) * keep[..., None]).float()
        if per_row:
            aux = torch.stack([dispatched.mean(dim=1), probs.mean(dim=1)], dim=1)
        else:
            frac = dispatched.mean(dim=(0, 1))
            mean_prob = probs.mean(dim=(0, 1))
            mesh = current_mesh()
            if mesh is not None:
                frac = mesh.mean_(frac)
                mean_prob = mesh.sum(mean_prob) / mesh.n_data
            aux = e * torch.sum(frac * mean_prob)

        mesh, lo, x = None, 0, h
        if self.expert_split:
            # this rank's experts [lo, lo + e); the others' tokens are dropped here
            mesh, e = split_mesh(), self.w_in.shape[0]
            lo = mesh.model_rank * e
            keep = keep & (expert >= lo) & (expert < lo + e)
            x = mesh.copy_to_model(h)
        n_slots = e * b * cap
        rows = torch.arange(b, device=h.device)[:, None]
        tokens = torch.arange(b * t, device=h.device)
        # each kept token's slot in the (E, B, C) block; the dropped ones go
        # to one spare row past the block, which is cut off again
        slot = torch.where(keep, ((expert - lo) * b + rows) * cap + pos, n_slots).reshape(-1)
        xs = h.new_zeros(n_slots + 1, d).index_copy(0, slot, x.reshape(b * t, d))
        ys = self._experts(xs[:-1].view(e, b * cap, d)).reshape(n_slots, d)
        # and back: each slot's token, a spare token for the empty slots.
        # Copies both ways: their gradients gather, where a gather's would
        # accumulate every dropped token into one row, one after another
        owner = torch.full((n_slots + 1,), b * t, device=h.device).index_copy(0, slot, tokens)
        y = ys.new_zeros(b * t + 1, d).index_copy(0, owner[:-1], ys)[:-1]
        if mesh is not None:
            # every kept token's output from its owner, ungated, on every rank
            y = mesh.reduce_from_model(y)
        return (y.view(b, t, d).float() * gate[..., None]).to(h.dtype), aux

    def step(self, h: torch.Tensor, counts: torch.Tensor, cap: int) -> torch.Tensor:
        """One causal position for the KV-cached sampler.

        ``h`` (B, D) is the post-ln2 activation at position t; ``counts``
        (B, E) int32 the tokens already *dispatched* to each expert at
        positions < t, updated in place; ``cap`` the capacity of the full
        sequence (``capacity(T)``). Returns y (B, D)."""
        b = h.shape[0]
        _, expert, gate = self._route(h)                              # (B,), (B,)
        room = counts.gather(1, expert[:, None])[:, 0] < cap
        ys = self._experts(h[None].expand(self.n_experts, b, h.shape[1]))
        y = ys[expert, torch.arange(b, device=h.device)]
        counts.scatter_add_(1, expert[:, None], room[:, None].to(counts.dtype))
        return (y.float() * (gate * room)[:, None]).to(h.dtype)


def load_balance(rows: torch.Tensor) -> torch.Tensor:
    """The Switch term E * sum_e(frac_e * mean_prob_e) of per-row statistics
    (N, 2, E) (``SwitchMoE.forward(..., per_row=True)``, concatenated over the
    rows of the batch): both factors are means over every row, and inside a
    data-parallel step over every data rank's rows, as ``forward``'s are.
    The product is not linear in the rows, so the mean of the microbatches'
    terms is not the batch's."""
    frac, mean_prob = rows[:, 0].detach().mean(dim=0), rows[:, 1].mean(dim=0)
    mesh = current_mesh()
    if mesh is not None:
        frac = mesh.mean_(frac)
        mean_prob = mesh.sum(mean_prob) / mesh.n_data
    return rows.shape[-1] * torch.sum(frac * mean_prob)

"""Vector quantization with straight-through gradients, and the codebook's
training helpers.

Counterpart of ``neural_sound_generation_tpu/ops/vq.py``:

  * ``vq(inputs, codebook)``: nearest-codebook indices, no gradient.
  * ``vq_st(inputs, codebook)``: codes and indices with a straight-through
    estimator. The encoder's gradient is the upstream gradient unchanged; the
    codebook's is the upstream gradient summed into the selected rows
    (``index_add_`` semantics, accumulated in float32).
  * ``codebook_lookup``: an embedding lookup whose gradient has the same
    index-add semantics (``index_select``'s own backward).

Training helpers for a single (K, D) codebook, each a plain function on
tensors; the ones that draw take an explicit ``torch.Generator``:

  * ``codebook_ema_update``: VQ-VAE-2 style EMA codebook learning;
  * ``restart_dead_codes`` (``restart_rows`` given the drawn candidates):
    re-seed codes whose usage fell below a threshold;
  * ``data_codebook_init`` (``codebook_from_rows`` given the draws): seed a
    codebook from encoder outputs.

Residual VQ (SoundStream-style, a (Q, K, D) stack of codebooks):

  * ``residual_vq``: each stage quantizes what the earlier stages left;
  * ``residual_codebook_ema_update``: per-stage EMA statistics, each taken
    against the residual its stage saw;
  * ``data_codebook_init`` with a (Q, K, D) shape seeds stage q > 0 from the
    residual of the stages before it.

The nearest-code search goes to the CUDA kernel for tensors on a CUDA
device and to its plain version on the CPU; ``set_vq_backend`` can pin
either one.

Inside a data-parallel step (``parallel.mesh.current_mesh()``) the EMA
update sums its per-code counts and input sums over the data group before
the decay, and a dead-code restart draws its candidates from every data
rank's rows in rank order (the global batch's order) with a generator
every rank holds in the same state, so every rank makes the one-rank run's
update.

Under the mesh's model axis (``parallel.mesh.model_axis()``, tensor
parallelism) every codebook these functions are given is this rank's
shard of rows: rank m of the model group holds codes [m K / M, (m + 1) K /
M) of a (K, D) codebook, or of each stage of a (Q, K, D) stack. Then:

  * the search launches the kernel once over the shard, for all rows, with
    the winning scores; the (score, global index) pairs of the model group
    merge lexicographically (the lower score wins, on equal scores the
    lower global index: the one-device first-index rule), a NaN score
    losing to any other; the indices returned are global;
  * the lookup takes each row from its owner, the others contributing
    zeros, and all-reduces over the model group (adding zeros is exact);
    the codebook's gradient lands on the owner's rows only, since the
    upstream gradient of the whole codes is the same on every model rank;
  * the EMA statistics are the rows' own, summed over the data group; the
    total count that smooths them is summed over the model group;
  * a restart draws all K candidates from the generator, as one rank
    does, and keeps its shard's.
"""

from __future__ import annotations

import torch

from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel
from neural_sound_generation_tpu_torch.parallel.mesh import current_mesh, model_axis

#: the largest global code index the merge carries exactly (as a float32)
_MAX_MERGED_CODES = 2**24

_BACKENDS = ("auto", "torch", "kernel")
_VQ_BACKEND = "auto"


def set_vq_backend(backend: str) -> None:
    """Select the nearest-codebook implementation.

    ``auto`` runs the CUDA kernel on a CUDA device and its plain version on
    the CPU; ``kernel`` runs the CUDA kernel and refuses tensors that are not
    on a CUDA device; ``torch`` runs the plain version everywhere."""
    global _VQ_BACKEND
    if backend not in _BACKENDS:
        raise ValueError(f"unknown VQ backend {backend!r}: expected one of {_BACKENDS}")
    _VQ_BACKEND = backend


def _search(inputs_flat: torch.Tensor, codebook: torch.Tensor, return_scores: bool = False):
    """One search by the selected backend (see ``set_vq_backend``)."""
    if _VQ_BACKEND == "torch":
        return vq_kernel.nearest_codebook_indices_plain(inputs_flat, codebook, return_scores)
    if _VQ_BACKEND == "kernel" and inputs_flat.device.type != "cuda":
        raise ValueError(
            f"VQ backend 'kernel' needs CUDA tensors, got {inputs_flat.device}"
        )
    if return_scores:
        return vq_kernel.nearest_codebook_indices(inputs_flat, codebook, return_scores=True)
    return vq_kernel.nearest_codebook_indices(inputs_flat, codebook)


def merge_shards(scores: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """The whole codebook's answer from its M row shards' (M, N) winning
    scores and global indices, shards in code order: the lowest score, on
    equal scores the lowest shard (its indices are the lower), a NaN
    score losing to any other; (N,) int32."""
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, float("inf")), scores)
    win = torch.argmin(scores, dim=0)  # the first of equal minima: the lowest shard
    return indices.gather(0, win[None])[0].to(torch.int32)


def _sharded_nearest(inputs_flat: torch.Tensor, shard: torch.Tensor, mesh) -> torch.Tensor:
    """The global nearest-code indices over a codebook whose rows are
    sharded over the model group: one search over this rank's shard, one
    all-reduce of the zero-padded (score, index) pairs, the merge."""
    k_local, n = shard.shape[0], inputs_flat.shape[0]
    if k_local * mesh.n_model > _MAX_MERGED_CODES:
        raise ValueError(f"a sharded search merges at most {_MAX_MERGED_CODES} codes")
    idx, score = _search(inputs_flat, shard, return_scores=True)
    pairs = torch.zeros(2, mesh.n_model, n, dtype=torch.float32, device=inputs_flat.device)
    pairs[0, mesh.model_rank] = score
    pairs[1, mesh.model_rank] = (idx + mesh.model_rank * k_local).to(torch.float32)
    mesh.model_all_reduce_(pairs)
    return merge_shards(pairs[0], pairs[1].to(torch.int64))


def _nearest_indices(inputs_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Argmin_k ||x - e_k||^2 for (N, D) inputs and a (K, D) codebook: (N,)
    int32 (global indices over a sharded codebook under the model axis)."""
    inputs_flat = inputs_flat.detach().contiguous()
    codebook = codebook.detach().contiguous()
    mesh = model_axis()
    if mesh is not None:
        return _sharded_nearest(inputs_flat, codebook, mesh)
    return _search(inputs_flat, codebook)


def _owned(indices: torch.Tensor, k_local: int, mesh):
    """Global indices -> (this rank's local row, clamped into the shard;
    whether this rank owns it)."""
    local = indices.long() - mesh.model_rank * k_local
    own = (local >= 0) & (local < k_local)
    return local.clamp(0, k_local - 1), own


def _sharded_rows(shard: torch.Tensor, indices: torch.Tensor, mesh) -> torch.Tensor:
    """Rows ``indices`` (global) of a codebook sharded over the model
    group, outside autograd: each owner's rows, zeros elsewhere, summed."""
    local, own = _owned(indices, shard.shape[0], mesh)
    rows = torch.where(own[:, None], shard.index_select(0, local),
                       torch.zeros((), dtype=shard.dtype, device=shard.device))
    return mesh.model_all_reduce(rows)


def _shard_grad(grad_rows: torch.Tensor, indices: torch.Tensor, k_local: int, mesh):
    """The gradient of a sharded lookup for this rank's rows: the upstream
    gradient of the rows it owns summed into them (float32)."""
    grad_rows = grad_rows.to(torch.float32)
    local, own = _owned(indices, k_local, mesh)
    picked = torch.where(own[:, None], grad_rows, torch.zeros((), device=grad_rows.device))
    return torch.zeros(k_local, grad_rows.shape[1], dtype=torch.float32,
                       device=grad_rows.device).index_add_(0, local, picked)


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, indices, mesh):
        ctx.save_for_backward(indices)
        ctx.mesh, ctx.k_local = mesh, shard.shape[0]
        return _sharded_rows(shard, indices, mesh)

    @staticmethod
    def backward(ctx, grad):
        (indices,) = ctx.saved_tensors
        return _shard_grad(grad, indices, ctx.k_local, ctx.mesh), None, None


def _rows(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows ``indices`` (global) of a codebook or of this rank's shard,
    outside autograd."""
    mesh = model_axis()
    if mesh is not None:
        return _sharded_rows(codebook, indices, mesh)
    return codebook.index_select(0, indices.long())


def vq(inputs: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook indices (int32), shaped ``inputs.shape[:-1]``."""
    embedding_size = codebook.shape[1]
    indices = _nearest_indices(inputs.reshape(-1, embedding_size), codebook)
    return indices.reshape(inputs.shape[:-1])


class _VQStraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inputs, codebook):
        embedding_size = codebook.shape[1]
        indices_flat = _nearest_indices(inputs.reshape(-1, embedding_size), codebook)
        codes = _rows(codebook, indices_flat).reshape(inputs.shape)
        ctx.save_for_backward(indices_flat)
        ctx.num_codes = codebook.shape[0]
        ctx.mesh = model_axis()
        ctx.mark_non_differentiable(indices_flat)
        return codes, indices_flat

    @staticmethod
    def backward(ctx, grad_codes, _grad_indices):
        (indices_flat,) = ctx.saved_tensors
        grad_inputs = grad_codes if ctx.needs_input_grad[0] else None
        grad_codebook = None
        if ctx.needs_input_grad[1]:
            embedding_size = grad_codes.shape[-1]
            grad_flat = grad_codes.reshape(-1, embedding_size).to(torch.float32)
            if ctx.mesh is not None:
                return grad_inputs, _shard_grad(grad_flat, indices_flat, ctx.num_codes,
                                                ctx.mesh)
            grad_codebook = torch.zeros(
                ctx.num_codes, embedding_size,
                dtype=torch.float32, device=grad_codes.device,
            ).index_add_(0, indices_flat, grad_flat)
        return grad_inputs, grad_codebook


def vq_st(inputs: torch.Tensor, codebook: torch.Tensor):
    """Straight-through vector quantization: ``(codes, indices_flat)``.

    ``codes`` has the shape of ``inputs``; ``indices_flat`` holds the
    flattened int32 code ids."""
    return _VQStraightThrough.apply(inputs, codebook)


def codebook_lookup(codebook: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Differentiable lookup ``codebook[indices]``: (..., D).

    ``index_select``, whose backward is one ``index_add_`` of the rows:
    the backward of advanced indexing sorts the indices and serializes the
    duplicates, 5.8 ms of a 16.3 ms training step at 8960 rows into 512
    codes on an H100. Under the model axis ``codebook`` is this rank's
    shard and ``indices`` are global (``_ShardedLookup``)."""
    mesh = model_axis()
    if mesh is not None:
        flat = _ShardedLookup.apply(codebook, indices.reshape(-1).long(), mesh)
    else:
        flat = codebook.index_select(0, indices.reshape(-1).long())
    return flat.reshape(*indices.shape, codebook.shape[-1])


def residual_vq(inputs: torch.Tensor, codebooks: torch.Tensor):
    """Residual vector quantization over ``codebooks`` (Q, K, D): stage q
    quantizes the residual the stages before it left, and the quantized
    vector is the sum of the stage codes. Returns ``(quantized_st,
    quantized_sum, indices)``:

      * ``quantized_st`` = inputs + (sum - inputs).detach(): the encoder gets
        the upstream gradient once, through one straight-through around the
        whole sum (feed the decoder);
      * ``quantized_sum``: each stage's codebook gets gradients through its
        own ``codebook_lookup`` only (use it in the VQ loss);
      * ``indices`` (Q, N) int32, N the number of input vectors.

    The residual is detached between stages, as the JAX package's
    ``stop_gradient`` does."""
    num_q, _, embedding_size = codebooks.shape
    flat = inputs.reshape(-1, embedding_size)
    residual = flat.detach()
    total = torch.zeros_like(flat)
    indices = []
    for q in range(num_q):
        idx = _nearest_indices(residual, codebooks[q])
        codes = codebook_lookup(codebooks[q], idx)
        total = total + codes
        residual = residual - codes.detach()
        indices.append(idx)
    quantized_sum = total.reshape(inputs.shape)
    quantized_st = inputs + (quantized_sum - inputs).detach()
    return quantized_st, quantized_sum, torch.stack(indices)


def codebook_ema_update(
    codebook: torch.Tensor,
    cluster_size_ema: torch.Tensor,
    embed_sum_ema: torch.Tensor,
    inputs_flat: torch.Tensor,
    indices_flat: torch.Tensor,
    decay: float,
    eps: float = 1e-5,
):
    """EMA codebook update (ModelConfig.ema_codebook): per-code counts and
    sums of the assigned inputs, averaged into the EMA statistics; each
    code becomes its smoothed mean. Returns (new_codebook,
    new_cluster_size_ema, new_embed_sum_ema). Under the model axis the
    codebook and its statistics are this rank's rows and ``indices_flat``
    global."""
    num_codes = codebook.shape[0]
    ones = torch.ones(inputs_flat.shape[0], 1, dtype=inputs_flat.dtype, device=inputs_flat.device)
    rows = torch.cat([ones, inputs_flat], dim=1).to(torch.float32)
    tp = model_axis()
    if tp is not None:
        both = _shard_grad(rows, indices_flat, num_codes, tp)
    else:
        both = torch.zeros(
            num_codes, 1 + inputs_flat.shape[1], dtype=torch.float32, device=inputs_flat.device
        ).index_add_(0, indices_flat.long(), rows)
    mesh = current_mesh()
    if mesh is not None:
        mesh.all_reduce_(both)
    counts, sums = both[:, 0], both[:, 1:]
    new_cluster = decay * cluster_size_ema + (1 - decay) * counts
    new_embed_sum = decay * embed_sum_ema + (1 - decay) * sums
    n = torch.sum(new_cluster)
    if tp is not None:
        n = tp.model_all_reduce(n)
        num_codes *= tp.n_model
    cluster = (new_cluster + eps) / (n + num_codes * eps) * n
    return new_embed_sum / cluster[:, None], new_cluster, new_embed_sum


def residual_codebook_ema_update(
    codebooks: torch.Tensor,
    cluster_size_ema: torch.Tensor,
    embed_sum_ema: torch.Tensor,
    inputs_flat: torch.Tensor,
    indices: torch.Tensor,
    decay: float,
    eps: float = 1e-5,
    return_residuals: bool = False,
):
    """Per-stage EMA update for residual VQ: ``codebooks`` (Q, K, D),
    ``cluster_size_ema`` (Q, K), ``embed_sum_ema`` (Q, K, D), ``indices``
    (Q, N) from ``residual_vq``. Stage q's statistics are taken against the
    residual its quantizer saw, rebuilt here from the indices with the
    codebooks as they were before this update. Returns the stacked
    (new_codebooks, new_cluster, new_embed_sum), and with
    ``return_residuals`` the (Q, N, D) stage inputs as well: the candidate
    pool for per-stage dead-code restarts (a stage-1+ residual is at
    another scale than the raw encoder output)."""
    residual = inputs_flat
    new_cbs, new_clusters, new_sums, residuals = [], [], [], []
    for q in range(codebooks.shape[0]):
        residuals.append(residual)
        cb, cl, es = codebook_ema_update(
            codebooks[q], cluster_size_ema[q], embed_sum_ema[q], residual, indices[q],
            decay, eps,
        )
        new_cbs.append(cb)
        new_clusters.append(cl)
        new_sums.append(es)
        residual = residual - _rows(codebooks[q], indices[q])
    out = (torch.stack(new_cbs), torch.stack(new_clusters), torch.stack(new_sums))
    if return_residuals:
        return out + (torch.stack(residuals),)
    return out


def restart_rows(
    codebook: torch.Tensor,
    usage: torch.Tensor,
    candidates: torch.Tensor,
    threshold: float = 1.0,
    cluster: torch.Tensor | None = None,
    embed_sum: torch.Tensor | None = None,
):
    """Replace the codes whose ``usage`` is below ``threshold`` by the
    matching rows of ``candidates`` (K, D). With the EMA statistics given,
    a restarted row restarts them as one observation of its new vector
    (cluster 1, embed_sum the candidate) and the 3-tuple is returned;
    otherwise the codebook alone."""
    candidates = candidates.detach()
    dead_row = usage < threshold
    dead = dead_row[:, None]
    new_cb = torch.where(dead, candidates.to(codebook.dtype), codebook)
    if cluster is None:
        return new_cb
    new_cluster = torch.where(dead_row, torch.ones_like(cluster), cluster)
    new_esum = torch.where(dead, candidates.to(embed_sum.dtype), embed_sum)
    return new_cb, new_cluster, new_esum


def restart_dead_codes(
    codebook: torch.Tensor,
    usage: torch.Tensor,
    batch_flat: torch.Tensor,
    generator: torch.Generator,
    threshold: float = 1.0,
    cluster: torch.Tensor | None = None,
    embed_sum: torch.Tensor | None = None,
):
    """Reinitialize unused codes from random rows of the batch's encoder
    outputs (the codebook-collapse mitigation): one row per code drawn
    uniformly with replacement from ``generator``, then ``restart_rows``."""
    mesh = current_mesh()
    if mesh is not None:
        batch_flat = mesh.gather_rows(batch_flat.detach())
    tp = model_axis()
    k_local = codebook.shape[0]
    idx = torch.randint(
        0, batch_flat.shape[0], (k_local * (tp.n_model if tp else 1),),
        generator=generator, device=batch_flat.device,
    )
    if tp is not None:  # the one-rank draws, this shard's
        idx = idx[tp.model_rank * k_local:(tp.model_rank + 1) * k_local]
    return restart_rows(codebook, usage, batch_flat[idx], threshold, cluster, embed_sum)


def codebook_from_rows(
    flat: torch.Tensor, idx: torch.Tensor, noise: torch.Tensor, noise_scale: float = 0.01
) -> torch.Tensor:
    """Rows ``idx`` of ``flat`` (N, D) plus ``noise_scale * std(flat) *
    noise``, so duplicate draws split."""
    std = torch.std(flat, correction=0) + 1e-6
    return flat[idx] + noise_scale * std * noise


def data_codebook_init(
    z_e: torch.Tensor,
    codebook_shape,
    generator: torch.Generator,
    noise_scale: float = 0.01,
    draws=None,
) -> torch.Tensor:
    """Seed a (K, D) or (Q, K, D) codebook from encoder outputs ``z_e``
    (..., D) instead of the reference's U(+-1/K) ball at the origin (the
    Jukebox-style random-sample init): K rows drawn without replacement
    (with replacement when there are fewer than K), plus jitter.

    For residual VQ, stage q > 0 is drawn from the residual left after
    greedy assignment to the stages already seeded (a nearest-code search
    per earlier stage), which is what it will quantize. ``draws(q, n, k)``
    may supply stage q's ``(idx, noise)`` in place of the generator's (the
    tests hand in the JAX package's draws)."""
    if len(codebook_shape) == 2:
        qs, (k, d) = 1, codebook_shape
    else:
        qs, k, d = codebook_shape
    flat = z_e.reshape(-1, z_e.shape[-1]).to(torch.float32)
    if flat.shape[1] != d:
        raise ValueError(f"codebook width {d}, encoder outputs {flat.shape[1]}")

    def draw(q: int, n: int):
        if draws is not None:
            return draws(q, n, k)
        if n < k:
            idx = torch.randint(0, n, (k,), generator=generator, device=flat.device)
        else:
            idx = torch.randperm(n, generator=generator, device=flat.device)[:k]
        return idx, torch.randn(k, d, generator=generator, device=flat.device)

    if qs == 1 and len(codebook_shape) == 2:
        return codebook_from_rows(flat, *draw(0, flat.shape[0]), noise_scale)
    books, residual = [], flat
    for q in range(qs):
        book = codebook_from_rows(residual, *draw(q, residual.shape[0]), noise_scale)
        books.append(book)
        if q + 1 < qs:
            residual = residual - book.index_select(0, _nearest_indices(residual, book).long())
    return torch.stack(books)

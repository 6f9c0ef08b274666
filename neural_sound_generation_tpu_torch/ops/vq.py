"""Vector quantization with straight-through gradients (serving subset).

Counterpart of ``neural_sound_generation_tpu/ops/vq.py``:

  * ``vq(inputs, codebook)``: nearest-codebook indices, no gradient.
  * ``vq_st(inputs, codebook)``: codes and indices with a straight-through
    estimator. The encoder's gradient is the upstream gradient unchanged; the
    codebook's is the upstream gradient summed into the selected rows
    (``index_add_`` semantics, accumulated in float32).
  * ``codebook_lookup``: an embedding lookup whose gradient has the same
    index-add semantics (PyTorch's own backward for indexing).

The nearest-code search goes to the CUDA kernel for tensors on a CUDA
device and to its plain version on the CPU; ``set_vq_backend`` can pin
either one. Residual
VQ and the EMA, restart and data-init helpers come with the training slice.
"""

from __future__ import annotations

import torch

from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel

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


def _nearest_indices(inputs_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Argmin_k ||x - e_k||^2 for (N, D) inputs and a (K, D) codebook: (N,) int32."""
    inputs_flat = inputs_flat.detach().contiguous()
    codebook = codebook.detach().contiguous()
    if _VQ_BACKEND == "torch":
        return vq_kernel.nearest_codebook_indices_plain(inputs_flat, codebook)
    if _VQ_BACKEND == "kernel" and inputs_flat.device.type != "cuda":
        raise ValueError(
            f"VQ backend 'kernel' needs CUDA tensors, got {inputs_flat.device}"
        )
    return vq_kernel.nearest_codebook_indices(inputs_flat, codebook)


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
        codes = codebook.index_select(0, indices_flat).reshape(inputs.shape)
        ctx.save_for_backward(indices_flat)
        ctx.num_codes = codebook.shape[0]
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
    """Differentiable lookup ``codebook[indices]``: (..., D)."""
    return codebook[indices.long()]

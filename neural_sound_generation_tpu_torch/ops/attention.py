"""Causal multi-head self-attention over (B, H, T, D).

Counterpart of ``neural_sound_generation_tpu/ops/pallas/attention.py::
causal_attention``: the hand-written kernels of ``ops/cuda/flash_attention.py``
for CUDA tensors, at every shape they accept (D <= 128); on the CPU the same
wrapper runs its plain pair, and the launch counters stay at 0. A shape the
kernels refuse raises: the plain path is never a fallback.

The JAX package picks stock XLA at 128-wide heads and at long T on the TPU
(``attention.py:456-464``); that policy is a TPU measurement and does not
carry over. ``chunked_causal_attention`` comes with a later slice.
"""

from __future__ import annotations

import math

import torch

from neural_sound_generation_tpu_torch.ops.cuda.flash_attention import flash_causal_attention


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Multi-head causal attention, (B, H, T, D) -> (B, H, T, D); the
    default scale is 1/sqrt(D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, t, d = q.shape
    o = flash_causal_attention(
        *(x.reshape(b * h, t, d).contiguous() for x in (q, k, v)), float(scale))
    return o.reshape(b, h, t, d)

"""Causal multi-head self-attention over (B, H, T, D), with a backend switch.

Counterpart of ``neural_sound_generation_tpu/ops/pallas/attention.py::
causal_attention``, ``set_backend``, ``_xla_causal_attention`` and
``chunked_causal_attention``. The backend is a module setting:

* ``"auto"`` (the default) and ``"flash"``: the hand-written kernels of
  ``ops/cuda/flash_attention.py`` for CUDA tensors, float32 or bfloat16, at
  every shape they accept (D <= 128); on the CPU the same wrapper runs its
  plain pair, and the launch counters stay at 0. A shape the kernels refuse
  raises: the plain path is never a fallback.
* ``"xla"``: ``stock_causal_attention``, the explicit masked softmax in
  plain PyTorch (the JAX package's stock XLA path), on any device.
* ``"chunked"``: ``chunked_causal_attention``, linear-memory attention in
  plain PyTorch on any device: an online softmax over KV blocks inside a
  loop over q-blocks, each q-block recomputed in the backward, so no (T, T)
  tensor is ever stored. It exists for memory headroom at long T, not for
  speed.

Only a caller sets the last two (``set_backend``); no CLI does, as in the
JAX package. Both are plain PyTorch because JAX computes them in XLA, not
in a Pallas kernel. The JAX package's automatic choice of stock XLA at
128-wide heads and at long T on the TPU (``attention.py:456-464``) is a TPU
measurement and does not carry over: ``"auto"`` never picks the stock or
the chunked path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from neural_sound_generation_tpu_torch.ops.cuda.flash_attention import (
    NEG,
    flash_causal_attention,
)

__all__ = ["BACKENDS", "causal_attention", "chunked_causal_attention", "set_backend",
           "stock_causal_attention"]

BACKENDS = ("auto", "xla", "flash", "chunked")
_backend = "auto"


def set_backend(backend: str) -> None:
    """Select the attention implementation (auto | xla | flash | chunked)."""
    global _backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}: expected one of {BACKENDS}")
    _backend = backend


def stock_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """The explicit masked softmax (the JAX ``_xla_causal_attention``):
    float32 logits, the probabilities rounded to the input dtype before P V.
    (B, H, T, D) -> (B, H, T, D)."""
    t = q.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1).to(q.dtype), v)


def _q_block(qi: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor, i: int, block: int,
             t: int, scale: float) -> torch.Tensor:
    """One q-block's online softmax over every KV block: float32 running
    max, sum and accumulator, masked logits at a finite NEG, P rounded to
    v's dtype for P V. The body is uniform over all blocks; the upper
    triangle is masked, not skipped (the JAX function's measured choice)."""
    b, h, _, d = qi.shape
    dev = qi.device
    qpos = i * block + torch.arange(block, device=dev)
    m = torch.full((b, h, block, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros(b, h, block, 1, dtype=torch.float32, device=dev)
    acc = torch.zeros(b, h, block, d, dtype=torch.float32, device=dev)
    q32 = qi.float()
    for j in range(kb.shape[2] // block):
        kj = kb[:, :, j * block:(j + 1) * block]
        vj = vb[:, :, j * block:(j + 1) * block]
        s = torch.matmul(q32, kj.float().transpose(-1, -2)) * scale
        kpos = j * block + torch.arange(block, device=dev)
        mask = (qpos[:, None] >= kpos[None, :]) & (kpos < t)[None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(vj.dtype).float(), vj.float())
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(qi.dtype)


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float, block: int = 320) -> torch.Tensor:
    """Linear-memory causal attention: T padded to whole blocks of
    ``block``, a loop over q-blocks each running ``_q_block`` under
    ``torch.utils.checkpoint`` (recomputed in the backward, so no (T, T)
    tensor is stored), the padding trimmed. (B, H, T, D) -> (B, H, T, D)."""
    t = q.shape[2]
    nb = -(-t // block)
    qb, kb, vb = (F.pad(x, (0, 0, 0, nb * block - t)) for x in (q, k, v))
    outs = [checkpoint(_q_block, qb[:, :, i * block:(i + 1) * block], kb, vb, i, block, t,
                       scale, use_reentrant=False)
            for i in range(nb)]
    return torch.cat(outs, dim=2)[:, :, :t]


def causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float | None = None
) -> torch.Tensor:
    """Multi-head causal attention, (B, H, T, D) -> (B, H, T, D), through the
    selected backend; the default scale is 1/sqrt(D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _backend == "chunked":
        return chunked_causal_attention(q, k, v, scale)
    if _backend == "xla":
        return stock_causal_attention(q, k, v, scale)
    b, h, t, d = q.shape
    o = flash_causal_attention(
        *(x.reshape(b * h, t, d).contiguous() for x in (q, k, v)), float(scale))
    return o.reshape(b, h, t, d)

"""Loss functions of the mel VQ-VAE and of the prior.

Counterpart of ``neural_sound_generation_tpu/training/losses.py``
(``vqvae_loss``, ``codebook_perplexity``) and of the prior NLL in
``training/trainer.py::_pixelcnn_loss_fn``. The 3-term objective keeps the
reference's mean reductions (src/train.py:129-134) and its stop-gradients,
as ``.detach()`` where the JAX package has ``jax.lax.stop_gradient``.
"""

from __future__ import annotations

import torch


def vqvae_loss(
    x_tilde: torch.Tensor, x: torch.Tensor, z_e: torch.Tensor, z_q: torch.Tensor,
    beta: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """3-term VQ-VAE loss: (total, metrics). ``train_loss`` is recon + vq,
    the reference's logged quantity (train.py:138)."""
    loss_recons = torch.mean((x_tilde - x) ** 2)
    loss_vq = torch.mean((z_q - z_e.detach()) ** 2)
    loss_commit = torch.mean((z_e - z_q.detach()) ** 2)
    total = loss_recons + loss_vq + beta * loss_commit
    metrics = {
        "loss": total,
        "loss_recons": loss_recons,
        "loss_vq": loss_vq,
        "loss_commit": loss_commit,
        "train_loss": loss_recons + loss_vq,
    }
    return total, metrics


def codebook_perplexity(indices: torch.Tensor, num_codes: int) -> torch.Tensor:
    """exp(entropy) of the code usage distribution."""
    counts = torch.bincount(indices.reshape(-1).long(), minlength=num_codes).to(torch.float32)
    probs = counts / torch.clamp(counts.sum(), min=1.0)
    entropy = -torch.sum(torch.where(probs > 0, probs * torch.log(probs), 0.0))
    return torch.exp(entropy)


def prior_nll(logits: torch.Tensor, codes: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean negative log-likelihood of the code grid under the prior's
    logits (B, H, W, K): (nll, {"loss", "nll_per_code"})."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, codes.long()[..., None]).mean()
    return nll, {"loss": nll, "nll_per_code": nll}

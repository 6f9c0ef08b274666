"""Loss functions of the autoencoders and of the prior.

Counterpart of ``neural_sound_generation_tpu/training/losses.py``
(``elbo_bce``, ``elbo_mse``, ``vqvae_loss``, ``hier_vqvae_loss``,
``codebook_perplexity``, ``sequence_mask``, ``masked_cross_entropy``) and of
the prior NLL in ``training/trainer.py::_pixelcnn_loss_fn``. The VQ
objectives keep the reference's mean reductions (src/train.py:129-134) and
its stop-gradients, as ``.detach()`` where the JAX package has
``jax.lax.stop_gradient``; the ELBOs keep its sums (src/loss.py:11-29).
The mixture-of-logistics loss comes with vocoder training.
"""

from __future__ import annotations

import torch


def elbo_bce(recon_x: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor) -> torch.Tensor:
    """Summed Bernoulli NLL + KL(q || N(0, 1)); ``recon_x`` in (0, 1), ``x``
    of any shape with as many elements."""
    x = x.reshape(recon_x.shape)
    eps = 1e-7
    bce = -torch.sum(x * torch.log(recon_x + eps) + (1 - x) * torch.log(1 - recon_x + eps))
    kld = -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar))
    return bce + kld


def elbo_mse(x_tilde: torch.Tensor, x: torch.Tensor, kl_d: torch.Tensor) -> torch.Tensor:
    """Summed squared error / batch size + KL (src/loss.py:23-29)."""
    return torch.sum((x_tilde - x) ** 2) / x.shape[0] + kl_d


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


def hier_vqvae_loss(
    x_tilde: torch.Tensor, x: torch.Tensor, levels, beta: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Two-level VQ-VAE loss: recon + per-level (vq + beta * commit).
    ``levels`` holds the (z_e, z_q) pairs (top, bottom); the metrics carry
    each level's ``loss_vq_*`` and ``loss_commit_*`` beside the sums."""
    loss_recons = torch.mean((x_tilde - x) ** 2)
    loss_vq = loss_commit = 0.0
    metrics: dict[str, torch.Tensor] = {}
    for name, (z_e, z_q) in zip(("top", "bottom"), levels):
        lv = torch.mean((z_q - z_e.detach()) ** 2)
        lc = torch.mean((z_e - z_q.detach()) ** 2)
        loss_vq = loss_vq + lv
        loss_commit = loss_commit + lc
        metrics[f"loss_vq_{name}"] = lv
        metrics[f"loss_commit_{name}"] = lc
    total = loss_recons + loss_vq + beta * loss_commit
    metrics.update(loss=total, loss_recons=loss_recons, loss_vq=loss_vq,
                   loss_commit=loss_commit, train_loss=loss_recons + loss_vq)
    return total, metrics


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) float32 mask (util.py:231-243)."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(torch.float32)


def masked_cross_entropy(
    logits: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """Mean cross entropy over the valid positions; logits (B, T, K),
    targets (B, T) of any integer type."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if lengths is None:
        return torch.mean(nll)
    mask = sequence_mask(lengths, targets.shape[1])
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def codebook_perplexity(indices: torch.Tensor, num_codes: int) -> torch.Tensor:
    """exp(entropy) of the code usage distribution."""
    counts = torch.bincount(indices.reshape(-1).long(), minlength=num_codes).to(torch.float32)
    probs = counts / torch.clamp(counts.sum(), min=1.0)
    entropy = -torch.sum(torch.where(probs > 0, probs * torch.log(probs), 0.0))
    return torch.exp(entropy)


def prior_nll(logits: torch.Tensor, codes: torch.Tensor) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean negative log-likelihood of the code grid under the prior's
    logits (B, H, W, K), either family's: (nll, {"loss", "nll_per_code"})."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, codes.long()[..., None]).mean()
    return nll, {"loss": nll, "nll_per_code": nll}

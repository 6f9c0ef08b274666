"""Loss functions of the autoencoders and of the prior.

Counterpart of ``neural_sound_generation_tpu/training/losses.py``
(``elbo_bce``, ``elbo_mse``, ``vqvae_loss``, ``hier_vqvae_loss``,
``codebook_perplexity``, ``sequence_mask``, ``masked_cross_entropy``,
``discretized_mix_logistic_loss``) and of the prior NLL in
``training/trainer.py::_pixelcnn_loss_fn``. The VQ objectives keep the
reference's mean reductions (src/train.py:129-134) and its stop-gradients,
as ``.detach()`` where the JAX package has ``jax.lax.stop_gradient``; the
ELBOs keep its sums (src/loss.py:11-29).

Inside a data-parallel step (``parallel.mesh.current_mesh()``) the
quantities that are not plain means over equal row counts are taken over
the global batch, reduced over the data group: a masked mean divides this
rank's masked sum by the global mask count / D (so the data ranks' average
is the global masked mean, and so is the averaged gradient), and the
perplexity counts the codes of every data rank. Under the model axis the
VQ terms and the histogram come from the merged global indices and whole
tensors, computed alike on every rank of a model group.
"""

from __future__ import annotations

import torch

from neural_sound_generation_tpu_torch.parallel.mesh import current_mesh


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


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / max(sum(mask), 1) over the global batch: on a
    data mesh each rank's share, whose average over the data group is it."""
    count = torch.sum(mask)
    mesh = current_mesh()
    if mesh is None:
        return torch.sum(values * mask) / torch.clamp(count, min=1.0)
    count = mesh.all_reduce_(count.detach().clone())
    return torch.sum(values * mask) / (torch.clamp(count, min=1.0) / mesh.n_data)


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
    return _masked_mean(nll, sequence_mask(lengths, targets.shape[1]))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it, logaddexp(x, 0):
    no threshold switch, so the MoL loss picks its branches on the values
    the JAX package sees."""
    return torch.logaddexp(x, torch.zeros_like(x))


def discretized_mix_logistic_loss(
    y_hat: torch.Tensor, y: torch.Tensor, num_classes: int = 65536,
    log_scale_min: float = -32.23619130191664, lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean discretized mixture-of-logistics NLL over the valid positions.

    y_hat (B, T, 3M) holds [logit_probs | means | log_scales]; y (B, T) or
    (B, T, 1) in [-1, 1]. Log-scales are floored at ``log_scale_min``; a
    target below -0.999 takes the lower tail's log-CDF, one above 0.999 the
    upper tail's; elsewhere the log of the bin's mass, or the pdf at the
    bin's midpoint where that mass is at most 1e-5."""
    if y.ndim == 3:
        y = y[..., 0]
    logit_probs, means, log_scales = y_hat.chunk(3, dim=-1)
    log_scales = torch.clamp(log_scales, min=log_scale_min)
    yy = y[..., None]
    centered = yy - means
    inv_std = torch.exp(-log_scales)
    half_bin = 1.0 / (num_classes - 1)
    plus_in = inv_std * (centered + half_bin)
    min_in = inv_std * (centered - half_bin)
    cdf_delta = torch.sigmoid(plus_in) - torch.sigmoid(min_in)
    log_cdf_plus = plus_in - _softplus(plus_in)
    log_one_minus_cdf_min = -_softplus(min_in)
    mid_in = inv_std * centered
    log_pdf_mid = mid_in - log_scales - 2.0 * _softplus(mid_in)
    inner = torch.where(
        cdf_delta > 1e-5,
        torch.log(torch.clamp(cdf_delta, min=1e-12)),
        log_pdf_mid - torch.log(torch.tensor((num_classes - 1) / 2.0, dtype=y_hat.dtype)),
    )
    log_probs = torch.where(
        yy < -0.999, log_cdf_plus, torch.where(yy > 0.999, log_one_minus_cdf_min, inner))
    log_probs = log_probs + torch.log_softmax(logit_probs, dim=-1)
    nll = -torch.logsumexp(log_probs, dim=-1)
    if lengths is None:
        return torch.mean(nll)
    return _masked_mean(nll, sequence_mask(lengths, y.shape[1]))


def codebook_perplexity(indices: torch.Tensor, num_codes: int) -> torch.Tensor:
    """exp(entropy) of the code usage distribution (every data rank's codes
    on a mesh)."""
    counts = torch.bincount(indices.reshape(-1).long(), minlength=num_codes).to(torch.float32)
    mesh = current_mesh()
    if mesh is not None:
        mesh.all_reduce_(counts)
    probs = counts / torch.clamp(counts.sum(), min=1.0)
    entropy = -torch.sum(torch.where(probs > 0, probs * torch.log(probs), 0.0))
    return torch.exp(entropy)


#: weight of a routed prior's load-balance term (the Switch paper's default,
#: the JAX ``_pixelcnn_loss_fn``'s ``aux_weight``)
MOE_AUX_WEIGHT = 0.01


def prior_nll(logits: torch.Tensor, codes: torch.Tensor,
              moe_aux: list[torch.Tensor] | None = None,
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean negative log-likelihood of the code grid under the prior's
    logits (B, H, W, K), either family's: (loss, {"loss", "nll_per_code"}).
    For a routed transformer, ``moe_aux`` holds its blocks' load-balance
    terms: the loss adds MOE_AUX_WEIGHT times their mean, reported as
    ``moe_load_balance``, while ``loss`` and ``nll_per_code`` stay the NLL."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, codes.long()[..., None]).mean()
    metrics = {"loss": nll, "nll_per_code": nll}
    if not moe_aux:
        return nll, metrics
    aux = sum(moe_aux) / len(moe_aux)
    metrics["moe_load_balance"] = aux
    return nll + MOE_AUX_WEIGHT * aux, metrics

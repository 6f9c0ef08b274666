"""Training steps and the epoch loop of the autoencoders and the prior.

Counterpart of ``neural_sound_generation_tpu/training/trainer.py`` for the
``VQVAE``, ``HierVQVAE``, ``WaveVQVAE``, ``VAE``, ``TransformerPrior``,
``GatedPixelCNN`` and the ``WaveNet`` vocoder on one device. The JAX package
returns a new state from a jitted pure step; here the step updates the
state in place (the model's parameters are views of the flat buffer the
fused kernel writes) and returns the same object, so the call sites read
alike. Metrics stay device tensors until the caller asks for them.

A VQ-VAE or WaveVQVAE train step runs the nearest-code kernel once per VQ
stage (the forward), as often again under ``ema_codebook``, and the
fused-Adam kernel once; each eval batch runs the nearest-code kernel twice
per stage (the forward and ``encode``). A HierVQVAE step runs the search
twice (top, then bottom) and an eval batch four times; its two codebooks
always learn by gradient. A VAE step draws its noise from the step's
generator and runs the fused-Adam kernel alone. Under a bf16 compute dtype
(``--bf16``) the model's
convolutions run in bf16 while the VQ, the loss, the gradients in the flat
float32 buffer and the fused update stay float32. A prior train step
(batches ``{"codes", "labels"}``, and ``"cond"`` for a spatially
conditioned prior) runs the fused-Adam kernel once and, for the
transformer, the flash-attention forward and both backward kernels once per
layer; the PixelCNN's masked convolutions are cuDNN's. It has no BatchNorm
and no codebook branch. A routed transformer (``n_experts > 0``) adds 0.01
times its blocks' mean load-balance term to the NLL and reports it as
``moe_load_balance``; its eval step reports the NLL alone, as the JAX
package's does. A vocoder step (batches ``{"y", "c", "input_lengths"}``
and ``"g"`` for speakers) shifts its targets into the teacher-forced inputs
and takes the mixture-of-logistics NLL for scalar input or the masked cross
entropy for mulaw-quantize; its convolutions are cuDNN's, and it runs the
fused-Adam kernel once.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh``): each rank is
handed its rows of the global batch (``parallel.mesh.shard_batch``) and
runs the step with the mesh current, so that what the step computes over
the batch (BatchNorm's statistics, masked means, the switch load-balance
term, the EMA codebook's statistics and restart candidates, the code
histogram) is the global batch's. Between the backward and the fused
update the flat gradient buffer is all-reduced once over the data group
(SUM, then / D, the JAX order: all-reduce, clip, Adam), so every rank's
kernel-3 launch applies the one-rank step's gradient and the ranks of a
data group stay bit-equal. Under ``make_multistep_train`` that happens
once per inner step. The Trainer averages its logged metrics over the
data group, gathers the last eval reconstruction in rank order, and logs
and writes metrics on rank 0 only.

Tensor parallelism (a mesh with a model axis and a state placed by
``training.sharding.shard_train_state``): the step runs the same code.
Each rank's flat buffer holds its slices of the sharded leaves and the
whole replicated ones; the forward gathers the split channels, sums the
row-split layers' partial products (the transformer prior's) and merges
the sharded search over the model group (``models``, ``ops.vq``), the
loss is computed whole on every rank of a model group, so a replicated
leaf's gradient is already whole there and only the data-group mean
follows (then model rank 0's is broadcast over the model group: cuDNN's
weight gradients on the card are not bit-deterministic); the clip's global norm adds the model group's sharded squares
(``TrainState.grad_norm``) and kernel 3 runs once a step on the local
buffer. The eval step runs the same forward.
"""

from __future__ import annotations

import itertools
import json
from typing import Callable, Dict, Optional

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.data.pipeline import device_prefetch
from neural_sound_generation_tpu_torch.models import (
    VAE,
    VQVAE,
    GatedPixelCNN,
    HierVQVAE,
    TransformerPrior,
    WaveNet,
    WaveVQVAE,
)
from neural_sound_generation_tpu_torch.parallel import mesh as data_mesh
from neural_sound_generation_tpu_torch.ops.vq import (
    codebook_ema_update,
    residual_codebook_ema_update,
    residual_vq,
    restart_dead_codes,
    vq,
)
from neural_sound_generation_tpu_torch.training.losses import (
    codebook_perplexity,
    discretized_mix_logistic_loss,
    elbo_mse,
    hier_vqvae_loss,
    masked_cross_entropy,
    prior_nll,
    vqvae_loss,
)
from neural_sound_generation_tpu_torch.training.train_state import TrainState
from neural_sound_generation_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]
PRIORS = (TransformerPrior, GatedPixelCNN)
FAMILIES = (VQVAE, HierVQVAE, WaveVQVAE, VAE, WaveNet, *PRIORS)


def _wave_recon_loss(model: WaveVQVAE, out: torch.Tensor, batch: Batch) -> torch.Tensor:
    """MSE for scalar input; masked cross entropy over ``input_lengths``
    for mulaw-quantize (the softmax-output convention)."""
    if model.categorical:
        return masked_cross_entropy(out, batch["x"], batch.get("input_lengths"))
    return torch.mean((out - batch["x"]) ** 2)


def _wavenet_loss(model: WaveNet, cfg: Config, batch: Batch):
    """The vocoder's teacher-forced loss (the JAX ``_wavenet_loss_fn``):
    (logits, loss), MoL over ``quantize_channels`` classes for scalar input,
    masked cross entropy for mulaw-quantize, both over ``input_lengths``."""
    y_hat = model(WaveNet.shift_inputs(batch["y"], model.scalar_input), batch.get("c"),
                  batch.get("g"))
    return y_hat, wavenet_objective(model, cfg, y_hat, batch)


def wavenet_objective(model: WaveNet, cfg: Config, y_hat: torch.Tensor, batch: Batch):
    """The vocoder's loss of its predictions ``y_hat`` against the batch's
    targets over ``input_lengths``: MoL for scalar input, masked cross
    entropy for mulaw-quantize."""
    targets, lengths = batch["y"], batch.get("input_lengths")
    if model.scalar_input:
        return discretized_mix_logistic_loss(
            y_hat, targets, num_classes=cfg.audio.quantize_channels,
            log_scale_min=cfg.arch.log_scale_min, lengths=lengths)
    return masked_cross_entropy(y_hat, targets, lengths)


def _loss_fn(model, cfg: Config) -> Callable:
    """Per-family loss closure: ``(batch, generator) -> (total, metrics,
    z_e or None)``; ``z_e`` feeds the EMA-codebook branch."""
    beta = cfg.model.beta
    if isinstance(model, WaveNet):
        def vocoder_loss(batch: Batch, generator):
            _, loss = _wavenet_loss(model, cfg, batch)
            return loss, {"loss": loss}, None

        return vocoder_loss
    if isinstance(model, PRIORS):
        routed = getattr(model, "n_experts", 0) > 0

        def prior_loss(batch: Batch, generator):
            if routed:
                logits, aux = _prior_logits(model, batch, return_moe_aux=True)
                total, metrics = prior_nll(logits, batch["codes"], aux)
            else:
                total, metrics = prior_nll(_prior_logits(model, batch), batch["codes"])
            return total, metrics, None

        return prior_loss
    if isinstance(model, WaveVQVAE):
        def wave_loss(batch: Batch, generator):
            out, z_e, z_q = model(batch["x"], g=batch.get("g"))
            loss_recons = _wave_recon_loss(model, out, batch)
            loss_vq = torch.mean((z_q - z_e.detach()) ** 2)
            loss_commit = torch.mean((z_e - z_q.detach()) ** 2)
            total = loss_recons + loss_vq + beta * loss_commit
            return total, {"loss": total, "loss_recons": loss_recons, "loss_vq": loss_vq,
                           "loss_commit": loss_commit,
                           "train_loss": loss_recons + loss_vq}, z_e

        return wave_loss
    if isinstance(model, HierVQVAE):
        def hier_loss(batch: Batch, generator):
            x = batch["x"]
            x_tilde, top, bottom = model(x)
            total, metrics = hier_vqvae_loss(x_tilde, x, (top, bottom), beta)
            return total, metrics, None

        return hier_loss
    if isinstance(model, VQVAE):
        def vqvae_step_loss(batch: Batch, generator):
            x = batch["x"]
            x_tilde, z_e, z_q = model(x, g=batch.get("g"))
            total, metrics = vqvae_loss(x_tilde, x, z_e, z_q, beta)
            return total, metrics, z_e

        return vqvae_step_loss
    if isinstance(model, VAE):
        def vae_loss(batch: Batch, generator):
            x = batch["x"]
            x_tilde, kl = model(x, generator=generator)
            total = elbo_mse(x_tilde, x, kl)
            return total, {"loss": total, "kl": kl}, None

        return vae_loss
    raise TypeError(f"unsupported model: {type(model).__name__}")


def _prior_logits(model, batch: Batch, **kw):
    """Either prior family's logits over the batch's codes; a spatially
    conditioned prior takes ``batch["cond"]`` (the JAX
    ``_pixelcnn_loss_fn``). ``kw`` goes to the model (``return_moe_aux``)."""
    cond = (batch["cond"],) if model.spatial_cond else ()
    return model(batch["codes"], batch["labels"], *cond, **kw)


def uses_ema_codebook(model, cfg: Config) -> bool:
    """EMA codebooks serve the single- and residual-codebook families; the
    hierarchy trains its two codebooks by gradient (the JAX
    ``_uses_ema_codebook``)."""
    return bool(cfg.model.ema_codebook) and isinstance(model, (VQVAE, WaveVQVAE))


def make_train_step(model, cfg: Config, mesh=None) -> Callable:
    """One optimization step: ``train_step(state, batch, generator) ->
    (state, metrics)``, updating ``state`` in place. With ``mesh`` the
    batch is this rank's rows and the step is the data-parallel one (see
    the module docstring); the metrics stay this rank's.

    Under ``cfg.model.ema_codebook`` the VQ-VAE's codebook learns by EMA
    cluster statistics: its gradient is zeroed before the update, the
    codebook is overwritten after it (from the pre-update codebook and the
    step's encoder outputs), and ``grad_norm`` is the norm after the
    zeroing. ``generator`` draws the dead-code restarts (on the batch's
    device) and a VAE's noise.

    While the tracer of ``utils.profiling`` is on, a step records the span
    ``train.step`` around three: ``train.forward`` (``zero_grad`` and the
    loss), ``train.backward`` and ``train.optimizer`` (the mesh's gradient
    mean, the codebook's zeroing, kernel 3 with its EMA, the step count and
    the EMA-codebook branch)."""
    loss_fn = _loss_fn(model, cfg)
    ema_codebook = uses_ema_codebook(model, cfg)

    def train_step(state: TrainState, batch: Batch, generator: torch.Generator | None = None):
        with data_mesh.active(mesh):
            return _step(state, batch, generator)

    def _step(state: TrainState, batch: Batch, generator):
        with span("train.step"):
            model.train()
            with span("train.forward"):
                state.flat.zero_grad()
                total, metrics, z_e = loss_fn(batch, generator)
            with span("train.backward"):
                total.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            with span("train.optimizer"):
                _update(state, metrics, z_e, generator)
            return state, metrics

    @torch.no_grad()
    def _update(state: TrainState, metrics, z_e, generator) -> None:
        if mesh is not None:
            # one collective over the flat buffer (the parameters' .grad
            # are views into it): the global batch's gradient
            mesh.mean_(state.flat.grad)
            if state.shards is not None:
                # the replicated leaves' gradient, computed alike on every
                # model rank but not bit-equal on the card: rank 0's
                mesh.model_broadcast_(state.flat.grad[state.flat.split_at:])
        cb_old = None
        if ema_codebook:
            state.flat.view("codebook", state.flat.grad).zero_()
            cb_old = model.codebook.detach().clone()
        metrics["grad_norm"] = state.apply_gradients()
        state.step.add_(1)
        if ema_codebook:
            _ema_codebook_step(state, cfg, cb_old, z_e.detach(), generator)

    return train_step


def _ema_codebook_step(state: TrainState, cfg: Config, cb_old, z_e, generator) -> None:
    """Overwrite the codebook from the step's encoder outputs (the JAX
    ``train_step``'s EMA branch). Assignments use the pre-update codebook;
    under residual VQ each stage's statistics and dead-code candidates come
    from the residual it saw, with one restart draw per stage, in stage
    order, from ``generator``."""
    flat = z_e.reshape(-1, z_e.shape[-1])
    ce = state.codebook_ema
    decay = cfg.model.ema_codebook_decay
    threshold = cfg.model.restart_dead_threshold
    if cb_old.ndim == 3:
        _, _, indices = residual_vq(flat, cb_old)
        new_cb, cluster, esum, residuals = residual_codebook_ema_update(
            cb_old, ce["cluster"], ce["embed_sum"], flat, indices, decay=decay,
            return_residuals=True,
        )
        if threshold > 0:
            restarted = [
                restart_dead_codes(new_cb[q], cluster[q], residuals[q], generator,
                                   threshold=threshold, cluster=cluster[q], embed_sum=esum[q])
                for q in range(new_cb.shape[0])
            ]
            new_cb, cluster, esum = (torch.stack(t) for t in zip(*restarted))
    else:
        indices = vq(flat, cb_old)
        new_cb, cluster, esum = codebook_ema_update(
            cb_old, ce["cluster"], ce["embed_sum"], flat, indices, decay=decay,
        )
        if threshold > 0:
            new_cb, cluster, esum = restart_dead_codes(
                new_cb, cluster, flat, generator,
                threshold=threshold, cluster=cluster, embed_sum=esum,
            )
    state.model.codebook.copy_(new_cb)
    state.codebook_ema = {"cluster": cluster, "embed_sum": esum}


def make_multistep_train(model, cfg: Config, n_inner: int, mesh=None) -> Callable:
    """``n_inner`` optimization steps over a stacked super-batch (every
    tensor gains a leading (n_inner,) axis): ``multi(state, batches,
    generator) -> (state, stacked metrics)``. The parameters, moments and
    EMA stay in their flat buffers from step to step (the JAX package's
    flat carry), so nothing is raveled per step. With ``mesh`` each inner
    step is the data-parallel one, one gradient all-reduce each."""
    step = make_train_step(model, cfg, mesh)

    def multi(state: TrainState, batches: Batch, generator: torch.Generator | None = None):
        per_step = []
        for i in range(n_inner):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()}, generator)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}

    return multi


def stack_batches(batches):
    """List of dict batches -> one super-batch with a leading step axis.
    Numpy batches (the loader's) stack on the host, one copy to the device
    follows; tensors (the prior's code grids, encoded on the device) stack
    where they are."""
    out = {}
    for k, first in batches[0].items():
        if first is None:
            continue
        values = [b[k] for b in batches]
        out[k] = (torch.stack(values) if isinstance(first, torch.Tensor)
                  else np.stack([np.asarray(v) for v in values]))
    return out


def make_eval_step(model, cfg: Config, mesh=None) -> Callable:
    """Eval forward with running statistics: ``eval_step(state, batch) ->
    (reconstruction or prior logits, metrics)``, on the EMA shadow when the
    state has one (``TrainState.eval_params``). The JAX eval step's metrics
    per family: the VQ families add the code perplexity (``perplexity_top``
    too for the hierarchy), the VAE's noise is 0. With ``mesh`` the batch
    is this rank's rows; masked means and perplexities are the global
    batch's, the other metrics this rank's."""
    if not isinstance(model, FAMILIES):
        raise TypeError(f"unsupported model: {type(model).__name__}")
    beta = cfg.model.beta

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        model.eval()
        with state.flat.swapped(state.eval_params()), data_mesh.active(mesh):
            return _eval_forward(batch)

    def _eval_forward(batch: Batch):
        if isinstance(model, WaveNet):
            y_hat, loss = _wavenet_loss(model, cfg, batch)
            return y_hat, {"loss": loss}
        if isinstance(model, PRIORS):
            logits = _prior_logits(model, batch)
            _, metrics = prior_nll(logits, batch["codes"])
            return logits, metrics
        x = batch["x"]
        if isinstance(model, WaveVQVAE):
            out, z_e, z_q = model(x, g=batch.get("g"))
            loss_recons = _wave_recon_loss(model, out, batch)
            metrics = {"loss": loss_recons + torch.mean((z_q - z_e) ** 2),
                       "loss_recons": loss_recons,
                       "perplexity": codebook_perplexity(model.encode(x), model.z_dim)}
            return out, metrics
        if isinstance(model, HierVQVAE):
            x_tilde, top, bottom = model(x)
            _, metrics = hier_vqvae_loss(x_tilde, x, (top, bottom), beta)
            idx_t, idx_b = model.encode(x)
            metrics["perplexity_top"] = codebook_perplexity(idx_t, model.k_top)
            metrics["perplexity"] = codebook_perplexity(idx_b, model.z_dim)
            return x_tilde, metrics
        if isinstance(model, VQVAE):
            x_tilde, z_e, z_q = model(x, g=batch.get("g"))
            _, metrics = vqvae_loss(x_tilde, x, z_e, z_q, beta)
            # residual VQ: the (Q, ...) indices pool usage over the stages,
            # as the JAX eval step's codebook_perplexity does
            metrics["perplexity"] = codebook_perplexity(model.encode(x), model.z_dim)
            return x_tilde, metrics
        x_tilde, kl = model(x)
        return x_tilde, {"loss": elbo_mse(x_tilde, x, kl), "kl": kl}

    return eval_step


class Trainer:
    """Epoch driver: train epochs, eval epochs, metric aggregation.

    Metric sums stay on the device and are pulled once per epoch; only the
    ``log_interval`` print and the checkpoint callback read the host. With
    ``mesh`` the batches it is given are this rank's rows
    (``parallel.mesh.shard_batch``), every pull averages over the ranks
    (one collective, the same on every rank), and only rank 0 logs and
    writes ``metrics_path``."""

    def __init__(
        self,
        model,
        cfg: Config,
        state: TrainState,
        log_fn: Optional[Callable[[str], None]] = print,
        metrics_path: Optional[str] = None,
        multi_steps: int = 1,
        mesh=None,
    ):
        self.model = model
        self.cfg = cfg
        self.state = state
        self.mesh = mesh
        self.device = state.flat.flat.device
        primary = mesh is None or mesh.is_primary
        self.log_fn = (log_fn if primary else None) or (lambda s: None)
        self.metrics_path = metrics_path if primary else None
        self.multi_steps = max(1, multi_steps)
        self._train_step = make_train_step(model, cfg, mesh)
        self._multi_step = (
            make_multistep_train(model, cfg, self.multi_steps, mesh)
            if self.multi_steps > 1 else None
        )
        self._eval_step = make_eval_step(model, cfg, mesh)

    def _write_metrics(self, record: Dict) -> None:
        if not self.metrics_path:
            return
        with open(self.metrics_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")

    def _batches_on_device(self, batches):
        """Host numpy batches -> device tensors, two batches ahead."""
        return device_prefetch(batches, size=2, device=self.device)

    def _pull(self, sums: Optional[Dict[str, torch.Tensor]], count: int) -> Dict[str, float]:
        """Host means of summed metrics; on a mesh averaged over the ranks
        (every rank's batches hold the same number of rows)."""
        if not sums:
            return {}
        keys = sorted(sums)
        values = torch.stack([sums[k].to(torch.float32) for k in keys])
        if self.mesh is not None:
            self.mesh.mean_(values)
        return {k: v / max(count, 1) for k, v in zip(keys, values.cpu().tolist())}

    def train_epoch(self, batches, generator: torch.Generator | None = None,
                    epoch: int = 0, checkpoint_cb=None):
        """batches: iterable of dict batches (host numpy or tensors).
        Returns mean metrics over the epoch.

        ``checkpoint_cb(state, step)`` runs every
        ``cfg.train.checkpoint_interval`` optimization steps. While the
        tracer of ``utils.profiling`` is on, each fetch of the next device
        batch (the source's ``next``, pinning, the copy's enqueue) is a
        ``train.feed`` span and each metric pull, with its log line, a
        ``train.pull`` span."""
        sums: Optional[Dict[str, torch.Tensor]] = None
        count = 0
        interval = self.cfg.train.checkpoint_interval
        step_now = int(self.state.step)
        step_incr = self.multi_steps if self._multi_step is not None else 1
        if self._multi_step is not None:
            batches = self._chunk_batches(batches)
        feed = iter(self._batches_on_device(batches))
        for i in itertools.count():
            try:
                with span("train.feed"):
                    batch = next(feed)
            except StopIteration:
                break
            if self._multi_step is not None:
                self.state, stacked = self._multi_step(self.state, batch, generator)
                metrics = {k: v.mean() for k, v in stacked.items()}
            else:
                self.state, metrics = self._train_step(self.state, batch, generator)
            count += 1
            step_now += step_incr
            if self.cfg.train.log_interval and i % self.cfg.train.log_interval == 0:
                with span("train.pull"):
                    m = self._pull(metrics, 1)
                    self.log_fn(
                        f"Train Epoch: {epoch} [{i}]\t"
                        + " ".join(f"{k}={v:.6f}" for k, v in sorted(m.items()))
                    )
            if sums is None:
                sums = dict(metrics)
            else:
                sums = {k: sums.get(k, 0.0) + v for k, v in metrics.items()}
            if checkpoint_cb and interval and step_now % interval < step_incr:
                checkpoint_cb(self.state, step_now)
        with span("train.pull"):
            means = self._pull(sums, count)
        if count == 0:
            # a silent no-op epoch trains nothing while printing loss 0.0
            self.log_fn(
                f"WARNING: epoch {epoch} produced 0 training batches — "
                f"batch_size ({self.cfg.train.batch_size})"
                + (f" x multi_steps ({self.multi_steps})" if self._multi_step is not None else "")
                + " likely exceeds the training split after drop_last"
            )
        self.log_fn(f"====> Epoch: {epoch} Average loss: {means.get('loss', 0.0):.4f}")
        self._write_metrics({"phase": "train", "epoch": epoch, "batches": count, **means})
        return means

    def _chunk_batches(self, batches):
        """Group mini-batches into stacked super-batches of multi_steps; the
        final partial chunk is dropped."""
        chunk = []
        for b in batches:
            chunk.append(b)
            if len(chunk) == self.multi_steps:
                yield stack_batches(chunk)
                chunk = []

    def eval_epoch(self, batches):
        sums: Optional[Dict[str, torch.Tensor]] = None
        count = 0
        last_recon = None
        for batch in self._batches_on_device(batches):
            last_recon, metrics = self._eval_step(self.state, batch)
            count += 1
            if sums is None:
                sums = dict(metrics)
            else:
                sums = {k: sums.get(k, 0.0) + v for k, v in metrics.items()}
        means = self._pull(sums, count)
        if self.mesh is not None and last_recon is not None:
            last_recon = self.mesh.gather_rows(last_recon.contiguous())
        self.log_fn(f"====> Test set loss: {means.get('loss', 0.0):.4f}")
        self._write_metrics({"phase": "test", "batches": count, **means})
        return means, last_recon


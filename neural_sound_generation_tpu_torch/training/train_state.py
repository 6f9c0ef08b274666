"""Train state: one flat parameter buffer, the fused optimizer and the EMA.

Counterpart of ``neural_sound_generation_tpu/training/train_state.py`` for
the flat fused optimizer (``TrainConfig.fused_optimizer``, the JAX default).

The JAX package ravels the parameter tree into one vector per step
(``ravel_pytree``) so the optimizer runs as one pass over contiguous memory.
Here the ravel happens once: ``FlatParams`` moves every parameter of a
module into one float32 buffer and makes each ``nn.Parameter`` a view into
it, and gradients land in a second buffer of the same layout (each
parameter's ``.grad`` is a view into it, zeroed in place every step, never
set to ``None``, which would break the views). The fused kernel then
updates the model in place. The flat order is the module's
``named_parameters()`` order, not JAX's sorted-key order; ``convert.py``
maps one onto the other by name. Each parameter's view starts on a 16-byte
boundary (``flat_offsets``), the gaps held at zero: cuDNN's training-mode
batch norm on channels-last input (what a model's first convolution gives
its permuted one-channel NHWC input) faults (CUDNN_STATUS_EXECUTION_FAILED)
on a scale 4 bytes off one, which a (1,) bias ahead of it in the buffer
leaves it (``scripts/torch_flat_alignment_check.py``).

The per-leaf optimizer (``fused=False``, ``TrainConfig.fused_optimizer``
off; the JAX ``make_optimizer`` chain and ``create_train_state(fused=
False)``): clip by the global norm -> weight decay -> Adam, leaf by leaf,
in plain PyTorch ops (JAX runs that chain as XLA, with no Pallas kernel);
its moments are one float32 tensor per parameter (``LeafOptState``). The
parameters keep their flat buffer and the EMA its flat shadow, so a
checkpoint names the same tensors under either optimizer and restores into
the other (``training.checkpoint``).

Tensor parallelism (the mesh's model axis, ``training.sharding``) keeps the
fused optimizer. The JAX package needs the per-leaf one there only because
GSPMD would all-gather a flat vector laid over sharded leaves
(``FusedOptState``'s docstring there); here each rank owns a flat buffer
of its own leaves (the sharded slices first, then the replicated leaves,
``FlatParams(first=...)``), so kernel 3 runs once a step on that local
buffer with the same clip -> weight decay -> Adam chain. The clip's global
norm is the one-rank norm: the sharded segment's sum of squares summed
over the model group, plus the replicated segment's counted once
(``TrainState.grad_norm``). The JAX Trainer's refusal of a fused state
under tensor parallelism has no counterpart. The pipe axis
(``parallel.pipeline``) lays a rank's buffer the same way, its stage's
layers first, and sums their squares over the pipe group.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Iterator

import torch
from torch import nn

from neural_sound_generation_tpu_torch.config import TrainConfig
from neural_sound_generation_tpu_torch.ops.cuda.fused_adam import fused_adam_update

Schedule = Callable[[torch.Tensor], torch.Tensor]

#: parameter views start at multiples of this many float32 elements (16 bytes)
ALIGN = 4


def flat_offsets(shapes) -> tuple[list[int], int]:
    """Where each parameter of ``shapes`` starts in the flat buffer (a
    multiple of ALIGN), and the buffer's length."""
    offsets, n = [], 0
    for shape in shapes:
        n = -(-n // ALIGN) * ALIGN
        offsets.append(n)
        n += math.prod(shape)
    return offsets, n


def make_lr_schedule(cfg: TrainConfig) -> Schedule:
    """lr schedule by name (hparams.py:106 ``lr_schedule``): a function of
    the 0-d integer step count (a tensor on the device) returning a 0-d
    float32 tensor on the same device."""
    name = cfg.lr_schedule
    kwargs = dict(cfg.lr_schedule_kwargs)
    base = cfg.initial_learning_rate
    if name in (None, "", "constant"):
        return lambda count: torch.full((), base, dtype=torch.float32, device=count.device)
    if name == "noam_learning_rate_decay":
        warmup = float(kwargs.get("warmup_steps", 4000))

        def noam(count):
            step = torch.clamp(count, min=1).to(torch.float32)
            return base * warmup**0.5 * torch.minimum(step * warmup**-1.5, step**-0.5)

        return noam
    if name == "step_learning_rate_decay":
        # optax.exponential_decay(base, anneal_interval, anneal_rate,
        # staircase=True): base * rate ** floor(count / interval)
        rate = float(kwargs.get("anneal_rate", 0.98))
        interval = int(kwargs.get("anneal_interval", 30000))
        if interval <= 0 or rate == 0:
            return make_lr_schedule(dataclasses.replace(cfg, lr_schedule="constant"))

        def step_decay(count):
            # a tensor divisor: CUDA divides by a host scalar as a multiply
            # by its reciprocal, which can land floor() one step early
            divisor = torch.full((), float(interval), device=count.device)
            p = torch.floor(count.to(torch.float32) / divisor)
            decayed = base * torch.pow(rate, p)
            return torch.where(count <= 0, torch.full_like(decayed, base), decayed)

        return step_decay
    raise ValueError(f"unknown lr_schedule: {name!r}")


def resolve_ema_decay(ema_decay: float, ema_warmup: bool, step: torch.Tensor) -> torch.Tensor:
    """The EMA decay as a 0-d float32 tensor on ``step``'s device: the
    reference's fixed decay (hparams.py:118), or under ``ema_warmup``
    min(decay, (1+t)/(10+t)) with t = step + 1. ``step`` is the 0-based
    step BEFORE the increment."""
    if not ema_warmup:
        return torch.full((), ema_decay, dtype=torch.float32, device=step.device)
    t = (step + 1).to(torch.float32)
    return torch.clamp((1.0 + t) / (10.0 + t), max=ema_decay)


class FlatParams:
    """Every parameter of ``module`` as a view into one float32 buffer.

    ``flat`` holds the values and ``grad`` the gradients in the same
    layout; each parameter's ``.data`` and ``.grad`` are views into them,
    each starting on a 16-byte boundary (``flat_offsets``); the gaps stay
    zero in every flat vector, so the optimizer leaves them zero.
    Build it after the module is on its device: ``module.to()`` would
    replace the views with copies. ``load_state_dict`` copies in place and
    keeps them. The parameters named in ``first`` (a rank's sharded
    leaves under the model axis) come first, in module order; ``split_at``
    is where the rest begin."""

    def __init__(self, module: nn.Module, first=()):
        named = list(module.named_parameters())
        if not named:
            raise ValueError("module has no parameters")
        first = set(first)
        named = ([(n, p) for n, p in named if n in first]
                 + [(n, p) for n, p in named if n not in first])
        device = named[0][1].device
        self.names = [name for name, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        self.offsets, n = flat_offsets(self.shapes)
        n_first = sum(1 for name in self.names if name in first)
        self.split_at = self.offsets[n_first] if n_first < len(self.names) else n
        self.flat = torch.zeros(n, dtype=torch.float32, device=device)
        self.grad = torch.zeros(n, dtype=torch.float32, device=device)
        self._params = [p for _, p in named]
        with torch.no_grad():
            for p, view in zip(self._params, self.split(self.flat)):
                if p.device != device:
                    raise ValueError(f"parameters on {p.device} and {device}")
                view.copy_(p.detach())
                p.data = view
        for p, gview in zip(self._params, self.split(self.grad)):
            p.grad = gview

    @property
    def numel(self) -> int:
        return self.flat.numel()

    def split(self, vector: torch.Tensor) -> list[torch.Tensor]:
        """Views of a flat vector shaped as the parameters, in order."""
        return [
            vector[o : o + math.prod(s)].view(s) for o, s in zip(self.offsets, self.shapes)
        ]

    def named(self, vector: torch.Tensor) -> dict[str, torch.Tensor]:
        return dict(zip(self.names, self.split(vector)))

    def view(self, name: str, vector: torch.Tensor | None = None) -> torch.Tensor:
        """One parameter's view of ``vector`` (the live values by default)."""
        i = self.names.index(name)
        return self.split(self.flat if vector is None else vector)[i]

    def zero_grad(self) -> None:
        self.grad.zero_()

    @contextlib.contextmanager
    def swapped(self, vector: torch.Tensor) -> Iterator[None]:
        """Run the module on another flat vector of the same layout (the EMA
        shadow) without copying it: each parameter points into ``vector``
        for the duration."""
        if vector.shape != self.flat.shape:
            raise ValueError(f"expected a flat vector of {self.numel}, got {tuple(vector.shape)}")
        saved = [p.data for p in self._params]
        try:
            for p, view in zip(self._params, self.split(vector)):
                p.data = view
            yield
        finally:
            for p, data in zip(self._params, saved):
                p.data = data


@dataclasses.dataclass
class FusedOptState:
    """Adam moments as flat vectors (float32, or bfloat16 under
    ``bf16_moments``) and the step count, a 0-d int32 tensor on the device.
    The remaining fields are hyperparameters."""

    count: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    lr: float | Schedule = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip: float = -1.0
    wd: float = 0.0

    def moments(self) -> list[torch.Tensor]:
        return [self.m, self.v]

    def named_moments(self, flat: FlatParams, key: str) -> dict[str, torch.Tensor]:
        """``m`` or ``v`` by parameter name (views of the flat vector)."""
        return flat.named(getattr(self, key))


@dataclasses.dataclass
class LeafOptState:
    """The per-leaf optimizer's state: the step count (a 0-d int32 tensor
    on the device) and Adam's moments as one float32 tensor per parameter,
    by name (optax's ``ScaleByAdamState`` mu and nu). The remaining fields
    are hyperparameters."""

    count: torch.Tensor
    m: dict
    v: dict
    lr: float | Schedule = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip: float = -1.0
    wd: float = 0.0

    def moments(self) -> list[torch.Tensor]:
        return [*self.m.values(), *self.v.values()]

    def named_moments(self, flat: FlatParams, key: str) -> dict[str, torch.Tensor]:
        return getattr(self, key)


def _hyper(cfg: TrainConfig, use_schedule: bool) -> dict:
    return dict(
        lr=make_lr_schedule(cfg) if use_schedule else float(cfg.initial_learning_rate),
        b1=float(cfg.adam_beta1),
        b2=float(cfg.adam_beta2),
        eps=float(cfg.adam_eps),
        clip=float(cfg.clip_thresh or -1.0),
        wd=float(cfg.weight_decay or 0.0),
    )


def leaf_opt_init(flat: FlatParams, cfg: TrainConfig, use_schedule: bool) -> LeafOptState:
    """Zero float32 moments for every parameter (optax's adam ignores
    ``bf16_moments``, as the JAX per-leaf chain does)."""
    views = flat.named(flat.flat)
    return LeafOptState(
        count=torch.zeros((), dtype=torch.int32, device=flat.flat.device),
        m={k: torch.zeros_like(t) for k, t in views.items()},
        v={k: torch.zeros_like(t) for k, t in views.items()},
        **_hyper(cfg, use_schedule),
    )


def leaf_update(
    s: LeafOptState, flat: FlatParams, ema: torch.Tensor | None, ema_decay: float,
    ema_warmup: bool, step: torch.Tensor, gnorm: torch.Tensor | None = None,
) -> torch.Tensor:
    """One per-leaf Adam(+EMA) update: optax's ``clip_by_global_norm`` ->
    ``add_decayed_weights`` -> ``adam`` (the JAX ``make_optimizer`` chain)
    on each parameter and its moments, in place, then the EMA. Returns the
    global norm of the raw gradient (``gnorm`` when the caller took it).
    The lr is read at the pre-increment count, the bias corrections use
    count + 1, as optax does."""
    grads = flat.named(flat.grad)
    params = flat.named(flat.flat)
    if gnorm is None:
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    lr = s.lr(s.count) if callable(s.lr) else torch.full(
        (), s.lr, dtype=torch.float32, device=flat.flat.device)
    cf = (s.count + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(s.b1, cf)
    bc2 = 1.0 - torch.pow(s.b2, cf)
    for name, g in grads.items():
        p = params[name]
        if s.clip > 0:
            # optax: where(g_norm < max_norm, g, g / g_norm * max_norm)
            g = torch.where(gnorm < s.clip, g, g / gnorm * s.clip)
        if s.wd > 0:
            g = g + s.wd * p
        m, v = s.m[name], s.v[name]
        m.copy_((1.0 - s.b1) * g + s.b1 * m)
        v.copy_((1.0 - s.b2) * (g * g) + s.b2 * v)
        update = (m / bc1) / (torch.sqrt(v / bc2) + s.eps)
        p.add_(-lr * update)
    if ema is not None:
        d = resolve_ema_decay(ema_decay, ema_warmup, step)
        ema.copy_(d * ema + (1.0 - d) * flat.flat)
    s.count.add_(1)
    return gnorm


def fused_opt_init(flat: FlatParams, cfg: TrainConfig, use_schedule: bool) -> FusedOptState:
    moment_dtype = torch.bfloat16 if cfg.bf16_moments else torch.float32
    device = flat.flat.device
    return FusedOptState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        m=torch.zeros(flat.numel, dtype=moment_dtype, device=device),
        v=torch.zeros(flat.numel, dtype=moment_dtype, device=device),
        **_hyper(cfg, use_schedule),
    )


def fused_flat_update(
    s: FusedOptState, flat_p: torch.Tensor, flat_g: torch.Tensor,
    ema: torch.Tensor | None, ema_decay: float, ema_warmup: bool, step: torch.Tensor,
    gnorm: torch.Tensor | None = None,
) -> torch.Tensor:
    """One fused Adam(+EMA) update on flat float32 vectors: the single
    source of the optimizer math (the JAX ``fused_flat_update``). ``gnorm``
    is the raw gradient's global norm where the caller took it (across the
    model group under tensor parallelism); by default the norm of
    ``flat_g``.

    In place on ``flat_p``, ``s.m``, ``s.v`` and ``ema``; ``s.count`` is
    incremented. Returns the global norm of the raw gradient (before clip
    and weight decay). The order is clip -> weight decay -> Adam; the lr is
    read at the pre-increment count, the bias corrections use count + 1 (as
    float32 powers), the EMA decay is resolved at the pre-increment
    ``step``. The per-step scalars stay on the device: nothing here waits
    on the host."""
    flat_g = flat_g.to(torch.float32)
    if gnorm is None:
        # a cascaded sum: PyTorch's CPU vector_norm accumulates a long float32
        # vector in one running sum (2e-4 relative error at 4.9M elements)
        gnorm = torch.sqrt(torch.sum(flat_g * flat_g))
    if s.clip > 0:
        gscale = torch.clamp(
            torch.full_like(gnorm, s.clip) / torch.clamp(gnorm, min=1e-12), max=1.0
        )
    else:
        gscale = torch.ones((), dtype=torch.float32, device=flat_p.device)
    lr = s.lr(s.count) if callable(s.lr) else torch.full(
        (), s.lr, dtype=torch.float32, device=flat_p.device
    )
    cf = (s.count + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(s.b1, cf)  # float32 powers, on the device
    bc2 = 1.0 - torch.pow(s.b2, cf)
    d = (
        resolve_ema_decay(ema_decay, ema_warmup, step)
        if ema is not None
        else torch.zeros((), dtype=torch.float32, device=flat_p.device)
    )
    scalars = torch.stack([gscale, lr, bc1, bc2, d]).to(torch.float32)
    fused_adam_update(
        flat_g, flat_p, s.m, s.v, ema, scalars,
        b1=s.b1, b2=s.b2, eps=s.eps, clip=s.clip > 0, wd=s.wd,
    )
    s.count.add_(1)
    return gnorm


@dataclasses.dataclass
class TrainState:
    """The model (its parameters views of ``flat.flat``, its BatchNorm
    running statistics as buffers), the optimizer state (fused or per
    leaf), the flat EMA shadow and the EMA-codebook statistics. ``step`` is
    a 0-d int32 tensor on the device. Updated in place by the train step.
    Under the model axis ``shards`` (a ``training.sharding.ModelShards``)
    says which of this rank's tensors are slices of which whole ones."""

    model: nn.Module
    flat: FlatParams
    step: torch.Tensor
    opt_state: FusedOptState | LeafOptState
    ema_params: torch.Tensor | None
    ema_decay: float = 0.0
    ema_warmup: bool = False
    # EMA-codebook statistics (ModelConfig.ema_codebook):
    # {"cluster": (K,), "embed_sum": (K, D)}, or (Q, K) and (Q, K, D) for
    # residual VQ
    codebook_ema: dict | None = None
    shards: object | None = None

    def eval_params(self) -> torch.Tensor:
        """The flat EMA shadow when enabled, else the live parameters (the
        reference's intended averaged-model evaluation, hparams.py:116-118)."""
        return self.flat.flat if self.ema_params is None else self.ema_params

    def grad_norm(self) -> torch.Tensor | None:
        """The global norm of the raw gradient under the model or the pipe
        axis: the sharded segment's squares summed over the model (or pipe)
        group (``shards.sum_sharded``) plus the replicated segment's; None
        (the optimizer's own norm) otherwise."""
        if self.shards is None:
            return None
        g, cut = self.flat.grad, self.flat.split_at
        sharded = self.shards.sum_sharded(torch.sum(g[:cut] * g[:cut]))
        return torch.sqrt(sharded + torch.sum(g[cut:] * g[cut:]))

    def apply_gradients(self) -> torch.Tensor:
        """One optimizer update from ``flat.grad``, in place: kernel 3 on
        the flat buffers, or the per-leaf chain. Returns the raw gradient's
        global norm."""
        gnorm = self.grad_norm()
        if isinstance(self.opt_state, LeafOptState):
            return leaf_update(self.opt_state, self.flat, self.ema_params, self.ema_decay,
                               self.ema_warmup, self.step, gnorm)
        return fused_flat_update(self.opt_state, self.flat.flat, self.flat.grad,
                                 self.ema_params, self.ema_decay, self.ema_warmup, self.step,
                                 gnorm)


def create_train_state(
    model: nn.Module,
    cfg: TrainConfig,
    use_schedule: bool = False,
    ema_codebook: bool = False,
    fused: bool | None = None,
    first=(),
) -> TrainState:
    """Flatten ``model``'s parameters (on its device) and build the state:
    the fused optimizer, or with ``fused`` False (None: follow
    ``cfg.fused_optimizer``) the per-leaf one. The parameters named in
    ``first`` lead the flat buffer (``FlatParams``: a pipeline stage's
    layers).

    Under ``ema_codebook`` the codebook statistics start as cluster sizes
    of 1 and ``embed_sum`` equal to the codebook, so embed_sum / cluster is
    the codebook at init; a residual-VQ (Q, K, D) codebook gets (Q, K)
    clusters."""
    if fused is None:
        fused = cfg.fused_optimizer
    flat = FlatParams(model, first=first)
    device = flat.flat.device
    ema = flat.flat.clone() if cfg.exponential_moving_average else None
    cb_ema = None
    if ema_codebook and "codebook" in flat.names:
        cb = flat.view("codebook")
        cb_ema = {
            "cluster": torch.ones(cb.shape[:-1], dtype=torch.float32, device=device),
            "embed_sum": cb.detach().clone(),
        }
    return TrainState(
        model=model,
        flat=flat,
        step=torch.zeros((), dtype=torch.int32, device=device),
        opt_state=(fused_opt_init if fused else leaf_opt_init)(flat, cfg, use_schedule),
        ema_params=ema,
        ema_decay=cfg.ema_decay,
        ema_warmup=cfg.ema_warmup,
        codebook_ema=cb_ema,
    )

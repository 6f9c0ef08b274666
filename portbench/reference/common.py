"""What the references share: the precision they compute in, batch
normalisation, Adam with its EMA shadow, seeded weights from a parameter
table, and the comparison of two training runs leaf by leaf.

A reference computes in float32 with TF32 off. The control of a cell is the
same reference computed one precision lower (``Precision``): TF32 for a
float32 cell.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch


class Precision:
    """``name``: ``f32`` (float32, TF32 off) or ``tf32`` (float32 products
    in TF32)."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "tf32"):
            raise ValueError(f"unknown reference precision {name!r}")
        self.name = name

    @contextlib.contextmanager
    def active(self):
        """TF32 on for ``tf32``, off otherwise; the flags are restored."""
        cuda_mm = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        tf32 = self.name == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = cuda_mm
            torch.backends.cudnn.allow_tf32 = cudnn


def batch_norm_train(x: torch.Tensor, weight, bias, eps: float = 1e-5) -> torch.Tensor:
    """Training-mode batch normalisation over every axis but the channels
    (axis 1): the batch mean and the biased batch variance."""
    dims = (0, *range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = x.mean(dim=dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=dims, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * weight.view(shape) + bias.view(shape)


# -- seeded weights ---------------------------------------------------------


def xavier_bound(shape) -> float:
    """Glorot's uniform bound sqrt(6 / (fan_in + fan_out)) of a kernel laid
    out (out, in, *taps) or (in, out, *taps): the sum is the same."""
    taps = math.prod(shape[2:]) if len(shape) > 2 else 1
    return math.sqrt(6.0 / ((shape[0] + shape[1]) * taps))


def make_weights(table, generator: torch.Generator, device) -> dict[str, torch.Tensor]:
    """Weights for a parameter table ``[(name, shape, init, arg)]`` from one
    draw of uniform numbers on ``device``. ``init``: ``xavier`` (Glorot
    uniform), ``uniform`` (U(-arg, arg)), ``normal`` (N(0, arg^2), by the
    Box-Muller transform of two uniform draws), ``zeros``, ``ones``."""
    sizes = [math.prod(shape) for _, shape, _, _ in table]
    u = torch.rand(2 * sum(sizes), generator=generator, device=device, dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, init, arg), n in zip(table, sizes):
        a, b = u[at:at + n], u[at + n:at + 2 * n]
        at += 2 * n
        if init == "xavier":
            t = (2.0 * a - 1.0) * xavier_bound(shape)
        elif init == "uniform":
            t = (2.0 * a - 1.0) * arg
        elif init == "normal":
            t = arg * torch.sqrt(-2.0 * torch.log1p(-a)) * torch.cos(2.0 * math.pi * b)
        elif init == "zeros":
            t = torch.zeros_like(a)
        elif init == "ones":
            t = torch.ones_like(a)
        else:
            raise ValueError(f"unknown init {init!r} for {name}")
        out[name] = t.reshape(shape).contiguous()
    return out


# -- Adam -------------------------------------------------------------------


class Adam:
    """Adam (Kingma and Ba 2015) leaf by leaf at a constant learning rate,
    with no clipping and no weight decay (the CLIs' defaults), and the
    parameters' exponential moving average after each step,
    ema = d ema + (1 - d) p, from ema = p at the start, with d held in
    float32 as the parameters are."""

    def __init__(self, params: dict, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, ema_decay: float = 0.9999):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.ema = {k: p.detach().clone() for k, p in params.items()}
        self.decay = torch.tensor(ema_decay, dtype=torch.float32)
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2 = 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            p.sub_(self.lr * (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + self.eps))
            d = self.decay.to(p.device)
            self.ema[k].mul_(d).add_((1.0 - d) * p)


def train_reference(loss_fn, weights: dict, batches, opt_kw: dict, prec: Precision):
    """Three (or ``len(batches)``) reference steps from ``weights``: returns
    (the loss of each step, the first step's gradient by leaf, the
    parameters after the last step, their EMA shadow after the last step).
    ``loss_fn(params, batch)``."""
    params = {k: w.detach().clone().requires_grad_(True) for k, w in weights.items()}
    opt = Adam(params, **opt_kw)
    losses, first_grad = [], None
    with prec.active():
        for batch in batches:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = {k: (torch.zeros_like(p) if g is None else g)
                     for (k, p), g in zip(params.items(), grads)}
            if first_grad is None:
                first_grad = {k: g.detach().clone() for k, g in grads.items()}
            losses.append(float(loss.detach()))
            opt.step(params, grads)
    return losses, first_grad, {k: p.detach() for k, p in params.items()}, opt.ema


# -- comparison -------------------------------------------------------------


def _norms(tensors: dict) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tensors.items()}


def leaf_gaps(program: dict, reference: dict, leaves=None) -> dict[str, float]:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    names = sorted(reference) if leaves is None else sorted(leaves)
    pn, rn = _norms({k: program[k] for k in names}), _norms({k: reference[k] for k in names})
    median = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in names}


def moved_leaves(first_grad: dict, share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient is not nought to rounding: a norm at
    least ``share`` of the median leaf's. A bias ahead of a batch norm has a
    zero true gradient, and Adam moves it by round-off alone."""
    norms = _norms(first_grad)
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= share * median]


def compare_training(prog_losses, prog_grad, prog_delta, prog_ema_delta,
                     ref_losses, ref_grad, ref_delta, ref_ema_delta):
    """The numbers a training cell compares: the worst step's relative loss
    gap, the worst leaf's gap of first-gradient norms, and the median moved
    leaf's gap of the parameters' change and of their EMA shadow's change
    over the steps (with the worst leaf's, which are not compared)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses))
    grad_gaps = leaf_gaps(prog_grad, ref_grad)
    grad_leaf = max(grad_gaps, key=grad_gaps.get)
    moved = moved_leaves(ref_grad)
    update_gaps = leaf_gaps(prog_delta, ref_delta, moved)
    update_leaf = max(update_gaps, key=update_gaps.get)
    ema_gaps = leaf_gaps(prog_ema_delta, ref_ema_delta, moved)
    return {
        "loss_gap": loss_gap, "grad_gap": grad_gaps[grad_leaf],
        "update_gap": update_gaps[update_leaf],
        "loss1_gap": abs(prog_losses[0] - ref_losses[0]) / max(abs(ref_losses[0]), 1e-30),
        "update_median_gap": statistics.median(update_gaps.values()),
        "ema_median_gap": statistics.median(ema_gaps.values()),
        "ema_gap": max(ema_gaps.values()),
        "grad_median_gap": statistics.median(grad_gaps.values()),
        "grad_leaf": grad_leaf, "update_leaf": update_leaf,
        "leaves": len(ref_grad), "moved_leaves": len(moved),
    }

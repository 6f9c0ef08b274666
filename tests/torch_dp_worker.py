"""The data-parallel cases of ``tests/test_torch_data_parallel.py``, and the
rank process that runs them.

``python tests/torch_dp_worker.py <rank> <world> <dir>`` joins a gloo group
through ``file://<dir>/init``, reads the inputs the test wrote to
``<dir>/inputs.pt``, runs every case of ``CASES`` on its rows and writes
``<dir>/rank<r>.pt``. The test runs the same case functions in its own
process with ``mesh=None`` on the whole batch: that is the one-rank
reference each rank's result is held against.

A case returns ``{"global": {...}, "rows": {...}}``: the global values must
equal the one-rank ones (and be bit-equal across ranks), the rows are this
rank's block of a per-row result, concatenated in rank order by the test.
Gradients of per-rank quantities are divided by W where the one-rank
quantity is their mean over ranks. This file imports torch and the port,
never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.data.sampler import shard_for_host
from neural_sound_generation_tpu_torch.models import VAE, VQVAE
from neural_sound_generation_tpu_torch.models.layers import BatchNorm
from neural_sound_generation_tpu_torch.models.moe import SwitchMoE
from neural_sound_generation_tpu_torch.parallel import (
    distributed,
    loader_shard_args,
    make_mesh,
    shard_batch,
)
from neural_sound_generation_tpu_torch.parallel.mesh import active
from neural_sound_generation_tpu_torch.training import losses
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import (
    make_eval_step,
    make_multistep_train,
    make_train_step,
)

DIM, Z_DIM = 16, 32
TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, initial_learning_rate=1e-3)


def config(**model) -> Config:
    cfg = Config()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **TRAIN),
        model=dataclasses.replace(cfg.model, dim=DIM, z_dim=Z_DIM, beta=0.25, **model))


def _w(mesh) -> int:
    return 1 if mesh is None else mesh.n_data


def _rank_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.detach().clone()
    return t if mesh is None else mesh.mean_(t)


def _vqvae(inp, num_quantizers: int = 1) -> VQVAE:
    model = VQVAE(1, DIM, Z_DIM, num_quantizers=num_quantizers)
    model.load_state_dict(inp["rvq" if num_quantizers > 1 else "vqvae"])
    return model


def _warm(state):
    """Warm Adam moments (count 100, m and v drawn from a fixed seed), so
    that an update is a smooth function of the gradient: Adam's first step
    moves an element by about lr * sign(g), which turns the rounding noise
    of a gradient whose true value is 0 into a step of 2 lr."""
    gen = torch.Generator().manual_seed(11)
    n = state.flat.numel
    with torch.no_grad():
        state.step.fill_(100)
        state.opt_state.count.fill_(100)
        state.opt_state.m.copy_(1e-3 * torch.randn(n, generator=gen))
        state.opt_state.v.copy_(torch.empty(n).uniform_(1e-6, 1e-5, generator=gen))
    return state


def _state_out(state) -> dict:
    return {"flat": state.flat.flat.clone(), "grad": state.flat.grad.clone(),
            **{f"buffer/{k}": b.clone() for k, b in state.model.named_buffers()}}


def flagship(inp, mesh):
    """The flagship VQ-VAE's train step and eval step."""
    cfg = config()
    model = _vqvae(inp)
    state = _warm(create_train_state(model, cfg.train))
    if mesh is not None:
        mesh.replicate(state)
    batch = shard_batch({"x": inp["x"]}, mesh)
    _, m = make_train_step(model, cfg, mesh)(state, batch)
    out = {k: _rank_mean(v, mesh) for k, v in m.items()}
    out.update(_state_out(state))
    _, em = make_eval_step(model, cfg, mesh)(state, batch)
    out.update({f"eval/{k}": _rank_mean(v, mesh) for k, v in em.items()})
    return {"global": out, "rows": {}}


def batch_norm(inp, mesh):
    """A train-mode BatchNorm at |mean| / std = 100: its output, the
    gradients and the running statistics."""
    bn = BatchNorm(inp["bn_x"].shape[1])
    with torch.no_grad():
        bn.weight.copy_(inp["bn_w"])
        bn.bias.copy_(inp["bn_b"])
    x = shard_batch({"x": inp["bn_x"]}, mesh)["x"].clone().requires_grad_(True)
    r = shard_batch({"r": inp["bn_r"]}, mesh)["r"]
    with active(mesh):
        y = bn(x)
    torch.mean(y * r).backward()
    grads = {"weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad}
    return {"global": {**{k: _rank_mean(g, mesh) for k, g in grads.items()},
                       "running_mean": bn.running_mean.clone(),
                       "running_var": bn.running_var.clone()},
            "rows": {"y": y.detach(), "x_grad": x.grad / _w(mesh)}}


def masked_means(inp, mesh):
    """The masked cross entropy and the MoL loss over rows of unequal
    lengths: rank 0's rows are long, rank 1's short."""
    b = shard_batch({k: inp[k] for k in ("ce_logits", "ce_targets", "lengths", "mol_y_hat",
                                         "mol_y")}, mesh)
    logits = b["ce_logits"].clone().requires_grad_(True)
    y_hat = b["mol_y_hat"].clone().requires_grad_(True)
    with active(mesh):
        ce = losses.masked_cross_entropy(logits, b["ce_targets"], b["lengths"])
        mol = losses.discretized_mix_logistic_loss(y_hat, b["mol_y"], num_classes=256,
                                                   lengths=b["lengths"])
    (ce + mol).backward()
    return {"global": {"ce": _rank_mean(ce, mesh), "mol": _rank_mean(mol, mesh)},
            "rows": {"ce_grad": logits.grad / _w(mesh), "mol_grad": y_hat.grad / _w(mesh)}}


def moe(inp, mesh):
    """The switch MoE's load-balance term and its gradients."""
    layer = SwitchMoE(8, 4, capacity_factor=1.25)
    layer.load_state_dict(inp["moe"])
    h = shard_batch({"h": inp["moe_h"]}, mesh)["h"]
    r = shard_batch({"r": inp["moe_r"]}, mesh)["r"]
    with active(mesh):
        y, aux = layer(h)
    (aux + torch.mean(y * r)).backward()
    out = {"aux": _rank_mean(aux, mesh)}
    out.update({f"grad/{k}": _rank_mean(p.grad, mesh) for k, p in layer.named_parameters()})
    return {"global": out, "rows": {"y": y.detach()}}


def _ema_restart(inp, mesh, num_quantizers):
    from neural_sound_generation_tpu_torch.cli.main import apply_data_codebook_init

    cfg = config(ema_codebook=True, restart_dead_threshold=1.0, ema_codebook_decay=0.9,
                 num_quantizers=num_quantizers)
    model = _vqvae(inp, num_quantizers)
    # --codebook-init data: the whole global batch on every rank, as cli.main seeds
    apply_data_codebook_init(model, inp["x"], torch.Generator().manual_seed(5))
    state = _warm(create_train_state(model, cfg.train, ema_codebook=True))
    step = make_train_step(model, cfg, mesh)
    gen = torch.Generator().manual_seed(6)
    for x in (inp["x"], inp["x2"]):
        _, m = step(state, shard_batch({"x": x}, mesh), gen)
    return {"global": {"codebook": model.codebook.detach().clone(),
                       "cluster": state.codebook_ema["cluster"].clone(),
                       "embed_sum": state.codebook_ema["embed_sum"].clone(),
                       "loss": _rank_mean(m["loss"], mesh), "flat": state.flat.flat.clone(),
                       "generator": gen.get_state()},
            "rows": {}}


def ema_restart(inp, mesh):
    """Two EMA-codebook steps with dead-code restarts after a data init."""
    return _ema_restart(inp, mesh, 1)


def ema_restart_rvq(inp, mesh):
    """The same with two residual stages."""
    return _ema_restart(inp, mesh, 2)


def vae(inp, mesh):
    """A VAE step: its noise drawn at the global batch's shape."""
    cfg = config()
    model = VAE(1, 8, 4, generator=torch.Generator().manual_seed(2))
    state = _warm(create_train_state(model, cfg.train))
    gen = torch.Generator().manual_seed(3)
    _, m = make_train_step(model, cfg, mesh)(state, shard_batch({"x": inp["img"]}, mesh), gen)
    return {"global": {"loss": _rank_mean(m["loss"], mesh), "kl": _rank_mean(m["kl"], mesh),
                       **_state_out(state)}, "rows": {}}


def multistep(inp, mesh):
    """--multi-steps 2: two data-parallel steps over a stacked super-batch."""
    cfg = config()
    model = _vqvae(inp)
    state = _warm(create_train_state(model, cfg.train))
    xs = torch.stack([shard_batch({"x": x}, mesh)["x"] for x in (inp["x"], inp["x2"])])
    _, stacked = make_multistep_train(model, cfg, 2, mesh)(state, {"x": xs})
    return {"global": {"loss": _rank_mean(stacked["loss"], mesh), **_state_out(state)},
            "rows": {}}


def host_shard(inp, mesh):
    """Each rank loads only its rank-strided rows (``loader_shard_args`` +
    ``shard_for_host``, the multi-host loader); the global batch is then
    the ranks' rows in rank order."""
    cfg = config()
    model = _vqvae(inp)
    state = _warm(create_train_state(model, cfg.train))
    n = inp["x"].shape[0]
    if mesh is None:  # the one-rank reference: the same global order
        order = [i for h in range(2) for i in shard_for_host(range(n), 2, h)]
        x = inp["x"][order]
        shard = {}
    else:
        shard = loader_shard_args()
        x = inp["x"][shard_for_host(range(n), **shard)]
    make_train_step(model, cfg, mesh)(state, {"x": x})
    return {"global": _state_out(state),
            "rows": {"shard": torch.tensor([shard.get("num_hosts", 0),
                                            shard.get("host_id", 0)])}}


def perplexity(inp, mesh):
    """The code perplexity of rows whose codes differ by rank: from the
    histogram of every rank's codes."""
    idx = shard_batch({"i": inp["codes"]}, mesh)["i"]
    with active(mesh):
        p = losses.codebook_perplexity(idx, Z_DIM)
    return {"global": {"perplexity": p}, "rows": {}}


CASES = {f.__name__: f for f in (flagship, batch_norm, masked_means, moe, ema_restart,
                                 ema_restart_rvq, vae, multistep, host_shard, perplexity)}


def main(argv) -> None:
    rank, world, work = int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    topo = distributed.initialize(f"file://{os.path.join(work, 'init')}", world, rank,
                                  device="cpu", log=None)
    assert topo == distributed.HostTopology(rank, world, 1, world), topo
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    mesh = make_mesh(n_data=world)
    out = {name: case(inp, mesh) for name, case in CASES.items()}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv)

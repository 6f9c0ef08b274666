"""The pipeline-parallel cases of ``tests/test_torch_pipeline_parallel.py``
(the transformer prior and WaveNet), and the rank process that runs them.

``python tests/torch_pp_worker.py <rank> <world> <dir>`` joins a gloo
group through ``file://<dir>/init``, reads the inputs the test wrote to
``<dir>/inputs.pt`` and runs every case of ``CASES`` on each mesh of
``MESHES[world]`` in turn (the (data 1 x pipe 4) mesh only ``P4_CASES``),
in one process group: a world of 2 lays (data 1 x pipe 2), a world of 4
lays (data 2 x pipe 2), then (data 1 x pipe 4). It writes
``<dir>/rank<r>.pt``: {mesh tag: {case: result}}. The test runs the same
case functions in its own process with ``mesh=None``: the one-rank
reference (the ``Trainer``'s step on the whole model; for the bf16
vocoder, whose pipelined stage math is JAX's and not the one-rank bf16
model's, the pipeline's step at one stage).

A case returns ``{"whole": {...}, "local": {...}}``: ``whole`` gathered
into the one-rank layout by checkpoint name (``grad/<name>`` for the flat
gradient, ``metric/<name>`` the metrics), ``local`` this rank's own
buffers. The restore case carries a checkpoint across S: each pipe-2 mesh
saves its stepped states dense, and the (data 1 x pipe 4) mesh restores
the (data 2 x pipe 2) mesh's. This file imports torch and the port, never
JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import zlib

import torch

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import TransformerPrior
from neural_sound_generation_tpu_torch.models.wavenet import WaveNet
from neural_sound_generation_tpu_torch.parallel import distributed, shard_batch
from neural_sound_generation_tpu_torch.parallel import pipeline as pp
from neural_sound_generation_tpu_torch.parallel.mesh import active
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.sharding import gather_train_state
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import _loss_fn, make_train_step

#: the prior: 32 codes, dim 32, 4 layers, 2 heads, 4 classes; 4 experts; cond channels
K, DIM, LAYERS, HEADS, CLASSES, EXPERTS, COND = 32, 32, 4, 2, 4, 4, 8
#: WaveNet: 4 layers in 2 stacks (4 for the pipe-4 mesh), R = G = S = 8, cin 8
WAVENET = dict(layers=4, stacks=2, residual_channels=8, gate_channels=8, skip_out_channels=8,
               cin_channels=8, upsample_scales=(2, 2))
MOL_OUT, QC, SPEAKERS, GIN = 30, 64, 3, 8  # 10 mixtures; mu-law classes; speakers
TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, initial_learning_rate=1e-3)
#: the meshes a launch of each world runs, in order: (n_data, n_pipe)
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
#: the cases the (1 x 4) mesh runs (4 stages of one layer each)
P4_CASES = ("float64", "prior", "prior_moe", "wavenet_s4", "restore")
#: the float64 case's families (a mesh runs those whose stacks stage over it)
F64_FAMILIES = ("prior", "prior_spatial", "wavenet", "wavenet_mulaw", "wavenet_s4")
#: the families of the restore case
SAVED = ("prior_moe", "wavenet_s4")
#: each family's batch in the inputs
BATCHES = {"prior": "codes", "prior_moe": "codes", "prior_bf16": "codes",
           "prior_spatial": "codes_cond", "wavenet": "mol", "wavenet_bf16": "mol",
           "wavenet_s4": "mol", "wavenet_mulaw": "mulaw"}


def tag(mesh) -> str:
    return "one" if mesh is None else f"d{mesh.n_data}p{mesh.n_pipe}"


def config() -> Config:
    cfg = Config()
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **TRAIN))


def make(family: str, generator=None):
    """The family's whole model (weights from ``generator``); a bf16
    vocoder is built float32, its stages computing in bf16."""
    if family.startswith("prior"):
        spatial = family == "prior_spatial"
        return TransformerPrior(
            K, DIM, LAYERS, HEADS, CLASSES, n_experts=EXPERTS if family == "prior_moe" else 0,
            spatial_cond=spatial, cond_dim=COND if spatial else 0, max_rows=8, max_cols=8,
            dtype=torch.bfloat16 if family == "prior_bf16" else torch.float32,
            generator=generator)
    if family == "wavenet_mulaw":
        return WaveNet(out_channels=QC, scalar_input=False, quantize_channels=QC,
                       gin_channels=GIN, n_speakers=SPEAKERS, generator=generator, **WAVENET)
    widths = {**WAVENET, "stacks": 4} if family == "wavenet_s4" else WAVENET
    return WaveNet(out_channels=MOL_OUT, generator=generator, **widths)


def weights_of(family: str) -> str:
    """The inputs' state_dict a family loads (the bf16 families their f32
    one's)."""
    return family.removesuffix("_bf16")


def build(inp, family: str):
    model = make(family)
    model.load_state_dict(inp[weights_of(family)])
    return model


def batch(inp, family: str) -> dict:
    return dict(inp[f"{BATCHES[family]}_batch"])


def warm(state):
    """Warm Adam moments (count 100; m and v drawn for each parameter from a
    seed of its name, so a stage draws its layers' as one rank does), so
    that an update is a smooth function of the gradient."""
    with torch.no_grad():
        state.step.fill_(100)
        state.opt_state.count.fill_(100)
        m = state.opt_state.named_moments(state.flat, "m")
        v = state.opt_state.named_moments(state.flat, "v")
        for name in m:
            gen = torch.Generator().manual_seed(zlib.crc32(name.encode()))
            m[name].copy_(1e-3 * torch.randn(m[name].shape, generator=gen))
            v[name].copy_(torch.empty(v[name].shape).uniform_(1e-6, 1e-5, generator=gen))
    return state


def one_rank(family: str, mesh) -> bool:
    """Whether the case runs the one-rank ``Trainer`` step (no mesh, and a
    family whose pipelined math is the whole model's)."""
    return mesh is None and family != "wavenet_bf16"


def fresh_state(inp, family: str, mesh):
    """This rank's state of the family's model: the whole one, or its stage."""
    model, cfg = build(inp, family), config()
    if one_rank(family, mesh):
        return model, create_train_state(model, cfg.train)
    dtype = torch.bfloat16 if family == "wavenet_bf16" else None
    return model, pp.place_stage(model, cfg.train, mesh, torch.device("cpu"), dtype)


def step_fn(model, family: str, mesh):
    cfg = config()
    if one_rank(family, mesh):
        return lambda state, b: make_train_step(model, cfg)(state, b)[1]
    n_micro = 1 if mesh is None else mesh.n_pipe
    if family.startswith("prior"):
        return pp.make_pp_prior_train_step(model, mesh, n_micro)
    return pp.make_pp_wavenet_train_step(model, cfg, mesh, n_micro,
                                         bf16=family == "wavenet_bf16")


def rank_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.detach().clone().float()
    return t if mesh is None else mesh.mean_(t)


def whole(state) -> dict:
    """The state and the flat gradient, dense, by checkpoint name."""
    out = {k: t.detach().clone() for k, t in gather_train_state(state).items()}
    grads = {f"params/{k}": g for k, g in state.flat.named(state.flat.grad).items()}
    if state.shards is not None:
        grads = state.shards.gather_tensors(grads)
    out.update({f"grad/{k[len('params/'):]}": g.clone() for k, g in grads.items()})
    return out


def local(state, mesh) -> dict:
    flat = state.flat
    coord = (0, 0) if mesh is None else (mesh.data_rank, mesh.stage)
    vectors = [flat.flat, *state.opt_state.moments()]
    if state.ema_params is not None:
        vectors.append(state.ema_params)
    cut = flat.split_at
    return {"flat": flat.flat.clone(), "grad": flat.grad.clone(),
            "all": torch.cat([v.reshape(-1).float() for v in vectors]),
            "rest": torch.cat([v[cut:].reshape(-1).float() for v in vectors]),
            "split_at": torch.tensor(cut), "coord": torch.tensor(coord)}


def _step(inp, mesh, family: str):
    """One train step from warm moments: (model, state, result)."""
    model, state = fresh_state(inp, family, mesh)
    warm(state)
    run = step_fn(model, family, mesh)
    m = run(state, shard_batch(batch(inp, family), mesh))
    out = {f"metric/{k}": rank_mean(v, mesh) for k, v in m.items()}
    out.update(whole(state))
    loc = local(state, mesh)
    if hasattr(run, "handoff_bytes"):
        loc["handoff_bytes"] = torch.tensor(run.handoff_bytes)
    return model, state, {"whole": out, "local": loc}


def _case(family):
    def case(inp, mesh):
        return _step(inp, mesh, family)[2]

    case.__name__ = family
    case.__doc__ = f"One warm-moment train step of {family}."
    return case


def _attention64(q, k, v, scale):
    """Causal softmax attention in the inputs' dtype (the port's attention
    pair computes in float32 at most)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    mask = torch.ones(q.shape[2], q.shape[2], dtype=torch.bool).tril()
    return torch.matmul(torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1), v)


def float64(inp, mesh):
    """The loss and gradient of the dense, the spatially conditioned prior
    and the MoL (2 and 4 stacks) and speaker vocoders in float64, outside
    the train step:
    the pipeline's arithmetic (microbatches, the hand-offs, the pipe-sum of
    the rest) without float32's rounding, so its gradient is the one-rank
    one to the last digits. The prior's attention is a float64 softmax
    here, on both sides (the kernel and its plain pair take float32 or
    bfloat16)."""
    from neural_sound_generation_tpu_torch.models import transformer_prior

    saved = transformer_prior.causal_attention
    transformer_prior.causal_attention = _attention64
    try:
        return _float64(inp, mesh)
    finally:
        transformer_prior.causal_attention = saved


def _float64(inp, mesh):
    out = {}
    for family in F64_FAMILIES:
        model = build(inp, family).double()
        if mesh is not None and isinstance(model, WaveNet) and model.stacks % mesh.n_pipe:
            continue
        for mod in model.modules():
            if hasattr(mod, "compute_dtype"):
                mod.compute_dtype = torch.float64
        b = {k: v.double() if v.is_floating_point() else v
             for k, v in shard_batch(batch(inp, family), mesh).items()}
        if mesh is None:
            loss = _loss_fn(model, config())(b, None)[0]
            loss.backward()
        else:
            stage = pp.Stage.of(mesh)
            if family.startswith("prior"):
                pp.pp_prior_partition(model, stage)
                run = pp.make_pp_prior_train_step(model, mesh, mesh.n_pipe)
            else:
                pp.pp_wavenet_partition(model, stage)
                run = pp.make_pp_wavenet_train_step(model, config(), mesh, mesh.n_pipe)
            with active(mesh):
                loss = run.forward_backward(b)["loss"].double()
            mesh.pipe_all_reduce_(loss)
            mesh.mean_(loss)
        grads = {f"params/{k}": torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in model.named_parameters()}
        if mesh is not None:
            for k, g in grads.items():
                if not pp._layer_re(model).match(k[len("params/"):]):
                    mesh.pipe_all_reduce_(g)
                mesh.mean_(g)
            grads = pp.PipeShards(mesh, model).gather_tensors(grads)
        out[f"f64/{family}/loss"] = loss.detach().double()
        out.update({f"f64/{family}/{k}": g for k, g in grads.items()})
    return {"whole": out, "local": {}}


def restore(inp, mesh):
    """The one-rank checkpoints (written by the test) restored into fresh
    stage states, and the S-2 states after a step (``stepped``, gathered)
    saved dense (rank 0 writes the gathered tree) for the test to restore
    at S 1 and for the pipe-4 mesh of the same launch to restore here."""
    out = {}
    for family in SAVED:
        sources = {"restored": inp[f"ckpt_one_{family}"]}
        if mesh is not None and mesh.n_pipe == 4:
            sources["from_p2"] = os.path.join(inp["work"], f"ckpt_d2p2_{family}")
        for kind, src in sources.items():
            _, state = fresh_state(inp, family, mesh)
            checkpoint.restore(src, state)
            out.update({f"{kind}/{family}/{k}": t for k, t in whole(state).items()
                        if not k.startswith("grad/")})
        if mesh is not None and mesh.n_pipe == 2:
            _, stepped, result = _step(inp, mesh, family)
            out.update({f"stepped/{family}/{k}": t for k, t in result["whole"].items()
                        if not k.startswith(("grad/", "metric/"))})
            checkpoint.save(os.path.join(inp["work"], f"ckpt_{tag(mesh)}_{family}"), stepped,
                            step=101, block=True)
            distributed.barrier()
    return {"whole": out, "local": {}}


CASES = {f.__name__: f for f in (
    float64, *(_case(f) for f in ("prior", "prior_moe", "prior_spatial", "prior_bf16",
                                  "wavenet", "wavenet_mulaw", "wavenet_bf16", "wavenet_s4")),
    restore)}


def main(argv) -> None:
    rank, world, work = int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    distributed.initialize(f"file://{os.path.join(work, 'init')}", world, rank, device="cpu",
                           log=None)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    inp["work"] = work
    out = {}
    for n_data, n_pipe in MESHES[world]:
        mesh = pp.make_pp_mesh(n_pipe, n_data)
        out[tag(mesh)] = {name: case(inp, mesh) for name, case in CASES.items()
                          if name in P4_CASES or n_pipe != 4 and name != "wavenet_s4"}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv)

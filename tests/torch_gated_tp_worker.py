"""The tensor-parallel cases of ``tests/test_torch_gated_model_parallel.py``
(WaveNet and the GatedPixelCNN), and the rank process that runs them.

``python tests/torch_gated_tp_worker.py <rank> <world> <dir>`` joins a
gloo group through ``file://<dir>/init``, reads the inputs the test wrote
to ``<dir>/inputs.pt`` and runs every case of ``CASES`` on each mesh of
``MESHES[world]`` in turn (the (data 1 x model 4) mesh all but
``M4_SKIPS``), in one process group: a world of 2 lays (data 1 x model
2), a world of 4 lays (data 2 x model 2), then (data 1 x model 4). It
writes ``<dir>/rank<r>.pt``: {mesh tag: {case: result}}. The test runs the
same case functions in its own process with ``mesh=None``: the one-rank
reference each rank's result is held against.

A case returns ``{"whole": {...}, "local": {...}}`` as
``torch_tp_worker``'s do: ``whole`` gathered into the one-rank layout,
``local`` this rank's own buffers. The restore case carries a checkpoint
across M: each M-2 mesh saves its stepped states whole, and the (data 1 x
model 4) mesh restores the (data 2 x model 2) mesh's. This file imports
torch and the port, never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

from torch_tp_worker import local, place, rank_mean, warm, whole

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import GatedPixelCNN
from neural_sound_generation_tpu_torch.models.wavenet import WaveNet
from neural_sound_generation_tpu_torch.parallel import distributed, make_mesh, shard_batch
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.sharding import _slice
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import (
    make_eval_step,
    make_multistep_train,
    make_train_step,
)

#: WaveNet: 4 layers in 2 stacks, R = G = S = 16, cin 8, two x2 upsamplers
WAVENET = dict(layers=4, stacks=2, residual_channels=16, gate_channels=16,
               skip_out_channels=16, cin_channels=8, upsample_scales=(2, 2))
MOL_OUT, QC, SPEAKERS, GIN = 30, 64, 3, 8  # 10 mixtures; mu-law classes; speakers
NARROW_GATE = 4  # gate halves of 2: whole at M 4
ODD_SKIP = 6  # skip_i and post1 whole at M 4 while the gates split
#: the PixelCNN: 32 codes, dim 16, 3 layers, 4 classes; its map's channels
K, DIM, LAYERS, CLASSES, COND = 32, 16, 3, 4, 8
TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, initial_learning_rate=1e-3)
#: the meshes a launch of each world runs, in order: (n_data, n_model)
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
#: the cases the (1 x 4) mesh leaves to the others (the bf16 and multi-step
#: paths do not depend on M), to keep the file's time down
M4_SKIPS = ("wavenet_bf16", "pixelcnn_bf16", "multistep")
#: the families of the restore case
SAVED = ("wavenet_mulaw", "pixelcnn_spatial")
#: each family's batch in the inputs
BATCHES = {"wavenet": "mol", "wavenet_narrow": "mol", "wavenet_bf16": "mol", "wavenet_skip6": "mol",
           "wavenet_mulaw": "mulaw", "pixelcnn": "codes", "pixelcnn_bf16": "codes",
           "pixelcnn_spatial": "codes_cond"}


def tag(mesh) -> str:
    return "one" if mesh is None else f"d{mesh.n_data}m{mesh.n_model}"


def config() -> Config:
    cfg = Config()
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **TRAIN))


def make(family: str, generator=None):
    """The family's whole model (weights from ``generator``)."""
    dtype = torch.bfloat16 if family.endswith("_bf16") else torch.float32
    if family.startswith("pixelcnn"):
        spatial = family == "pixelcnn_spatial"
        return GatedPixelCNN(K, DIM, LAYERS, CLASSES, spatial_cond=spatial,
                             cond_dim=COND if spatial else 0, dtype=dtype, generator=generator)
    if family == "wavenet_mulaw":
        return WaveNet(out_channels=QC, scalar_input=False, quantize_channels=QC,
                       gin_channels=GIN, n_speakers=SPEAKERS, generator=generator, **WAVENET)
    widths = {"wavenet_narrow": {**WAVENET, "gate_channels": NARROW_GATE},
              "wavenet_skip6": {**WAVENET, "skip_out_channels": ODD_SKIP}}.get(family, WAVENET)
    return WaveNet(out_channels=MOL_OUT, generator=generator, dtype=dtype, **widths)


def build(inp, family: str):
    """The family's whole model with the test's weights (its
    ``state_dict`` in the inputs; a bf16 family takes its f32 one's)."""
    model = make(family)
    model.load_state_dict(inp[family.removesuffix("_bf16")])
    return model


def batch(inp, family: str, second: bool = False) -> dict:
    """The family's global batch (its second one with ``second``)."""
    return dict(inp[f"{BATCHES[family]}_batch{'2' if second else ''}"])


def fresh_state(inp, family: str, mesh):
    """This rank's share of a fresh state of the family's model."""
    return place(create_train_state(build(inp, family), config().train), mesh)


def _steps(inp, mesh, family: str, steps: int = 1, multi: bool = False):
    """``steps`` train steps of ``family`` from warm moments, one batch
    each (or one ``make_multistep_train`` call over both batches):
    (model, cfg, state, result)."""
    model, cfg = build(inp, family), config()
    state = place(warm(create_train_state(model, cfg.train)), mesh)
    batches = [shard_batch(batch(inp, family, i == 1), mesh) for i in range(2)]
    if multi:
        stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        _, m = make_multistep_train(model, cfg, 2, mesh)(state, stacked)
        m = {"loss": m["loss"]}
    else:
        step = make_train_step(model, cfg, mesh)
        for b in batches[:steps]:
            _, m = step(state, b)
    out = {f"metric/{k}": rank_mean(v, mesh) for k, v in m.items()}
    out.update(whole(state))
    return model, cfg, state, {"whole": out, "local": local(state, mesh)}


def _with_eval(inp, mesh, family: str):
    """One train step, then the eval step on the same batch."""
    model, cfg, state, out = _steps(inp, mesh, family)
    _, em = make_eval_step(model, cfg, mesh)(state, shard_batch(batch(inp, family), mesh))
    out["whole"].update({f"eval/{k}": rank_mean(v, mesh) for k, v in em.items()})
    return out


def wavenet(inp, mesh):
    """The mel-conditioned MoL vocoder: a step and an eval step; every gate
    split block-wise, ``post2`` (30 channels) whole at M 4."""
    return _with_eval(inp, mesh, "wavenet")


def wavenet_mulaw(inp, mesh):
    """mulaw-quantize with speakers: a step through the embedded input and
    the whole ``speaker_embed`` and ``g_i``, whose terms each rank slices."""
    return _steps(inp, mesh, "wavenet_mulaw")[3]


def wavenet_narrow(inp, mesh):
    """``gate_channels`` 4: halves of 2, split at M 2, whole at M 4."""
    return _steps(inp, mesh, "wavenet_narrow")[3]


def wavenet_bf16(inp, mesh):
    """The vocoder under ``--bf16``: its convolutions and gathers in
    bfloat16."""
    return _steps(inp, mesh, "wavenet_bf16")[3]


def pixelcnn(inp, mesh):
    """The class-conditioned PixelCNN: a step and an eval step."""
    return _with_eval(inp, mesh, "pixelcnn")


def pixelcnn_spatial(inp, mesh):
    """The spatially conditioned (bottom-level) PixelCNN: ``spatial_cond``
    split block-wise with the gates."""
    return _steps(inp, mesh, "pixelcnn_spatial")[3]


def pixelcnn_bf16(inp, mesh):
    """The PixelCNN under ``--bf16``."""
    return _steps(inp, mesh, "pixelcnn_bf16")[3]


def multistep(inp, mesh):
    """--multi-steps 2 of the MoL vocoder over a stacked super-batch."""
    return _steps(inp, mesh, "wavenet", multi=True)[3]


def gather(inp, mesh):
    """The grouped gather of every rank's slice (``sharding._slice`` with
    groups 2) of a (2, 24, 3) tensor, on dim 1 and on the last dim: the
    whole tensor forward; backward this rank's slice of the upstream
    gradient, gathered again to the whole."""
    out = {}
    for name, dim in (("channels", 1), ("last", -1)):
        x, grad = inp["gather_x"], inp["gather_grad"]
        if dim == -1:
            x, grad = x.transpose(1, 2), grad.transpose(1, 2)
        if mesh is not None:
            mine = _slice(x, dim % x.dim(), mesh.model_rank, mesh.n_model, groups=2)
            mine.requires_grad_()
            x = mesh.gather_channels(mine, dim=dim, groups=2)
            x.backward(grad)
            grad = mesh.gather_channels(mine.grad, dim=dim, groups=2)
        out[f"gather/{name}"], out[f"gather/{name}_backward"] = x.detach(), grad
    return {"whole": out, "local": {}}


def float64(inp, mesh):
    """The loss and gradient of the MoL vocoder, the speaker vocoder, the
    spatial PixelCNN, and a vocoder whose skip_i stay whole at M 4 while
    its gates split (seeded weights), in float64, outside the train step:
    the model axis's arithmetic without float32's rounding, so its
    gradient is the one-rank one to the last digits."""
    from neural_sound_generation_tpu_torch.parallel.mesh import active
    from neural_sound_generation_tpu_torch.training.sharding import (
        ModelShards,
        _shard_module,
        tensor_parallel_layout,
    )
    from neural_sound_generation_tpu_torch.training.trainer import _loss_fn

    out = {}
    for family in ("wavenet", "wavenet_mulaw", "pixelcnn_spatial", "wavenet_skip6"):
        model = (make(family, torch.Generator().manual_seed(7)) if family not in inp
                 else build(inp, family)).double()
        for m in model.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
        shards = None
        if mesh is not None:
            layout = tensor_parallel_layout(model, mesh.n_model)
            _shard_module(model, layout, mesh.model_rank, mesh.n_model)
            shards = ModelShards(mesh, layout)
        b = {k: v.double() if v.is_floating_point() else v
             for k, v in shard_batch(batch(inp, family), mesh).items()}
        with active(mesh):
            loss = _loss_fn(model, config())(b, None)[0]
            loss.backward()
        grads = {f"params/{k}": torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in model.named_parameters()}
        if shards is not None:
            grads = shards.gather_tensors(grads)
            mesh.mean_(loss := loss.detach().clone())
            for g in grads.values():
                mesh.mean_(g)
        out[f"f64/{family}/loss"] = loss.detach()
        out.update({f"f64/{family}/{k}": g for k, g in grads.items()})
    return {"whole": out, "local": {}}


def restore(inp, mesh):
    """The one-rank checkpoints (written by the test) restored into fresh
    sharded states; at M 2 the stepped states saved whole (rank 0 writes
    the gathered tree) for the test to restore at M 1 and for the M 4 mesh
    of the same launch to restore here."""
    out = {}
    for family in SAVED:
        sources = {"restored": inp[f"ckpt_m1_{family}"]}
        if mesh is not None and mesh.n_model == 4:
            sources["from_m2"] = os.path.join(inp["work"], f"ckpt_d2m2_{family}")
        for kind, src in sources.items():
            state = fresh_state(inp, family, mesh)
            checkpoint.restore(src, state)
            out.update({f"{kind}/{family}/{k}": t for k, t in whole(state).items()
                        if not k.startswith("grad/")})
        if mesh is not None and mesh.n_model == 2:
            _, _, stepped, _ = _steps(inp, mesh, family)
            checkpoint.save(os.path.join(inp["work"], f"ckpt_{tag(mesh)}_{family}"), stepped,
                            step=101, block=True)
            distributed.barrier()
    return {"whole": out, "local": {}}


CASES = {f.__name__: f for f in (gather, float64, wavenet, wavenet_mulaw, wavenet_narrow,
                                 wavenet_bf16, pixelcnn, pixelcnn_spatial, pixelcnn_bf16, multistep,
                                 restore)}


def main(argv) -> None:
    rank, world, work = int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    distributed.initialize(f"file://{os.path.join(work, 'init')}", world, rank, device="cpu",
                           log=None)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    inp["work"] = work
    out = {}
    for n_data, n_model in MESHES[world]:
        mesh = make_mesh(n_data=n_data, n_model=n_model)
        out[tag(mesh)] = {name: case(inp, mesh) for name, case in CASES.items()
                          if n_model != 4 or name not in M4_SKIPS}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    distributed.barrier()
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv)

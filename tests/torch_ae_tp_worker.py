"""The tensor-parallel cases of ``tests/test_torch_autoencoder_model_parallel.py``
(HierVQVAE, WaveVQVAE, the VAE), and the rank process that runs them.

``python tests/torch_ae_tp_worker.py <rank> <world> <dir>`` joins a gloo
group through ``file://<dir>/init``, reads the inputs the test wrote to
``<dir>/inputs.pt`` and runs every case of ``CASES`` on each mesh of
``MESHES[world]`` in turn (the (data 1 x model 4) mesh all but
``M4_SKIPS``), in one process group: a world of 2 lays (data 1 x model
2), a world of 4 lays (data 2 x model 2), then (data 1 x model 4).
It writes ``<dir>/rank<r>.pt``: {mesh tag: {case: result}}. The test runs
the same case functions in its own process with ``mesh=None``: the
one-rank reference each rank's result is held against.

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

from neural_sound_generation_tpu_torch.cli.main import apply_data_codebook_init
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import VAE, HierVQVAE, WaveVQVAE
from neural_sound_generation_tpu_torch.models import vae as vae_mod
from neural_sound_generation_tpu_torch.parallel import distributed, make_mesh, shard_batch
from neural_sound_generation_tpu_torch.parallel.mesh import active
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import (
    make_eval_step,
    make_multistep_train,
    make_train_step,
)

DIM, Z_DIM = 32, 64
DOWN, QC, VAE_Z = 3, 64, 8  # the wave model's stride-2 layers and mu-law classes; VAE latents
SPEAKERS, GIN = 3, 8
TRAIN = dict(clip_thresh=1.0, weight_decay=1e-4, ema_decay=0.95, initial_learning_rate=1e-3)
#: the meshes a launch of each world runs, in order: (n_data, n_model)
MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
#: the cases the (1 x 4) mesh leaves to the others (the bf16, multi-step
#: and noise paths do not depend on M), to keep the file's time down
M4_SKIPS = ("hier_bf16", "multistep", "vae_noise")
#: the families of the restore case, by checkpoint metadata
SAVED = {"hier": {"arch": "hiervqvae", "num_quantizers": 1},
         "wave_mulaw": {"arch": "wavevqvae", "num_quantizers": 2}}
EMA_FAMILIES = ("wave_mulaw",)


def tag(mesh) -> str:
    return "one" if mesh is None else f"d{mesh.n_data}m{mesh.n_model}"


def config(**model) -> Config:
    cfg = Config()
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **TRAIN),
        model=dataclasses.replace(cfg.model, dim=DIM, z_dim=Z_DIM, beta=0.25, **model))


#: the EMA-codebook run's model flags
EMA = dict(ema_codebook=True, restart_dead_threshold=1.0, ema_codebook_decay=0.9,
           num_quantizers=2)
#: each family's batch in the inputs and the keys its steps take
BATCHES = {"hier": ("hier", ("x",)), "hier_group": ("hier", ("x",)), "hier_bf16": ("hier", ("x",)),
           "wave_raw": ("wave", ("x",)), "wave_speaker": ("wave", ("x", "g")),
           "wave_mulaw": ("mulaw", ("x", "input_lengths")), "vae": ("vae", ("x",))}


def build(inp, family: str):
    """The family's whole model with the test's weights (its
    ``state_dict`` in the inputs)."""
    if family in ("hier", "hier_group", "hier_bf16"):
        model = HierVQVAE(1, DIM, Z_DIM, norm="group" if family == "hier_group" else "batch",
                          dtype=torch.bfloat16 if family == "hier_bf16" else torch.float32)
    elif family == "vae":
        model = VAE(1, DIM, VAE_Z)
    elif family == "wave_mulaw":
        model = WaveVQVAE(DIM, Z_DIM, DOWN, input_type="mulaw-quantize", quantize_channels=QC,
                          num_quantizers=2)
    elif family == "wave_speaker":
        model = WaveVQVAE(DIM, Z_DIM, DOWN, n_speakers=SPEAKERS, gin_channels=GIN)
    else:
        model = WaveVQVAE(DIM, Z_DIM, DOWN)
    model.load_state_dict(inp["hier" if family == "hier_bf16" else family])
    return model


def batch(inp, family: str, second: bool = False) -> dict:
    """The family's global batch (its second one with ``second``)."""
    name, keys = BATCHES[family]
    src = inp[f"{name}_batch{'2' if second else ''}"]
    return {k: src[k] for k in keys}


def fresh_state(inp, family: str, mesh):
    """This rank's share of a fresh state of the family's model."""
    ema = family in EMA_FAMILIES
    cfg = config(**(EMA if ema else {}))
    return place(create_train_state(build(inp, family), cfg.train, ema_codebook=ema), mesh)


def _steps(inp, mesh, family: str, steps: int = 1, multi: bool = False):
    """``steps`` train steps of ``family`` from warm moments (a data-init
    codebook first for the EMA run, as ``cli.main`` seeds it before
    sharding), one batch each (or one ``make_multistep_train`` call over
    both batches): (model, cfg, state, result)."""
    model, ema = build(inp, family), family in EMA_FAMILIES
    cfg = config(**(EMA if ema else {}))
    if ema:
        apply_data_codebook_init(model, inp["mulaw_batch"]["x"], torch.Generator().manual_seed(5))
    state = place(warm(create_train_state(model, cfg.train, ema_codebook=ema)), mesh)
    gen = torch.Generator().manual_seed(6)
    batches = [shard_batch(batch(inp, family, i == 1), mesh) for i in range(2)]
    if multi:
        stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
        _, m = make_multistep_train(model, cfg, 2, mesh)(state, stacked, gen)
        m = {"loss": m["loss"]}
    else:
        step = make_train_step(model, cfg, mesh)
        for b in batches[:steps]:
            _, m = step(state, b, gen)
    out = {f"metric/{k}": rank_mean(v, mesh) for k, v in m.items()}
    if ema:
        out["generator"] = gen.get_state()
    out.update(whole(state))
    return model, cfg, state, {"whole": out, "local": local(state, mesh)}


def _with_eval(inp, mesh, family: str):
    """One train step, then the eval step on the same batch."""
    model, cfg, state, out = _steps(inp, mesh, family)
    _, em = make_eval_step(model, cfg, mesh)(state, shard_batch(batch(inp, family), mesh))
    out["whole"].update({f"eval/{k}": rank_mean(v, mesh) for k, v in em.items()})
    return out


def hier(inp, mesh):
    """The HierVQVAE (batch norm): a step and an eval step; the decoder
    and both codebooks split."""
    return _with_eval(inp, mesh, "hier")


def hier_group(inp, mesh):
    """The HierVQVAE under ``--norm group``: groups of 8 within a rank."""
    return _steps(inp, mesh, "hier_group")[3]


def hier_bf16(inp, mesh):
    """The HierVQVAE under ``--bf16``: its convolutions and the gathers in
    bfloat16."""
    return _steps(inp, mesh, "hier_bf16")[3]


def wave_raw(inp, mesh):
    """The raw WaveVQVAE: a step and an eval step; ``decoder.out`` (one
    channel) whole."""
    return _with_eval(inp, mesh, "wave_raw")


def wave_mulaw(inp, mesh):
    """mulaw-quantize, residual VQ of 2 stages, EMA codebooks with
    restarts: two steps; the logits split and gathered before the loss."""
    return _steps(inp, mesh, "wave_mulaw", steps=2)[3]


def wave_speaker(inp, mesh):
    """A speaker-conditioned raw WaveVQVAE: the embedding and its
    projection whole on every rank."""
    return _steps(inp, mesh, "wave_speaker")[3]


def vae(inp, mesh):
    """The conv VAE: nothing split; a step with the step's noise and an
    eval step."""
    return _with_eval(inp, mesh, "vae")


def multistep(inp, mesh):
    """--multi-steps 2 of the raw WaveVQVAE over a stacked super-batch."""
    return _steps(inp, mesh, "wave_raw", multi=True)[3]


def vae_noise(inp, mesh):
    """The VAE's train noise: the global batch's draw, each data rank's
    rows, the same on every rank of a model group."""
    n = inp["vae_batch"]["x"].shape[0] // (1 if mesh is None else mesh.n_data)
    like = torch.zeros(n, VAE_Z, 1, 1)
    with active(mesh):
        eps = vae_mod._train_noise(VAE(1, DIM, VAE_Z), like, torch.Generator().manual_seed(3))
    coord = (0, 0) if mesh is None else (mesh.data_rank, mesh.model_rank)
    return {"whole": {"noise": eps if mesh is None else mesh.gather_rows(eps)},
            "local": {"noise": eps, "coord": torch.tensor(coord)}}


def restore(inp, mesh):
    """The one-rank checkpoints (written by the test) restored into fresh
    sharded states; at M 2 the stepped states saved whole (rank 0 writes
    the gathered tree) for the test to restore at M 1 and for the M 4 mesh
    of the same launch to restore here."""
    out = {}
    for family, meta in SAVED.items():
        sources = {"restored": inp[f"ckpt_m1_{family}"]}
        if mesh is not None and mesh.n_model == 4:
            sources["from_m2"] = os.path.join(inp["work"], f"ckpt_d2m2_{family}")
        for kind, src in sources.items():
            state = fresh_state(inp, family, mesh)
            checkpoint.restore(src, state)
            out.update({f"{kind}/{family}/{k}": t for k, t in whole(state).items()
                        if not k.startswith("grad/")})
        if mesh is not None and mesh.n_model == 2:
            _, _, stepped, _ = _steps(inp, mesh, family, steps=2 if family in EMA_FAMILIES else 1)
            checkpoint.save(os.path.join(inp["work"], f"ckpt_{tag(mesh)}_{family}"), stepped,
                            step=101, extra=meta, block=True)
            distributed.barrier()
    return {"whole": out, "local": {}}


CASES = {f.__name__: f for f in (hier, hier_group, hier_bf16, wave_raw, wave_mulaw, wave_speaker,
                                 vae, multistep, vae_noise, restore)}


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

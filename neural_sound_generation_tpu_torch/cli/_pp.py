"""The pipeline-parallel training lifecycle shared by ``cli.prior train``
and ``cli.vocoder train`` under ``--mesh-pipe``.

Counterpart of ``neural_sound_generation_tpu/cli/_pp.py``
(``validate_pp_mesh``, ``run_pp_training``), in the port's checkpoint
format: the mesh's checks with JAX's messages, the resume from the
``<ckpt>_pp_train`` sibling (any pipe width) or from the artifact (Adam's
moments restart, the EMA from the ``<ckpt>_ema`` sibling or the resumed
parameters), the epoch loop of ``parallel.pipeline.PipelineStep``s (one
step a batch: ``--multi-steps`` is accepted and runs one step a batch, as
JAX's PP path does) and the dense export. Every save writes, gathered over
the pipe group for rank 0 (``parallel.pipeline.PipeShards``):

  * the artifact at ``--ckpt-dir`` (parameters only), the layout that
    ``cli.prior sample``, ``cli.vocoder synthesize`` and ``serve`` restore
    on one rank;
  * ``<ckpt>_ema``, the averaged model in the same layout, ``averaged:
    True``;
  * ``<ckpt>_pp_train``, the dense parameters, moments and EMA, which
    ``--resume`` restores at any pipe width. It has a name of its own, as
    in JAX: a one-rank run's ``_train`` sibling is not read here, and a run
    under the pipe resumes from the one-rank artifact instead.

``checkpoint_interval`` saves inside epoch N record ``epoch`` N - 1, so a
preempted run replays epoch N with its data order.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import torch

from neural_sound_generation_tpu_torch.data.pipeline import device_prefetch
from neural_sound_generation_tpu_torch.parallel.mesh import Mesh
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import TrainState


def validate_pp_mesh(n_pipe: int, n_data: int, n_micro: int, batch_size: int,
                     world: int) -> None:
    """The pipe run's misconfigurations as SystemExits with JAX's
    messages: the microbatches must divide the batch, each microbatch's
    rows the data axis, and the world must be D x S ranks."""
    if n_micro < 1 or batch_size % n_micro:
        raise SystemExit(f"--pp-microbatches {n_micro} must divide --batch-size {batch_size}")
    if (batch_size // n_micro) % n_data:
        raise SystemExit(
            f"microbatch size {batch_size // n_micro} (--batch-size {batch_size} / "
            f"--pp-microbatches {n_micro}) must divide over --mesh-data {n_data} (the "
            f"microbatch axis is data-sharded)")
    if n_data * n_pipe != world:
        raise SystemExit(
            f"mesh {n_data}x{n_pipe} needs {n_data * n_pipe} ranks, have {world}: launch "
            f"torchrun --nproc_per_node {n_data * n_pipe} -m ...")


def pp_mesh(args) -> tuple[Optional[Mesh], int]:
    """(the (D, S) mesh of the CLI's flags, M): S ``--mesh-pipe``, D
    ``--mesh-data`` or else world / S, M ``--pp-microbatches`` or else S;
    ``validate_pp_mesh``'s SystemExits first."""
    from neural_sound_generation_tpu_torch.parallel import distributed
    from neural_sound_generation_tpu_torch.parallel.pipeline import make_pp_mesh

    world, n_pipe = distributed.world_size(), args.mesh_pipe
    n_data = args.mesh_data or max(1, world // n_pipe)
    n_micro = args.pp_microbatches or n_pipe
    validate_pp_mesh(n_pipe, n_data, n_micro, args.batch_size, world)
    return make_pp_mesh(n_pipe, n_data), n_micro


def refuse_model_and_pipe(args) -> None:
    """``--mesh-model`` with ``--mesh-pipe``: JAX's pipe path lays a (data,
    pipe) mesh and ignores the model axis; the port refuses to run another
    mesh than the one asked for."""
    if getattr(args, "mesh_model", 1) > 1 and getattr(args, "mesh_pipe", 1) > 1:
        raise SystemExit(
            f"--mesh-model {args.mesh_model} with --mesh-pipe {args.mesh_pipe}: a mesh has a "
            f"model axis or a pipe axis, not both")


def _pull(sums: dict, count: int, mesh: Optional[Mesh]) -> dict:
    """Host means of summed metrics, averaged over the data group (the
    pipe group's are already the same on every stage)."""
    if not sums:
        return {}
    keys = sorted(sums)
    values = torch.stack([sums[k].float() for k in keys])
    if mesh is not None:
        mesh.mean_(values)
    return {k: v / max(count, 1) for k, v in zip(keys, values.cpu().tolist())}


def run_pp_training(
    *,
    ckpt_dir: str,
    resume: bool,
    epochs: int,
    mesh: Optional[Mesh],
    n_micro: int,
    checkpoint_interval: int,
    set_epoch: Callable[[int], None],
    epoch_batches: Callable[[], Iterable[dict]],
    state: TrainState,
    step_fn: Callable,
    kind: str,
    epoch_line: Callable[[int, dict], str],
    meta: dict,
    say=print,
) -> None:
    """The lifecycle of the module docstring over ``state`` (this rank's
    stage, ``parallel.pipeline.place_stage``) and ``step_fn`` (its
    ``PipelineStep``). ``meta`` goes into every save's ``extra`` and a
    resume refuses a checkpoint that recorded other values of it."""
    n_pipe = 1 if mesh is None else mesh.n_pipe
    n_data = 1 if mesh is None else mesh.n_data
    device = state.flat.flat.device
    say(f"pp {kind}: dp{n_data}xpp{n_pipe}, {n_micro} microbatches"
        + ("" if state.ema_params is not None else "; EMA off: no *_ema artifact"))
    train_dir = ckpt_dir.rstrip("/") + "_pp_train"
    start_epoch = 1
    if resume:
        try:
            if checkpoint.latest_step(train_dir) is not None:
                checkpoint.check_extra(train_dir, **meta)
                _, extra = checkpoint.restore(train_dir, state)
                start_epoch = int((extra or {}).get("epoch", 0)) + 1
                say(f"resumed pp train state from step {int(state.step)}, epoch {start_epoch} "
                    f"(mesh dp{n_data}xpp{n_pipe})")
            elif checkpoint.latest_step(ckpt_dir) is not None:
                at = checkpoint.latest_step(ckpt_dir)
                checkpoint.check_extra(ckpt_dir, **meta)
                extra = checkpoint.restore_params(ckpt_dir, state.model)
                state.step.fill_(at)
                if state.ema_params is not None:
                    # the shadow starts at the resumed parameters, unless a
                    # dense run's _ema sibling carries it
                    state.ema_params.copy_(state.flat.flat)
                checkpoint.restore_ema_sibling(ckpt_dir, state)
                start_epoch = int((extra or {}).get("epoch", 0)) + 1
                say(f"resumed params from step {at}, epoch {start_epoch} (no *_pp_train "
                    f"sibling: Adam moments restart)")
        except ValueError as e:
            raise SystemExit(str(e)) from e
    if mesh is not None:
        mesh.replicate(state)

    def save(completed_epoch: int) -> None:
        # completed_epoch is the last FINISHED epoch: an interval save inside
        # epoch N stores N - 1, so --resume replays epoch N with its data order
        extra = {"epoch": completed_epoch, **meta}
        step = int(state.step)
        checkpoint.save_params(ckpt_dir, state.model, step, extra, shards=state.shards)
        checkpoint.save_ema_sibling(ckpt_dir, state, step, extra)
        checkpoint.save(train_dir, state, step, extra, block=False)

    step_now = int(state.step)
    for epoch in range(start_epoch, epochs + 1):
        # the data order is f(seed, epoch): --resume replays what an
        # uninterrupted run's epoch N would see
        set_epoch(epoch - 1)
        sums: Optional[dict] = None
        count = 0
        for batch in device_prefetch(epoch_batches(), size=2, device=device):
            metrics = step_fn(state, batch)
            sums = dict(metrics) if sums is None else {k: sums[k] + v for k, v in metrics.items()}
            count += 1
            step_now += 1
            if checkpoint_interval and step_now % checkpoint_interval == 0:
                save(completed_epoch=epoch - 1)
        means = _pull(sums, count, mesh)
        say(f"{epoch_line(epoch, means)} [pp{n_pipe} x dp{n_data}, {n_micro} microbatches]")
        save(completed_epoch=epoch)
    checkpoint.wait_for_pending()
    say(f"{kind} saved to {ckpt_dir} (dense artifact; trained pipeline-parallel over "
        f"{n_pipe} stages)")

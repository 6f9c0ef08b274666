"""Checkpoint save and restore.

Counterpart of ``neural_sound_generation_tpu/training/checkpoint.py`` with
the same layout: ``<ckpt_dir>/step_{n}/`` per save, ``latest_step`` for
resume, the ``extra`` metadata in an ``_extra.json`` sidecar that
``read_extra`` answers without loading the state, and the averaged model
exported as a ``<ckpt_dir>_ema`` sibling. The format is the port's own:
``state.pt`` holds named tensors (``torch.save`` of a flat dict, read back
with ``weights_only=True``):

  params/<name>            the live parameters, by the module's names
  batch_stats/<name>       BatchNorm running statistics
  opt_state/count          0-d int32
  opt_state/{m,v}/<name>   Adam moments, float32 or bfloat16
  ema_params/<name>        the parameter EMA (when enabled)
  codebook_ema/{cluster,embed_sum}
  step                     0-d int32

A parameters-only artifact (``save_params``, and the ``_ema`` sibling) holds
just ``params/<name>``: the prior CLI writes its sampling artifact that way,
with the full state in a ``<ckpt_dir>_train`` sibling, and so does a WaveNet
vocoder (``{"condition": "mel"}`` in its metadata); ``restore_params`` reads
either kind into a module. A JAX checkpoint (Orbax) is not read here, as
Orbax imports JAX: ``scripts/torch_import_orbax.py`` reads one through the
JAX package and writes this format (``convert.py`` maps the trees), so the
port's ``--resume`` continues a JAX run.

Restore is strict: a parameter or statistic the template has and the
checkpoint lacks, or one of another shape, refuses with the names;
``restore_model`` alone may keep the fresh values of submodules its caller
names (the motion CLI's ``feature_proj``). The
metadata recorded in ``extra`` (``arch``, ``num_quantizers``,
``num_downsample``) is checked by ``check_extra`` at every restore surface.

Under a data-parallel process group every rank holds the same state, and
only rank 0 writes (``save``, ``save_params``, ``save_ema_sibling``; the
others return the path without touching it). Every rank restores, and the
entry point then replicates rank 0's state (``parallel.mesh``). Under the
mesh's model axis (``training.sharding``) a state holds slices: ``save``
and ``save_ema_sibling`` gather the whole tree over the model group on
every rank, and rank 0 writes it in the one format; ``restore`` and
``restore_ema_sibling`` read the whole tree and keep this rank's slices.
So a checkpoint from an M-way run resumes at any M, and ``serve`` and
``evaluate`` without a mesh read it unchanged. Under the pipe axis
(``parallel.pipeline``) a state holds its stage's layers and the rest
whole: ``state.shards`` (a ``PipeShards``) gathers every stage's layers
over the pipe group for the dense tree on save, and a restore copies the
names the stage holds out of the dense tree, so a state written at any
number of stages (one included) resumes at any other.

The optimizer's moments are named by parameter under either optimizer
(the flat fused one or the per-leaf one, ``TrainConfig.fused_optimizer``),
so a checkpoint written under one restores into the other with its
moments, the count and the EMA intact (the JAX ``_adapt_fused_layout``);
a restore casts the moments to the state's dtype.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch

from neural_sound_generation_tpu_torch.parallel import distributed
from neural_sound_generation_tpu_torch.training.train_state import TrainState

_STEP_RE = re.compile(r"^step_(\d+)$")
STATE_FILE = "state.pt"
EXTRA_FILE = "_extra.json"

# one background writer: saves stay ordered, and a second async save queues
# behind the first instead of racing it
_writer_lock = threading.Lock()
_writer: Optional[ThreadPoolExecutor] = None
_pending: list[Future] = []


def _executor() -> ThreadPoolExecutor:
    global _writer
    with _writer_lock:
        if _writer is None:
            _writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="nsg-ckpt")
        return _writer


def wait_for_pending() -> None:
    """Block until every async write has landed, re-raising the first
    failure. ``restore``, ``latest_step``, ``read_extra`` and blocking saves
    call it, so a resume in the same process sees whole step directories."""
    while _pending:
        _pending.pop(0).result()


def _drain_at_exit() -> None:
    try:
        wait_for_pending()
    except Exception:  # noqa: BLE001 — past the point of recovery at exit
        logging.getLogger("nsg.checkpoint").exception(
            "async checkpoint write failed during interpreter exit"
        )


# threading's exit hooks run before concurrent.futures shuts its executors
# down (they run in reverse registration order, and concurrent.futures
# registered first on import), so an in-flight write still lands
threading._register_atexit(_drain_at_exit)


def _bn_buffers(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    return {
        name: buf for name, buf in model.named_buffers()
        if name.endswith(("running_mean", "running_var"))
    }


def state_tensors(state: TrainState) -> dict[str, torch.Tensor]:
    """The state as named tensors (views of the live buffers)."""
    flat = state.flat
    out: dict[str, torch.Tensor] = {}
    for name, t in flat.named(flat.flat).items():
        out[f"params/{name}"] = t
    for name, t in _bn_buffers(state.model).items():
        out[f"batch_stats/{name}"] = t
    out["opt_state/count"] = state.opt_state.count
    for key in ("m", "v"):
        for name, t in state.opt_state.named_moments(flat, key).items():
            out[f"opt_state/{key}/{name}"] = t
    if state.ema_params is not None:
        for name, t in flat.named(state.ema_params).items():
            out[f"ema_params/{name}"] = t
    if state.codebook_ema is not None:
        for key, t in state.codebook_ema.items():
            out[f"codebook_ema/{key}"] = t
    out["step"] = state.step
    return out


def _host_snapshot(tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: t.detach().to("cpu", copy=True) for k, t in tensors.items()}


def _json_scalar(o):
    if hasattr(o, "item"):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")


def _write(path: str, tensors: dict, extra: Optional[dict]) -> str:
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(tensors, os.path.join(tmp, STATE_FILE))
    if extra:
        with open(os.path.join(tmp, EXTRA_FILE), "w", encoding="utf-8") as f:
            json.dump(extra, f, default=_json_scalar)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def save(ckpt_dir: str, state: TrainState, step: int, extra: Optional[dict] = None,
         block: bool = True) -> str:
    """Save ``state`` under ``ckpt_dir/step_{step}``; ``extra`` (e.g.
    ``{"epoch": 3, "arch": "vqvae"}``) goes to the ``_extra.json`` sidecar.

    ``block=False`` copies the state to the host synchronously (later steps
    may change the buffers) and writes on a background thread, so the
    train loop pays only the device-to-host copy. The step directory
    appears whole (written aside, then renamed)."""
    tensors = state_tensors(state)
    if state.shards is not None:
        tensors = state.shards.gather_tensors(tensors)
    return _save_tensors(ckpt_dir, tensors, step, extra, block)


def _save_tensors(ckpt_dir, tensors, step, extra, block) -> str:
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    if not distributed.is_primary():
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    snapshot = _host_snapshot(tensors)
    extra = dict(extra) if extra else None
    if block:
        wait_for_pending()
        return _write(path, snapshot, extra)
    _pending.append(_executor().submit(_write, path, snapshot, extra))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    wait_for_pending()
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir) if (m := _STEP_RE.match(name))]
    return max(steps) if steps else None


def _step_path(ckpt_dir: str, step: Optional[int]) -> str:
    wait_for_pending()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")


def read_extra(ckpt_dir: str, step: Optional[int] = None) -> Optional[dict]:
    """The ``extra`` metadata of a checkpoint (latest step by default)
    from its sidecar, without loading the state; None when there is no
    checkpoint or no metadata."""
    wait_for_pending()
    at = step if step is not None else latest_step(ckpt_dir)
    if at is None:
        return None
    sidecar = os.path.join(os.path.abspath(ckpt_dir), f"step_{at}", EXTRA_FILE)
    if not os.path.exists(sidecar):
        return None
    with open(sidecar, encoding="utf-8") as f:
        got = json.load(f)
    return got if isinstance(got, dict) else None


def check_extra(ckpt_dir: str, **expected) -> Optional[dict]:
    """Refuse a checkpoint whose recorded metadata (``arch``,
    ``num_quantizers``, ``num_downsample``, ...) differs from what the
    caller is about to build; keys the checkpoint did not record pass.
    Returns the metadata."""
    meta = read_extra(ckpt_dir) or {}
    for key, want in expected.items():
        if key in meta and meta[key] != want:
            raise ValueError(
                f"checkpoint {ckpt_dir} was trained with {key}={meta[key]!r}, "
                f"not {want!r}"
            )
    return meta


def _load(path: str) -> dict[str, torch.Tensor]:
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def _copy_named(dst: dict[str, torch.Tensor], src: dict[str, torch.Tensor], prefix: str,
                path: str) -> None:
    missing = [k for k in dst if f"{prefix}{k}" not in src]
    wrong = [
        f"{k} {tuple(src[prefix + k].shape)} != {tuple(t.shape)}"
        for k, t in dst.items()
        if prefix + k in src and src[prefix + k].shape != t.shape
    ]
    if missing or wrong:
        raise ValueError(
            f"checkpoint {path} does not match the model: missing {prefix}{missing}, "
            f"shapes {wrong}"
        )
    with torch.no_grad():
        for k, t in dst.items():
            t.copy_(src[prefix + k])


def restore(ckpt_dir: str, state: TrainState, step: Optional[int] = None):
    """Load a checkpoint into ``state`` in place: ``(state, extra)``.

    Moments are cast to the state's moment dtype (so ``bf16_moments`` holds
    on resume). A checkpoint without an EMA shadow leaves
    ``state.ema_params`` None; one without EMA-codebook statistics keeps
    the state's."""
    path = _step_path(ckpt_dir, step)
    load_state_tensors(state, _load(path), path)
    return state, read_extra(ckpt_dir, int(os.path.basename(path)[len("step_"):]))


def load_state_tensors(state: TrainState, src: dict, path: str = "<tensors>") -> None:
    """Copy a whole named tree (``state_tensors``' names) into ``state``
    in place, this rank's slices under the model axis: the body of
    ``restore``."""
    if state.shards is not None:
        src = state.shards.slice_tensors(src)
    flat = state.flat
    _copy_named(flat.named(flat.flat), src, "params/", path)
    _copy_named(_bn_buffers(state.model), src, "batch_stats/", path)
    for key in ("m", "v"):
        _copy_named(state.opt_state.named_moments(flat, key), src, f"opt_state/{key}/", path)
    with torch.no_grad():
        state.opt_state.count.copy_(src["opt_state/count"])
        state.step.copy_(src["step"])
    if state.ema_params is not None:
        if any(k.startswith("ema_params/") for k in src):
            _copy_named(flat.named(state.ema_params), src, "ema_params/", path)
        else:
            logging.getLogger("nsg.checkpoint").warning(
                "checkpoint %s has no EMA shadow; the state carries none", path
            )
            state.ema_params = None
    if state.codebook_ema is not None:
        if "codebook_ema/cluster" in src:
            _copy_named(state.codebook_ema, src, "codebook_ema/", path)
        else:
            logging.getLogger("nsg.checkpoint").warning(
                "checkpoint %s has no EMA-codebook statistics; keeping the "
                "state's (cluster 1, embed_sum = codebook)", path
            )


def save_params(ckpt_dir: str, module: torch.nn.Module, step: int,
                extra: Optional[dict] = None, shards=None) -> str:
    """Save a module's parameters alone as ``ckpt_dir/step_{step}``
    (``params/<name>``), blocking: the artifact that sampling and serving
    restore with ``restore_params`` (a trained prior's ``state.model``, a
    vocoder). A module sharded over the model axis passes its state's
    ``shards``: the whole parameters are gathered (a collective)."""
    tensors = {f"params/{k}": t for k, t in module.named_parameters()}
    if shards is not None:
        tensors = shards.gather_tensors(tensors)
    return _save_tensors(ckpt_dir, tensors, step, extra, block=True)


def save_named_params(ckpt_dir: str, params: dict[str, torch.Tensor], step: int,
                      extra: Optional[dict] = None) -> str:
    """``save_params`` of named tensors (an imported artifact's) rather than
    of a module's parameters."""
    return _save_tensors(ckpt_dir, {f"params/{k}": t for k, t in params.items()}, step, extra,
                         block=True)


def restore_params(ckpt_dir: str, module: torch.nn.Module,
                   step: Optional[int] = None) -> Optional[dict]:
    """Load ``params/<name>`` of a checkpoint (a full state, a
    ``save_params`` artifact or an ``_ema`` sibling) into ``module``'s
    parameters in place; returns the checkpoint's metadata. Strict, as
    ``restore``."""
    path = _step_path(ckpt_dir, step)
    _copy_named(dict(module.named_parameters()), _load(path), "params/", path)
    return read_extra(ckpt_dir, int(os.path.basename(path)[len("step_"):]))


def restore_model(ckpt_dir: str, module: torch.nn.Module, fill: tuple[str, ...] = (),
                  step: Optional[int] = None) -> Optional[dict]:
    """Load a checkpoint's live parameters (``params/<name>``, not the EMA
    shadow) and BatchNorm statistics into ``module`` in place; returns the
    checkpoint's metadata.

    A parameter of a submodule named in ``fill`` that the checkpoint lacks
    keeps the module's own (fresh-init) value, with a warning: the motion
    CLI restores a ``cli.main`` checkpoint, which has no ``feature_proj``,
    into a feature-conditioned model. Any other missing leaf, or one of
    another shape, raises as ``restore`` does."""
    path = _step_path(ckpt_dir, step)
    src = _load(path)
    params = dict(module.named_parameters())
    filled: dict[str, list[str]] = {}
    for name in params:
        prefix, _, leaf = name.rpartition(".")
        if prefix in fill and f"params/{name}" not in src:
            filled.setdefault(prefix, []).append(leaf)
    for prefix, leaves in filled.items():
        logging.getLogger("nsg.checkpoint").warning(
            "checkpoint %s is missing 'params/%s' (%s); using the model's "
            "(fresh-init) value", path, prefix, ", ".join(leaves))
    kept = {k: t for k, t in params.items()
            if f"params/{k}" in src or k.rpartition(".")[0] not in fill}
    _copy_named(kept, src, "params/", path)
    _copy_named(_bn_buffers(module), src, "batch_stats/", path)
    return read_extra(ckpt_dir, int(os.path.basename(path)[len("step_"):]))


def save_ema_sibling(ckpt_dir: str, state: TrainState, step: int,
                     extra: Optional[dict] = None) -> Optional[str]:
    """Export the averaged model (``state.eval_params()``) as
    ``<ckpt_dir>_ema/step_{step}`` with ``params/<name>`` tensors and
    ``averaged: true`` in its metadata. None when the state has no EMA."""
    if state.ema_params is None:
        return None
    tensors = {f"params/{k}": t for k, t in state.flat.named(state.eval_params()).items()}
    if state.shards is not None:
        tensors = state.shards.gather_tensors(tensors)
    meta = dict(extra or {})
    meta["averaged"] = True
    return _save_tensors(ckpt_dir.rstrip("/") + "_ema", tensors, step, meta, block=True)


def restore_ema_sibling(ckpt_dir: str, state: TrainState, step: Optional[int] = None):
    """Load ``state.ema_params`` from the ``<ckpt_dir>_ema`` sibling (a
    resumed run keeps its averaged model instead of re-seeding it from the
    resume-point parameters). No-op without an EMA or a sibling."""
    if state.ema_params is None:
        return state
    ema_dir = ckpt_dir.rstrip("/") + "_ema"
    if latest_step(ema_dir) is None:
        return state
    path = _step_path(ema_dir, step)
    src = _load(path)
    if state.shards is not None:
        src = state.shards.slice_tensors(src)
    _copy_named(state.flat.named(state.ema_params), src, "params/", path)
    return state

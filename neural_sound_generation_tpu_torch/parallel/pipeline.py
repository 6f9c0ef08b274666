"""Pipeline parallelism: GPipe over the mesh's ``pipe`` axis.

Counterpart of ``neural_sound_generation_tpu/parallel/pipeline.py``. The
JAX package stacks a uniform block stack's parameters on a leading layer
axis sharded over ``pipe`` and runs the microbatches through the stages
as one traced ``lax.scan`` of M + S - 1 ticks, in which every stage
computes every tick and the ticks outside its window are masked, with a
``ppermute`` ring between neighbours. Here each rank is one process
holding one stage, and the schedule is GPipe's fill and drain in eager
PyTorch (``PipelineStep``):

  * forward: for each microbatch in turn, receive the activation from
    stage s - 1 (stage 0 embeds instead), run the stage's layers and hand
    the result to stage s + 1; every microbatch's autograd graph is kept;
  * loss: the last stage concatenates the microbatches' outputs and takes
    the loss once, over the rank's rows of the whole batch (the vocoder's
    masked means are means over the batch's valid samples, not means of
    the microbatches' means);
  * backward: in reverse order, receive the output's gradient from stage
    s + 1, run ``torch.autograd.backward`` and hand the input's gradient to
    stage s - 1. Both ranks of a neighbouring pair make their hand-offs in
    the same order (microbatch 0 .. M - 1 forward, M - 1 .. 0 backward),
    so the schedule cannot deadlock.

Stage s holds layers [s L / S, (s + 1) L / S): the transformer prior's
``block_i``; WaveNet's ``dilated_i``, ``cond_i``, ``g_i``, ``res_i`` and
``skip_i`` of its stacks (stacks % S and L % stacks must both be 0, so a
stage holds whole stacks and each dilation schedule stays within it, as
JAX stages per stack). ``pp_prior_partition`` and ``pp_wavenet_partition``
delete the other stages' layers from a model built whole on the host, so a
rank keeps only its layers on the device, and only their optimizer
moments: PP's memory claim. The rest (embeddings, ``cond_proj``, the
final LayerNorm and head; ``first_conv``, the upsampler, the speaker table
and the post head) is held whole on every stage, as JAX replicates
``rest``. A stage computes the parts of the rest it needs: stage 0 the
embeddings, the last stage the head, and every WaveNet stage its own
upsampled conditioning and speaker embedding (JAX's stage-local
``broadcast`` tree), which never ride the ring.

The train step. Each rank's flat buffer is its stage's layers first, then
the rest (``FlatParams(first=...)``), and kernel 3 runs once a step on it
with the one-rank optimizer chain (clip, weight decay, Adam; constant lr,
float32 moments). Between the backward and the update the rest's
gradient segment is summed over the pipe group (stage 0 alone touches the
embeddings, the last stage alone the head, every WaveNet stage adds its
part of the upsampler's and the speaker table's gradient), then the whole
buffer takes the data group's mean; the clip's global norm sums the stage
segments' squares over the pipe group and counts the rest once
(``PipeShards.sum_sharded``). Every stage then applies the same update to
the rest, which stays bit-equal across the pipe group.

The routed prior. Switch's term E * sum(frac * mean_p) takes both factors
over the whole batch, so the mean of the microbatches' terms is not the
batch's. Each routed block returns its rows' statistics (JAX's
``moe_stats`` ``rows``); each stage takes its layers' terms from its rows
over every microbatch, reduced over the data group (``moe.load_balance``),
and adds 0.01 / L times their sum to its backward, so the term's gradient
enters the stage's layers locally and flows back along the ring. Its
gradient at each microbatch's statistics joins that microbatch's
backward: a graph is traversed once, and kernel 4's backward runs once a
layer and microbatch. The reported ``moe_load_balance`` is the pipe
group's sum of the pieces: the mean over all L layers, as one rank's.

Batch rows. Each data rank keeps its rows of the global batch
(``parallel.mesh.shard_batch``) and cuts them into M microbatches; JAX
instead shards each global microbatch over ``data``. Both cover the global
batch once with the same arithmetic a row (``validate_pp_mesh``: M divides
B and D divides B / M), so the step is the same.

Checkpoints stay dense: ``PipeShards.gather_tensors`` collects every
stage's layers over the pipe group (one broadcast of packed bytes a stage)
into the one-rank tree, which ``training.checkpoint`` writes, and a restore
reads the names a stage holds from the dense tree, so a state written at
any S resumes at any other and the artifact restores on one rank.
``stack_layer_params``/``unstack_layer_params``, ``pp_prior_split``/
``pp_prior_unpartition`` and ``wavenet_stack_params``/
``wavenet_unstack_params`` map a dense named tree to JAX's stacked layout
(a leading layer axis, per stack for WaveNet) and back.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Optional

import torch
from torch import nn

from neural_sound_generation_tpu_torch.config import Config, TrainConfig
from neural_sound_generation_tpu_torch.models.moe import load_balance
from neural_sound_generation_tpu_torch.models.transformer_prior import TransformerPrior
from neural_sound_generation_tpu_torch.models.wavenet import WaveNet
from neural_sound_generation_tpu_torch.parallel import distributed
from neural_sound_generation_tpu_torch.parallel import mesh as mesh_mod
from neural_sound_generation_tpu_torch.parallel.mesh import Mesh
from neural_sound_generation_tpu_torch.training.losses import MOE_AUX_WEIGHT, prior_nll
from neural_sound_generation_tpu_torch.training.train_state import TrainState, create_train_state

__all__ = [
    "make_pp_mesh",
    "Stage",
    "stack_layer_params",
    "unstack_layer_params",
    "pp_prior_split",
    "pp_prior_partition",
    "pp_prior_unpartition",
    "wavenet_stack_params",
    "wavenet_unstack_params",
    "pp_wavenet_partition",
    "holds",
    "PipeShards",
    "place_stage",
    "PipelineStep",
    "make_pp_prior_train_step",
    "make_pp_wavenet_train_step",
]

#: a layer's parameter names: the prior's blocks, WaveNet's per-layer convolutions
_LAYER_RE = {TransformerPrior: re.compile(r"^block_(\d+)\."),
             WaveNet: re.compile(r"^(?:dilated|cond|res|skip|g)_(\d+)\.")}
#: WaveNet's per-layer groups, JAX's ``wavenet_stack_params`` ``groups``
WAVENET_GROUPS = ("dilated", "cond", "res", "skip", "g")


def make_pp_mesh(n_pipe: int, n_data: int = 1) -> Optional[Mesh]:
    """The (data, pipe) mesh over the process group, pipe innermost (JAX's
    ``make_pp_mesh``): rank r at stage r % n_pipe of data row r // n_pipe.
    None for a one-rank program (1 x 1 on a world of one)."""
    if n_pipe * n_data == 1 and distributed.world_size() == 1:
        return None
    return Mesh(n_data, n_pipe=n_pipe)


@dataclasses.dataclass(frozen=True)
class Stage:
    """Stage ``index`` of ``count``."""

    index: int = 0
    count: int = 1

    @classmethod
    def of(cls, mesh: Optional[Mesh]) -> "Stage":
        return cls() if mesh is None else cls(mesh.stage, mesh.n_pipe)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.count - 1

    def layers(self, n_layers: int) -> range:
        """The stage's layers of a uniform stack of ``n_layers``."""
        if n_layers % self.count:
            raise ValueError(f"{n_layers} layers do not stage evenly over {self.count} pipe "
                             f"stages")
        per = n_layers // self.count
        return range(self.index * per, (self.index + 1) * per)


def _layer_re(model: nn.Module) -> re.Pattern:
    for cls, pattern in _LAYER_RE.items():
        if isinstance(model, cls):
            return pattern
    raise NotImplementedError(f"{type(model).__name__}: no pipeline stages")


def _depth(model: nn.Module) -> int:
    return model.n_layers if isinstance(model, TransformerPrior) else model.layers


# -- the dense tree and JAX's stacked layout ------------------------------------------------


def stack_layer_params(tensors: dict, n_layers: int, prefix: str = "block_") -> dict:
    """``{f"{prefix}{i}.{leaf}": t}`` -> ``{leaf: (n_layers, ...)}`` (JAX's
    ``stack_layer_params`` on the port's names); other entries are left
    out. The layers must be alike."""
    head = f"{prefix}0."
    leaves = sorted(k[len(head):] for k in tensors if k.startswith(head))
    return {leaf: torch.stack([tensors[f"{prefix}{i}.{leaf}"] for i in range(n_layers)])
            for leaf in leaves}


def unstack_layer_params(stacked: dict, n_layers: int, prefix: str = "block_") -> dict:
    """Inverse of ``stack_layer_params``: the ``{prefix}{i}.{leaf}`` names."""
    return {f"{prefix}{i}.{leaf}": t[i] for leaf, t in stacked.items() for i in range(n_layers)}


def pp_prior_split(model: TransformerPrior, tensors: dict) -> tuple[dict, dict]:
    """A dense prior tree -> (rest, stacked): the blocks stacked on a
    leading layer axis, the rest by name (JAX's ``pp_prior_split``)."""
    rest = {k: t for k, t in tensors.items() if not _LAYER_RE[TransformerPrior].match(k)}
    return rest, stack_layer_params(tensors, model.n_layers)


def pp_prior_unpartition(model: TransformerPrior, rest: dict, stacked: dict) -> dict:
    """(rest, stacked) -> the dense ``block_i`` tree (JAX's
    ``pp_prior_unpartition``)."""
    return {**rest, **unstack_layer_params(stacked, model.n_layers)}


def _check_stacks(model: WaveNet, n_stages: int = 1) -> None:
    if model.layers % model.stacks:
        raise ValueError(f"layers={model.layers} does not divide into stacks={model.stacks}")
    if model.stacks % n_stages:
        raise ValueError(f"--stacks {model.stacks} does not stage evenly over --mesh-pipe "
                         f"{n_stages}")


def wavenet_stack_params(model: WaveNet, tensors: dict) -> tuple[dict, dict]:
    """A dense WaveNet tree -> (rest, stacked): each per-layer group's
    leaves stacked per stack, (stacks, layers a stack, ...), the dilation
    schedule repeating within every stack (JAX's
    ``wavenet_stack_params``); rest (``first_conv``, the upsampler, the
    embeddings, the post head) by name."""
    _check_stacks(model)
    per = model.layers // model.stacks
    stacked = {}
    for group in WAVENET_GROUPS:
        flat = stack_layer_params(tensors, model.layers, prefix=f"{group}_")
        if flat:
            stacked[group] = {leaf: t.reshape(model.stacks, per, *t.shape[1:])
                              for leaf, t in flat.items()}
    rest = {k: t for k, t in tensors.items() if not _LAYER_RE[WaveNet].match(k)}
    return rest, stacked


def wavenet_unstack_params(model: WaveNet, rest: dict, stacked: dict) -> dict:
    """Inverse of ``wavenet_stack_params``: the flat ``{group}_{i}`` tree
    that ``synthesize`` and ``serve --vocoder-ckpt`` restore."""
    out = dict(rest)
    for group, leaves in stacked.items():
        out.update(unstack_layer_params({leaf: t.flatten(0, 1) for leaf, t in leaves.items()},
                                        model.layers, prefix=f"{group}_"))
    return out


# -- a rank's stage ------------------------------------------------------------------------


def holds(model: nn.Module, stage: Stage, name: str) -> bool:
    """Whether ``stage`` holds ``model``'s tensor ``name``: a layer of its
    own, or the rest."""
    m = _layer_re(model).match(name)
    return m is None or int(m.group(1)) in stage.layers(_depth(model))


def _keep_stage(model: nn.Module, stage: Stage) -> list[str]:
    """Delete the other stages' layers from ``model``, in place; the
    names of the stage's layers' parameters, in module order."""
    for name, _ in list(model.named_children()):
        if not holds(model, stage, name + "."):
            delattr(model, name)
    return [n for n, _ in model.named_parameters() if _layer_re(model).match(n)]


def pp_prior_partition(model: TransformerPrior, stage: Stage) -> list[str]:
    """The persistent layout of a prior built whole: ``model`` keeps only
    the stage's blocks, and the rest whole, in place (JAX's
    ``pp_prior_partition``). Returns the names of the stage's parameters."""
    return _keep_stage(model, stage)


def pp_wavenet_partition(model: WaveNet, stage: Stage,
                         dtype: Optional[torch.dtype] = None) -> list[str]:
    """The persistent layout of a WaveNet built whole (float32): ``model``
    keeps the layers of the stage's stacks, and the rest whole, in place
    (JAX's ``wavenet_stack_params`` with a mesh). ``dtype`` bfloat16 runs
    the stage's layers in it (``--bf16``, JAX's ``_wavenet_stage_fn``: the
    float32 parameters cast per use), the rest in float32."""
    _check_stacks(model, stage.count)
    names = _keep_stage(model, stage)
    if dtype is not None:
        for i in stage.layers(model.layers):
            for group in WAVENET_GROUPS:
                layer = getattr(model, f"{group}_{i}", None)
                if layer is not None:
                    layer.compute_dtype = dtype
    return names


@dataclasses.dataclass
class PipeShards:
    """Which of a rank's tensors are its stage's layers, keyed as the
    checkpoint names them (``training.checkpoint.state_tensors``); the rest
    is whole on every stage. The pipe axis's counterpart of
    ``training.sharding.ModelShards``."""

    mesh: Mesh
    model: nn.Module

    def sum_sharded(self, t: torch.Tensor) -> torch.Tensor:
        """A partial sum over this stage's layers -> over every stage's."""
        return self.mesh.pipe_all_reduce_(t.clone())

    def slice_tensors(self, whole: dict) -> dict:
        """This stage's share of a dense tree: the tree itself, whose names
        of other stages' layers no restore of this state reads."""
        return whole

    def gather_tensors(self, local: dict) -> dict:
        """The dense tree from every stage's layers (a collective over the
        pipe group): each stage in turn broadcasts its layers' tensors,
        packed as bytes in one order every stage derives from its own
        (the layer index relative to the stage's first); another stage's
        arrive on the host."""
        mesh = self.mesh
        if mesh.n_pipe == 1:
            return dict(local)
        pattern = _layer_re(self.model)
        per = _depth(self.model) // mesh.n_pipe
        lo = mesh.stage * per
        entries = []
        for key, t in local.items():
            kind, _, name = key.rpartition("/")
            m = pattern.match(name)
            if m:
                j = int(m.group(1)) - lo
                parts = (f"{kind}/" if kind else "", name[:m.start(1)], name[m.end(1):])
                entries.append((f"{parts[0]}{parts[1]}{j}{parts[2]}", j, parts, t))
        entries.sort(key=lambda e: e[0])
        out = dict(local)
        if not entries:
            return out
        device = entries[0][3].device
        sizes = [e[3].numel() * e[3].element_size() for e in entries]
        for s in range(mesh.n_pipe):
            if s == mesh.stage:
                buf = torch.cat([e[3].detach().contiguous().reshape(-1).view(torch.uint8)
                                 for e in entries])
            else:
                buf = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
            mesh.pipe_broadcast_(buf, s)
            if s == mesh.stage:
                continue
            off = 0
            for (_, j, (kind, head, tail), t), n in zip(entries, sizes):
                piece = buf[off:off + n].to("cpu", copy=True).view(t.dtype).reshape(t.shape)
                out[f"{kind}{head}{s * per + j}{tail}"] = piece
                off += n
        return out


def place_stage(model: nn.Module, train_cfg: TrainConfig, mesh: Optional[Mesh],
                device: torch.device, stage_dtype: Optional[torch.dtype] = None) -> TrainState:
    """This rank's train state of a model built whole on the host (from
    the seed every rank shares): the model keeps its stage's layers
    (``pp_prior_partition``, ``pp_wavenet_partition`` with the stage's
    compute ``stage_dtype``), moves to ``device``, and its flat buffer
    holds them first, then the rest; the fused optimizer (kernel 3) with
    float32 moments, the EMA as ``train_cfg`` says."""
    stage = Stage.of(mesh)
    if isinstance(model, TransformerPrior):
        first = pp_prior_partition(model, stage)
    else:
        first = pp_wavenet_partition(model, stage, stage_dtype)
    model.to(device)
    cfg = dataclasses.replace(train_cfg, bf16_moments=False)
    state = create_train_state(model, cfg, fused=True, first=first)
    state.shards = None if mesh is None else PipeShards(mesh, model)
    return state


# -- the step ------------------------------------------------------------------------------


def _chunks(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of consecutive rows of every tensor of ``batch``."""
    parts = {k: (None if v is None else torch.chunk(v, n)) for k, v in batch.items()}
    return [{k: None if v is None else v[i] for k, v in parts.items()} for i in range(n)]


class _PriorStage:
    """The transformer prior's stage: ``embed_sequence`` on stage 0, the
    stage's ``_Block``s (kernel 4 forward and backward on each
    microbatch), ``head_logits`` and the NLL on the last stage."""

    def __init__(self, model: TransformerPrior, stage: Stage):
        self.model, self.stage = model, stage
        self.blocks = [getattr(model, f"block_{i}") for i in stage.layers(model.n_layers)]
        self.routed = model.n_experts > 0
        self.metric_keys = ("loss", "nll_per_code")

    def microbatches(self, batch: dict, n: int) -> list[dict]:
        keys = ("codes", "labels") + (("cond",) if self.model.spatial_cond else ())
        return _chunks({k: batch[k] for k in keys}, n)

    def first(self, mb: dict) -> torch.Tensor:
        return self.model.embed_sequence(mb["codes"], mb["labels"], mb.get("cond"))

    def payload(self, mb: dict) -> torch.Tensor:
        """A buffer for a microbatch's activation: the residual stream, in
        the parameters' dtype."""
        b, h, w = mb["codes"].shape
        return torch.empty((b, h * w, self.model.dim), dtype=self.model.bos.dtype,
                           device=mb["codes"].device)

    def layers(self, x: torch.Tensor, mb: dict):
        rows = []
        for blk in self.blocks:
            x, stats = blk(x, per_row=self.routed)
            rows.append(stats)
        return x, rows

    def load_balance(self, rows: list) -> Optional[torch.Tensor]:
        """This stage's piece of the mean load-balance term: (1 / L) times
        its layers' terms, each over every microbatch's rows."""
        if not self.routed:
            return None
        terms = [load_balance(torch.cat([r[j] for r in rows])) for j in range(len(self.blocks))]
        return sum(terms) / self.model.n_layers

    def loss(self, y: torch.Tensor, batch: dict):
        codes = batch["codes"]
        logits = self.model.head_logits(y).reshape(*codes.shape, self.model.input_dim)
        return prior_nll(logits, codes)


class _WaveNetStage:
    """WaveNet's stage: ``_embed`` on stage 0, the stage's layers on (h,
    skips) (one tensor on the ring, (mb, R + S, T), in the stage's compute
    dtype), the conditioning on every stage, ``head`` (float32) and the
    loss on the last stage."""

    def __init__(self, model: WaveNet, cfg: Config, stage: Stage,
                 dtype: Optional[torch.dtype] = None):
        from neural_sound_generation_tpu_torch.training.trainer import wavenet_objective

        self.model, self.cfg, self.stage, self.dtype = model, cfg, stage, dtype
        self.mine = stage.layers(model.layers)
        self.objective = wavenet_objective
        self.metric_keys = ("loss",)

    def microbatches(self, batch: dict, n: int) -> list[dict]:
        x = WaveNet.shift_inputs(batch["y"], self.model.scalar_input)
        return _chunks({"x": x, "c": batch.get("c"), "g": batch.get("g")}, n)

    def first(self, mb: dict) -> torch.Tensor:
        h = self.model._embed(mb["x"])
        if self.dtype is not None:
            h = h.to(self.dtype)
        return torch.cat([h, h.new_zeros(h.shape[0], self.model.skip_out_channels,
                                         h.shape[2])], dim=1)

    def payload(self, mb: dict) -> torch.Tensor:
        """A buffer for a microbatch's (h, skips): the stages' compute dtype,
        else the parameters'."""
        m = self.model
        return torch.empty((mb["x"].shape[0], m.residual_channels + m.skip_out_channels,
                            mb["x"].shape[1]), dtype=self.dtype or m.first_conv.weight.dtype,
                           device=mb["x"].device)

    def layers(self, x: torch.Tensor, mb: dict):
        r = self.model.residual_channels
        h, skips = x[:, :r], x[:, r:]
        c_up, g_emb = self.model.conditioning(mb.get("c"), mb.get("g"), h.shape[-1])
        h, skips = self.model.run_layers(h, skips, c_up, g_emb, self.mine)
        return torch.cat([h, skips], dim=1), None

    def load_balance(self, rows: list) -> None:
        return None

    def loss(self, y: torch.Tensor, batch: dict):
        y_hat = self.model.head(y[:, self.model.residual_channels:])
        loss = self.objective(self.model, self.cfg, y_hat, batch)
        return loss, {"loss": loss}


class PipelineStep:
    """One GPipe train step of this rank's stage: ``step(state, batch) ->
    metrics``, updating ``state`` (``place_stage``'s) in place. ``batch``
    is this rank's rows of the global batch; the metrics (the loss, the
    routed prior's ``moe_load_balance``, ``grad_norm``) are the pipe
    group's, the same on every stage. ``handoff_seconds`` and
    ``handoff_bytes`` add up the hand-offs between stages (host time,
    each a synchronous transfer)."""

    def __init__(self, family, mesh: Optional[Mesh], n_micro: int):
        self.family, self.mesh, self.n_micro = family, mesh, n_micro
        self.stage = family.stage
        self.handoff_seconds, self.handoff_bytes = 0.0, 0

    def _hand(self, send: bool, step: int, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to, or receive it in place from, the stage at ``step``."""
        t0 = time.perf_counter()
        if send:
            self.mesh.send_along(t, "pipe", step)
        else:
            self.mesh.recv_along(t, "pipe", step)
        self.handoff_seconds += time.perf_counter() - t0
        self.handoff_bytes += t.numel() * t.element_size()
        return t

    def __call__(self, state: TrainState, batch: dict) -> dict:
        with mesh_mod.active(self.mesh):
            return self._step(state, batch)

    def _step(self, state: TrainState, batch: dict) -> dict:
        mesh = self.mesh
        state.flat.zero_grad()
        metrics = self.forward_backward(batch)
        with torch.no_grad():
            flat = state.flat
            if mesh is not None:
                # the rest's gradient: every stage's part of it, then the rows'
                mesh.pipe_all_reduce_(flat.grad[flat.split_at:])
                mesh.mean_(flat.grad)
                keys = sorted(metrics)
                values = mesh.pipe_all_reduce_(torch.stack([metrics[k].float() for k in keys]))
                metrics = dict(zip(keys, values))
            metrics["grad_norm"] = state.apply_gradients()
            state.step.add_(1)
        return metrics

    def forward_backward(self, batch: dict) -> dict:
        """The schedule of the module docstring on this rank's rows: the
        stage's gradients accumulate into its parameters' ``.grad`` (the
        rest's only this stage's part, over its rows); the metrics of the
        last stage, zeros elsewhere, and the stage's ``moe_load_balance``
        piece."""
        fam, stage = self.family, self.stage
        fam.model.train()
        micro = fam.microbatches(batch, self.n_micro)
        ins, outs, rows = [], [], []
        for mb in micro:
            if stage.first:
                x = fam.first(mb)
            else:
                x = self._hand(False, -1, fam.payload(mb)).requires_grad_()
                ins.append(x)
            y, stats = fam.layers(x, mb)
            if not stage.last:
                self._hand(True, 1, y.detach().contiguous())
            outs.append(y)
            rows.append(stats)
        piece = fam.load_balance(rows)
        if stage.last:
            loss, metrics = fam.loss(torch.cat(outs), batch)
            (loss if piece is None else loss + MOE_AUX_WEIGHT * piece).backward()
            for i in reversed(range(len(ins))):
                self._hand(True, -1, ins[i].grad.contiguous())
        else:
            device = outs[0].device
            metrics = {k: torch.zeros((), device=device) for k in fam.metric_keys}
            d_rows = [[] for _ in outs]
            if piece is not None:
                # the stage's term spans every microbatch: its gradient at each
                # microbatch's row statistics joins that microbatch's backward,
                # so each graph is traversed once
                flat = [t for r in rows for t in r]
                grads = iter(torch.autograd.grad(MOE_AUX_WEIGHT * piece, flat))
                d_rows = [[next(grads) for _ in r] for r in rows]
            for i in reversed(range(len(outs))):
                g = self._hand(False, 1, torch.empty_like(outs[i]))
                torch.autograd.backward([outs[i], *(rows[i] if d_rows[i] else ())],
                                        [g, *d_rows[i]])
                if not stage.first:
                    self._hand(True, -1, ins[i].grad.contiguous())
        metrics = {k: v.detach() for k, v in metrics.items()}
        if piece is not None:
            metrics["moe_load_balance"] = piece.detach()
        return metrics


def make_pp_prior_train_step(model: TransformerPrior, mesh: Optional[Mesh],
                             n_micro: int) -> PipelineStep:
    """The pipelined prior step over ``place_stage``'s state (JAX's
    ``make_pp_prior_train_step``): the NLL, and for a routed prior 0.01
    times the load-balance term collected across stages."""
    return PipelineStep(_PriorStage(model, Stage.of(mesh)), mesh, n_micro)


def make_pp_wavenet_train_step(model: WaveNet, cfg: Config, mesh: Optional[Mesh],
                               n_micro: int, bf16: bool = False) -> PipelineStep:
    """The pipelined vocoder step over ``place_stage``'s state (JAX's
    ``make_pp_wavenet_train_step``): the teacher-forced MoL or masked cross
    entropy on the last stage; ``bf16`` hands bfloat16 activations between
    stages (the stages' layers placed with ``stage_dtype`` bfloat16)."""
    return PipelineStep(_WaveNetStage(model, cfg, Stage.of(mesh),
                                      torch.bfloat16 if bf16 else None), mesh, n_micro)

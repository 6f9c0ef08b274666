"""WaveNet vocoder: gated dilated causal convolutions over samples.

Counterpart of ``neural_sound_generation_tpu/models/wavenet.py``. The
modules carry the flax names (``first_conv``, ``dilated_i``, ``res_i``,
``skip_i``, ``cond_i``, ``g_i``, ``post1``, ``post2``, ``input_embed``,
``speaker_embed``, ``upsampler.ConvTranspose_j``), so ``convert.py`` maps one
tree onto the other by name. The public functions keep the JAX layout:
inputs (B, T, 1) floats or (B, T) ints, mels (B, T', C), logits (B, T, out).

  * ``WaveNet.forward`` is the teacher-forced parallel pass: every dilated
    conv runs over the whole utterance with causal left padding. Under a
    bf16 ``dtype`` (``cli.vocoder train --bf16``) every convolution of the
    stack casts its input and weights to bf16, as flax's ``Conv(dtype=)``
    does, so ``h``, the gate and the running ``skips`` are bf16 tensors;
    the parameters, the embeddings, the ``ConditionUpsampler`` and the
    returned logits stay float32.
  * Generation keeps the JAX package's per-step structure: one (L, B, rmax,
    R) ring of past layer inputs, the K-1 taps of every layer gathered at
    once, the conditioning of every layer in one product, and only the
    residual chain sequential (``_step_core``). A step is a few hundred
    small launches in PyTorch; there is no ``jit``, and the JAX samplers'
    ``unroll`` argument is dropped.
  * Sampling takes its noise pre-drawn, in one scan-major layout for every
    sampler (``draw_noise``: gumbel (T, B, n), uniform (T, B)), from a
    ``torch.Generator`` or, for the tests, injected. ``_sample_from_logits``
    is the one sampling body of the monolithic, chunked and multiplexed
    samplers.
  * ``make_generate_fn(..., use_kernel=True)`` dispatches batch-1
    mel-conditioned MoL generation to the whole-loop CUDA kernel
    (``ops/cuda/wavenet_gen.py``), as ``use_pallas=True`` does in the JAX
    package; it is opt-in there and here.
  * Under the mesh's model axis (``training.sharding``) ``forward`` runs on
    this rank's slices: ``first_conv``, each upsampler convolution (after
    its leaky ReLU), ``res_i``, ``post1`` and ``post2`` compute their slice
    of the output channels and gather the whole; ``dilated_i`` and
    ``cond_i`` compute this rank's slice of each gate half, with its slice
    of the whole ``g_i``'s term, so the gate runs on the rank's own
    channels and its output is gathered for ``res_i`` and ``skip_i`` (one
    ``copy_to_model`` for both where both split, and one for the upsampled
    conditioning of every ``cond_i``); ``skip_i``'s slices are summed over
    the layers and gathered once, ahead of ``post1``. The logits come out
    whole on every rank. The incremental paths run on a whole model only.
  * Under the mesh's pipe axis (``parallel.pipeline``) a stage holds the
    layers of its stacks and the rest whole, and runs ``forward``'s parts:
    ``_embed`` on stage 0, ``conditioning`` on every stage (the upsampled
    mels and the speaker embedding stay local), ``run_layers`` on its own
    layers with (h, skips) handed from stage to stage, ``head`` on the
    last stage.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import (
    Conv1d,
    ConvTranspose1dSame,
    gate,
    gather_split,
    init_weights,
    split_mesh,
)

__all__ = ["WaveNet", "ConditionUpsampler", "incremental_forward", "make_generate_fn",
           "make_chunked_generate_fn", "draw_noise"]

_LOG_SCALE_MIN = -32.23619130191664  # the MoL loss's floor on log-scales


def _dilations(layers: int, stacks: int) -> Sequence[int]:
    """Doubling within each stack (layers=24, stacks=4 -> 4 cycles of
    [1, 2, 4, 8, 16, 32])."""
    per_stack = layers // stacks
    return [2 ** (i % per_stack) for i in range(layers)]


class ConditionUpsampler(nn.Module):
    """Mel frames (B, T', C) -> per-sample conditioning (B, T' * prod, C):
    SAME transpose convs of kernel 2s and stride s, each followed by a
    leaky ReLU of slope 0.4."""

    def __init__(self, scales=(4, 4, 4, 4), channels: int = 80):
        super().__init__()
        self.scales = tuple(scales)
        for i, s in enumerate(self.scales):
            self.add_module(f"ConvTranspose_{i}", ConvTranspose1dSame(channels, channels, 2 * s, s))

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        x = c.transpose(1, 2)
        for i in range(len(self.scales)):
            conv = getattr(self, f"ConvTranspose_{i}")
            x = gather_split(F.leaky_relu(conv(x), 0.4), conv)
        return x.transpose(1, 2)


class WaveNet(nn.Module):
    """The reference hparams block's WaveNet (src/hparams.py:52-84).
    Weights are initialized from ``generator``: Xavier-uniform kernels,
    zero biases, N(0, 1/d) embedding tables."""

    def __init__(
        self,
        out_channels: int = 30,
        layers: int = 24,
        stacks: int = 4,
        residual_channels: int = 128,
        gate_channels: int = 128,
        skip_out_channels: int = 128,
        kernel_size: int = 3,
        cin_channels: int = 80,
        gin_channels: int = -1,
        n_speakers: int = 7,
        upsample_scales=(4, 4, 4, 4),
        scalar_input: bool = True,
        quantize_channels: int = 256,
        generator: torch.Generator | None = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.out_channels, self.layers, self.stacks = out_channels, layers, stacks
        self.residual_channels, self.gate_channels = residual_channels, gate_channels
        self.skip_out_channels, self.kernel_size = skip_out_channels, kernel_size
        self.cin_channels, self.gin_channels, self.n_speakers = cin_channels, gin_channels, n_speakers
        self.upsample_scales = tuple(upsample_scales)
        self.scalar_input, self.quantize_channels = scalar_input, quantize_channels
        self.dtype = dtype
        self.dilation_rates = tuple(_dilations(layers, stacks))
        r, g2 = residual_channels, gate_channels // 2

        def conv(cin, cout, k=1, **kw):
            return Conv1d(cin, cout, k, dtype=dtype, **kw)

        if not scalar_input:
            self.input_embed = nn.Embedding(quantize_channels, r)
        self.first_conv = conv(1 if scalar_input else r, r)
        for i, d in enumerate(self.dilation_rates):
            self.add_module(f"dilated_{i}", conv(r, gate_channels, kernel_size, dilation=d))
            self.add_module(f"res_{i}", conv(g2, r))
            self.add_module(f"skip_{i}", conv(g2, skip_out_channels))
        if cin_channels > 0:
            self.upsampler = ConditionUpsampler(self.upsample_scales, cin_channels)
            for i in range(layers):
                self.add_module(f"cond_{i}", conv(cin_channels, gate_channels, bias=False))
        if gin_channels > 0:
            self.speaker_embed = nn.Embedding(n_speakers, gin_channels)
            for i in range(layers):
                self.add_module(f"g_{i}", conv(gin_channels, gate_channels, bias=False))
        self.post1 = conv(skip_out_channels, skip_out_channels)
        self.post2 = conv(skip_out_channels, out_channels)
        init_weights(self, generator)
        for m in self.modules():
            if isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=1.0 / math.sqrt(m.embedding_dim),
                                generator=generator)

    def layer(self, kind: str, i: int) -> nn.Conv1d:
        return getattr(self, f"{kind}_{i}")

    @property
    def conditioned(self) -> bool:
        return self.cin_channels > 0

    @property
    def speakered(self) -> bool:
        return self.gin_channels > 0

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, 1) floats or (B, T) ints -> (B, R, T)."""
        if self.scalar_input:
            return self.first_conv(x.transpose(1, 2))
        return self.first_conv(self.input_embed(x).transpose(1, 2))

    def _gate_slice(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's slice of each half of a whole leaf's gate term (the
        speaker's (B, 2G, 1)), as ``dilated_i`` holds its channels; the
        term goes through ``copy_to_model`` first, so that the whole leaf's
        gradient sums every rank's slice."""
        mesh = split_mesh()
        size = y.shape[1] // (2 * mesh.n_model)
        halves = mesh.copy_to_model(y).unflatten(1, (2, -1))
        return halves.narrow(2, mesh.model_rank * size, size).flatten(1, 2)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Teacher-forced pass: x holds the inputs at t (the caller shifts
        targets, see ``shift_inputs``); c (B, T', cin) mels; g (B,) speaker
        ids. Returns (B, T, out_channels) float32 predictions."""
        h = gather_split(self._embed(x), self.first_conv)
        c_up, g_emb = self.conditioning(c, g, h.shape[-1])
        _, skips = self.run_layers(h, 0.0, c_up, g_emb, range(self.layers))
        return self.head(skips)

    def conditioning(self, c: Optional[torch.Tensor], g: Optional[torch.Tensor], t: int):
        """(the upsampled conditioning (B, cin, t) or None, the speaker
        embedding (B, gin, 1) or None): what every layer reads and none
        writes."""
        c_up = None
        if c is not None and self.conditioned:
            c_up = self.upsampler(c)[:, :t].transpose(1, 2)  # (B, C, T)
        g_emb = None
        if g is not None and self.speakered:
            g_emb = self.speaker_embed(g)[:, :, None]  # (B, gin, 1)
        return c_up, g_emb

    def run_layers(self, h: torch.Tensor, skips, c_up: Optional[torch.Tensor],
                   g_emb: Optional[torch.Tensor], layers) -> tuple[torch.Tensor, torch.Tensor]:
        """The residual layers ``layers`` (indices, in order) on (h (B, R,
        T), the running skip sum): (h, skips) after them. ``forward`` runs
        them all; a pipeline stage runs its own."""
        # each gate on this rank's channels; the conditioning, and each gate's
        # gathered output where res_i and skip_i both split, enter the model
        # group once, so that one all-reduce sums their input gradients
        first = layers[0]
        split = self.layer("dilated", first).model_split
        shared = (split and self.layer("res", first).model_split
                  and self.layer("skip", first).model_split)
        mesh = split_mesh() if split else None
        if split and c_up is not None:
            c_up = mesh.copy_to_model(c_up)
        k = self.kernel_size
        for i in layers:
            d = self.dilation_rates[i]
            z = self.layer("dilated", i)(F.pad(h, ((k - 1) * d, 0)))
            if c_up is not None:
                z = z + self.layer("cond", i)(c_up, copied=split)
            if g_emb is not None:
                g_term = self.layer("g", i)(g_emb)
                z = z + (self._gate_slice(g_term) if split else g_term)
            gated = gate(z, 1)
            if split:
                gated = mesh.gather_channels(gated)
            if shared:
                gated = mesh.copy_to_model(gated)
            skips = skips + self.layer("skip", i)(gated, copied=shared)
            res = self.layer("res", i)
            h = h + gather_split(res(gated, copied=shared), res)
        return h, skips

    def head(self, skips: torch.Tensor) -> torch.Tensor:
        """The skip sum (B, S, T) -> (B, T, out_channels) float32 predictions
        through ``post1`` and ``post2`` (a bf16 sum is widened to the
        parameters' dtype first: the pipeline's bf16 stages feed a float32
        head)."""
        out = torch.relu(gather_split(skips, getattr(self, "skip_0", None)))
        out = out.to(self.post1.weight.dtype)
        out = gather_split(torch.relu(self.post1(out)), self.post1)
        return gather_split(self.post2(out), self.post2).float().transpose(1, 2)

    @staticmethod
    def shift_inputs(targets: torch.Tensor, scalar: bool) -> torch.Tensor:
        """Teacher forcing: the input at step t is the target at t - 1."""
        if scalar:
            return F.pad(targets[:, :-1], (0, 0, 1, 0))
        return F.pad(targets[:, :-1], (1, 0))


# ---------------------------------------------------------------------------
# Incremental generation
# ---------------------------------------------------------------------------


def _kernel_kio(conv: nn.Conv1d) -> torch.Tensor:
    """Conv1d weight (out, in, K) -> the flax layout (K, in, out)."""
    return conv.weight.permute(2, 1, 0)


def _stack_step_params(model: WaveNet, dtype=None) -> dict:
    """Per-layer weights stacked into (L, ...) tensors, once per generate
    call, so a step runs a few batched products instead of ~6 small ones per
    layer."""
    L, K = model.layers, model.kernel_size

    def stack(kind, fn):
        return torch.stack([fn(model.layer(kind, i)) for i in range(L)])

    dil = stack("dilated", _kernel_kio)  # (L, K, R, G)
    s = {
        "w_cur": dil[:, K - 1],
        "w_tap": dil[:, : K - 1].transpose(0, 1),  # (K-1, L, R, G)
        "b_dil": stack("dilated", lambda m: m.bias),
        "w_skip": stack("skip", lambda m: _kernel_kio(m)[0]),  # (L, G/2, S)
        "b_skip": stack("skip", lambda m: m.bias),
        "w_res": stack("res", lambda m: _kernel_kio(m)[0]),  # (L, G/2, R)
        "b_res": stack("res", lambda m: m.bias),
    }
    if model.conditioned:
        s["w_cond"] = stack("cond", lambda m: _kernel_kio(m)[0])  # (L, C, G)
    if model.speakered:
        s["w_g"] = stack("g", lambda m: _kernel_kio(m)[0])  # (L, gin, G)
    if dtype is not None:
        s = {k: v.to(dtype) for k, v in s.items()}
    return s


def _ring_depth(model: WaveNet) -> int:
    k = model.kernel_size
    return (k - 1) * max(model.dilation_rates) if k > 1 else 1


def _step_core(model: WaveNet, dtype=None):
    """One timestep with a fused rolling buffer: ``step(h, buf, c_t, g_emb)
    -> (logits, new_buf)``, h the embedded current input (B, R) and buf ONE
    (L, B, rmax, R) ring of past layer inputs. The taps of all layers come
    out of the ring with one gather and one einsum, the conditioning of all
    layers with one einsum; only the residual chain is sequential."""
    K, L = model.kernel_size, model.layers
    stacked = _stack_step_params(model, dtype)
    rmax = _ring_depth(model)
    dev = stacked["w_cur"].device
    # tap_idx[j, l]: ring slot of tap j of layer l
    tap_idx = torch.tensor(
        [[rmax - d * (K - 1 - j) for d in model.dilation_rates] for j in range(K - 1)],
        dtype=torch.long, device=dev)
    layer_idx = torch.arange(L, device=dev)[None, :]
    w_post1, b_post1 = model.post1.weight[:, :, 0], model.post1.bias
    w_post2, b_post2 = model.post2.weight[:, :, 0], model.post2.bias
    b_skip = stacked["b_skip"].sum(0)

    def step(h, buf, c_t, g_emb):
        if dtype is not None:
            h = h.to(dtype)
        if K > 1:
            taps = buf[layer_idx, :, tap_idx]  # (K-1, L, B, R)
            pre = torch.einsum("jlbr,jlrg->lbg", taps, stacked["w_tap"])
        else:
            pre = 0.0
        pre = pre + stacked["b_dil"][:, None, :]
        if c_t is not None:
            pre = pre + torch.einsum("bc,lcg->lbg", c_t.to(h.dtype), stacked["w_cond"])
        if g_emb is not None:
            pre = pre + torch.einsum("bc,lcg->lbg", g_emb.to(h.dtype), stacked["w_g"])
        h_ins, gateds = [], []
        for i in range(L):
            h_ins.append(h)
            z = h @ stacked["w_cur"][i] + pre[i]
            a, b = z.chunk(2, dim=-1)
            gated = torch.tanh(a) * torch.sigmoid(b)
            gateds.append(gated)
            h = h + gated @ stacked["w_res"][i] + stacked["b_res"][i]
        skips = torch.einsum("lbg,lgs->bs", torch.stack(gateds), stacked["w_skip"]) + b_skip
        new_buf = torch.cat([buf[:, :, 1:], torch.stack(h_ins)[:, :, None]], dim=2)
        out = torch.relu(skips.float())
        out = torch.relu(F.linear(out, w_post1, b_post1))
        return F.linear(out, w_post2, b_post2), new_buf

    return step


def _embed_one(model: WaveNet, x_t: torch.Tensor) -> torch.Tensor:
    """One input sample, (B, 1) float or (B,) int -> (B, R)."""
    w, b = model.first_conv.weight[:, :, 0].T, model.first_conv.bias
    if model.scalar_input:
        return x_t @ w + b
    return model.input_embed(x_t) @ w + b


def _init_buffers(model: WaveNet, batch_size: int, dtype=None, device=None) -> torch.Tensor:
    """One fused (L, B, rmax, R) ring of past layer inputs."""
    return torch.zeros(model.layers, batch_size, _ring_depth(model), model.residual_channels,
                       dtype=dtype or torch.float32, device=device)


def _init_prev(model: WaveNet, batch_size: int, device) -> torch.Tensor:
    if model.scalar_input:
        return torch.zeros(batch_size, 1, device=device)
    return torch.zeros(batch_size, dtype=torch.long, device=device)


def _upsample_cond(model: WaveNet, c):
    if c is None or not model.conditioned:
        return None
    return model.upsampler(c)


def _embed_speaker(model: WaveNet, g):
    if g is None or not model.speakered:
        return None
    return model.speaker_embed(g)


def sample_mol(logits: torch.Tensor, gum_t: torch.Tensor, u_t: torch.Tensor) -> torch.Tensor:
    """Mixture-of-logistics sampling from (B, 3n) logits with pre-drawn
    noise: Gumbel-max mixture choice (the first index on ties), the chosen
    lane's mean and log-scale (floored at ``_LOG_SCALE_MIN``), the
    inverse-CDF logistic, clipped to [-1, 1]. (B,) float32."""
    logit_probs, means, log_scales = logits.chunk(3, dim=-1)
    comp = torch.argmax(logit_probs + gum_t, dim=-1, keepdim=True)
    mean = torch.gather(means, -1, comp)[..., 0]
    log_scale = torch.clamp(torch.gather(log_scales, -1, comp)[..., 0], min=_LOG_SCALE_MIN)
    x = mean + torch.exp(log_scale) * (torch.log(u_t) - torch.log1p(-u_t))
    return torch.clamp(x, -1.0, 1.0)


def _sample_from_logits(model: WaveNet, logits, gum_t, u_t):
    """One sampling step with pre-drawn noise: MoL for scalar input,
    Gumbel-max over categorical logits otherwise. Returns (out, next_input).
    The one body of every sampler: chunked output equals monolithic output
    bit for bit because both run it."""
    if model.scalar_input:
        out = sample_mol(logits, gum_t, u_t)
        return out, out[:, None]
    out = torch.argmax(logits + gum_t, dim=-1)
    return out, out


def draw_noise(model: WaveNet, generator: torch.Generator, length: int,
               batch_size: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """All sampling noise as one scan-major draw on the generator's device:
    gumbel (T, B, n_mix) and uniform (T, B) in [1e-5, 1 - 1e-5] for MoL;
    gumbel (T, B, out) and zeros for categorical output."""
    dev = generator.device
    n = model.out_channels // 3 if model.scalar_input else model.out_channels
    u = torch.rand(length, batch_size, n, generator=generator, device=dev)
    gum = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    if model.scalar_input:
        unif = 1e-5 + (1.0 - 2e-5) * torch.rand(length, batch_size, generator=generator, device=dev)
    else:
        unif = torch.zeros(length, batch_size, device=dev)
    return gum, unif


def _device(model: WaveNet) -> torch.device:
    return model.first_conv.weight.device


@torch.no_grad()
def incremental_forward(model: WaveNet, x, c=None, g=None) -> torch.Tensor:
    """Teacher-forced evaluation through the incremental buffered path:
    logits equal to ``model(x, c, g)`` (the equivalence test of the
    generation ring). x: (B, T, 1) floats or (B, T) ints."""
    step = _step_core(model)
    c_up = _upsample_cond(model, c)
    g_emb = _embed_speaker(model, g)
    buf = _init_buffers(model, x.shape[0], device=x.device)
    out = []
    for t in range(x.shape[1]):
        h = _embed_one(model, x[:, t])
        logits, buf = step(h, buf, c_up[:, t] if c_up is not None else None, g_emb)
        out.append(logits)
    return torch.stack(out, dim=1)


def _run_steps(model, step, state, c_seq, gum, unif, g_emb):
    """Steps over a block of len(gum) samples from ``state`` = (prev, buf):
    the loop body the monolithic and chunked samplers share."""
    prev, buf = state
    outs = []
    for t in range(gum.shape[0]):
        h = _embed_one(model, prev)
        logits, buf = step(h, buf, c_seq[:, t] if c_seq is not None else None, g_emb)
        out, prev = _sample_from_logits(model, logits, gum[t], unif[t])
        outs.append(out)
    return (prev, buf), torch.stack(outs, dim=1)


def make_generate_fn(model: WaveNet, length: int, dtype=None,
                     use_kernel: Optional[bool] = None):
    """An ancestral sampler: ``generate(c, g=None, generator=None,
    batch_size=1, noise=None) -> (B, length)`` samples (floats in [-1, 1]
    for MoL output, ints for categorical), drawing its noise from
    ``generator`` (on the model's device) unless ``noise`` = (gumbel,
    uniform) is given in ``draw_noise``'s layout.

    The default path is the per-step scan with stacked weights.
    ``dtype=torch.bfloat16`` runs its products, residual state and ring in
    bf16; the head and the sampling stay float32. ``use_kernel=True`` opts
    into the whole-loop CUDA kernel for batch-1, mel-conditioned, MoL
    generation at the shapes ``generate_supported`` accepts; other calls take
    the scan path. The JAX signature's ``unroll`` is dropped: PyTorch runs
    the loop eagerly."""

    @torch.no_grad()
    def generate(c, g=None, generator=None, batch_size: int = 1, noise=None):
        step = _step_core(model, dtype)
        c_up = _upsample_cond(model, c)
        g_emb = _embed_speaker(model, g)
        gum, unif = noise if noise is not None else draw_noise(
            model, generator, length, batch_size)
        dev = _device(model)
        state = (_init_prev(model, batch_size, dev),
                 _init_buffers(model, batch_size, dtype, dev))
        _, samples = _run_steps(model, step, state, c_up, gum, unif, g_emb)
        return samples

    if not use_kernel:
        return generate
    from neural_sound_generation_tpu_torch.ops.cuda import wavenet_gen

    assert wavenet_gen.generate_supported(model, 1), (
        "use_kernel=True but the model shapes don't qualify "
        "(see ops/cuda/wavenet_gen.generate_supported)")

    @torch.no_grad()
    def dispatch(c, g=None, generator=None, batch_size: int = 1, noise=None):
        if batch_size == 1 and g is None and c is not None:
            c_up = _upsample_cond(model, c)[0]
            gum, unif = noise if noise is not None else draw_noise(model, generator, length, 1)
            packed = wavenet_gen.pack_weights(model)
            return wavenet_gen.wavenet_generate(packed, c_up, gum[:, 0], unif[:, 0], length)[None]
        return generate(c, g, generator, batch_size, noise)

    return dispatch


def make_chunked_generate_fn(model: WaveNet, chunk: int, dtype=None):
    """Streaming ancestral sampler: the generation state (previous sample
    and the fused ring) carries across fixed-size chunk calls, so one
    sampler serves utterances of any length and emits audio as it goes.

    Returns ``(init_state, step_chunk, stream)``:

    * ``init_state(batch_size)`` -> (prev, ring) on the model's device;
    * ``step_chunk(state, c_up_chunk, gum, unif, g_emb)`` -> (state,
      (B, chunk) samples), with ``c_up_chunk`` the (B, chunk, C) slice of the
      upsampled conditioning and the noise of these steps;
    * ``stream(c, g=None, generator=None, batch_size=1, noise=None)`` -> a
      generator of (B, chunk) blocks until the mel-determined length is
      covered, the last block trimmed. The noise is drawn once for the whole
      length, as the monolithic sampler draws it; padded steps take gumbel 0
      and uniform 0.5. Bit-identical to ``make_generate_fn(model, length,
      dtype)`` with the same noise.

    As in ``make_generate_fn``, there is no ``unroll``."""
    dev = _device(model)

    def init_state(batch_size: int = 1):
        return _init_prev(model, batch_size, dev), _init_buffers(model, batch_size, dtype, dev)

    @torch.no_grad()
    def step_chunk(state, c_chunk, gum, unif, g_emb):
        step = _step_core(model, dtype)
        return _run_steps(model, step, state, c_chunk if model.conditioned else None,
                          gum, unif, g_emb)

    @torch.no_grad()
    def stream(c, g=None, generator=None, batch_size: int = 1, noise=None):
        c_up = _upsample_cond(model, c)
        if c_up is None:
            raise ValueError(
                "stream() needs local conditioning to bound the length; "
                "drive step_chunk directly for unconditioned streams")
        g_emb = _embed_speaker(model, g)
        length = int(c_up.shape[1])
        gum, unif = noise if noise is not None else draw_noise(
            model, generator, length, batch_size)
        n_chunks = -(-length // chunk)
        pad = n_chunks * chunk - length
        if pad:
            c_up = F.pad(c_up, (0, 0, 0, pad))
            gum = F.pad(gum, (0, 0) * (gum.ndim - 1) + (0, pad))
            # padded uniforms stay inside (0, 1): log(u), log1p(-u)
            unif = F.pad(unif, (0, 0, 0, pad), value=0.5)
        state = init_state(batch_size)
        for i in range(n_chunks):
            sl = slice(i * chunk, (i + 1) * chunk)
            state, out = step_chunk(state, c_up[:, sl], gum[sl], unif[sl], g_emb)
            yield out[:, : min(chunk, length - i * chunk)]

    return init_state, step_chunk, stream

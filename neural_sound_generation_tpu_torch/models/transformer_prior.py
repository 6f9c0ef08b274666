"""Autoregressive Transformer prior over VQ code grids.

Counterpart of ``neural_sound_generation_tpu/models/transformer_prior.py``:
a class-conditioned decoder-only Transformer over (H, W) code grids in
raster order. Position t predicts ``codes[t]`` from ``codes[:t]``: its input
is the embedding of ``codes[t-1]`` (a learned ``bos`` vector at t = 0) plus
factored row/column positional embeddings and the class embedding.

The modules carry the flax names (``tok_embed``, ``block_0.attn_qkv``,
``ln_f``, the top-level ``bos``), so ``convert.py`` maps one tree onto the
other by name. flax's defaults are kept where PyTorch's differ: LayerNorm's
epsilon is 1e-6, ``nn.gelu`` is the tanh approximation, Dense kernels are
LeCun-normal (truncated) with zero biases, Embed tables N(0, 1/dim).

Teacher-forced training runs ``ops/attention.causal_attention`` (the flash
kernels on the card). Sampling runs one position at a time through a KV
cache in the compute dtype (``decode_step``), with plain attention over the
filled prefix. ``generate`` draws with the Gumbel-max trick:
argmax(logits / temperature + Gumbel), which is how ``jax.random.
categorical`` draws; the noise comes from an explicit ``torch.Generator``
or, for the tests, is injected.

A spatially conditioned prior (``spatial_cond``, the hierarchical bottom
level) adds ``cond_proj`` of a per-position conditioning map of
``cond_dim`` channels to every position's input, on the teacher-forced path
and on the decode step.

Compute dtype (``dtype``, flax's per-module ``dtype``; bfloat16 under
``cli.prior --bf16``): parameters stay float32 and so does the residual
stream. Each LayerNorm runs in float32 and its output is rounded to the
compute dtype; the Dense layers (``layers.Linear``) and the attention run
in it, and each block's attention and MLP outputs are cast back to float32
before the residual add. The head rounds its logits to the compute dtype
before they return as float32. The embeddings and ``cond_proj`` stay
float32, as flax's ``Embed`` and the undtyped ``Dense`` do. The KV caches
are in the compute dtype; the cached step's attention weights are rounded
to it and P V accumulates in float32.

``n_experts > 0`` swaps every block's dense MLP for a switch-routed
``SwitchMoE`` (``models/moe.py``, flax name ``block_i.moe``): top-1 routing
with a per-row capacity of ``ceil(capacity_factor * T / n_experts)`` tokens
an expert. ``forward(..., return_moe_aux=True)`` also returns each block's
load-balance term, which the trainer adds to the NLL. The decode step then
carries per-block (B, E) counts of dispatched tokens beside the KV cache
and takes the capacity of the full sequence (``moe_cap``), so the sampler
drops exactly the tokens the teacher-forced forward drops.

Tensor parallelism (the mesh's model axis; ``training.sharding`` places
the state, Megatron's layout): each block's ``attn_qkv`` holds the q, k
and v columns of its rank's heads and ``mlp_in`` a slice of the hidden
features (column splits, which take the whole input through
``Mesh.copy_to_model``); kernel 4 runs on the rank's heads; ``attn_out``
and ``mlp_out`` hold the matching input slices (row splits, whose partial
products ``Mesh.reduce_from_model`` sums before the bias). Where the heads
do not divide over the ranks the attention stays whole on every rank. The
embeddings, ``cond_proj`` and ``head`` hold a slice of their feature axis:
``embed_sequence`` adds the rank's slices (the replicated ``bos``'s too)
and gathers the sum once, the head's vocabulary slices are gathered before
the loss. The residual stream and the LayerNorms are whole on every rank.
A routed block splits its experts (``models/moe.py``). The KV-cached decode
and ``generate`` run the whole model on one rank: sampling restores a whole
checkpoint.

Pipeline parallelism (the mesh's pipe axis, ``parallel.pipeline``): a
stage holds the blocks of its layers and the rest whole; stage 0 runs
``embed_sequence`` on each microbatch, every stage its ``_Block``s (a
routed block returning its rows' statistics, ``per_row``), the last stage
``head_logits`` on the whole batch.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from neural_sound_generation_tpu_torch.models.layers import Linear, gelu, split_mesh
from neural_sound_generation_tpu_torch.models.moe import SwitchMoE
from neural_sound_generation_tpu_torch.ops.attention import causal_attention

__all__ = ["TransformerPrior", "generate", "incremental_logits", "init_caches"]

#: flax nn.LayerNorm's epsilon (PyTorch's default is 1e-5)
LAYER_NORM_EPS = 1e-6
# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class _Block(nn.Module):
    """Pre-LN transformer block: causal self-attention and an MLP, dense
    (``mlp_in``/``mlp_out``) or switch-routed (``moe``) for n_experts > 0,
    in the compute ``dtype`` on a float32 residual stream."""

    def __init__(self, dim: int, n_heads: int, mlp_ratio: int = 4, n_experts: int = 0,
                 capacity_factor: float = 1.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} is not divisible by {n_heads} heads")
        self.dim, self.n_heads, self.compute_dtype = dim, n_heads, dtype
        self.ln1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.ln2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn_qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.attn_out = Linear(dim, dim, dtype=dtype)
        if n_experts > 0:
            self.moe = SwitchMoE(dim, n_experts, mlp_ratio, capacity_factor, dtype=dtype)
        else:
            self.mlp_in = Linear(dim, mlp_ratio * dim, dtype=dtype)
            self.mlp_out = Linear(mlp_ratio * dim, dim, dtype=dtype)
        self.routed = n_experts > 0

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def _mlp(self, h: torch.Tensor) -> torch.Tensor:
        return self.mlp_out(gelu(self.mlp_in(h)))

    def forward(self, x: torch.Tensor,
                per_row: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
        """x: (B, T, D); causal self-attention over T. Returns (x, the
        routed MLP's load-balance term, or None for a dense block); with
        ``per_row`` the routed MLP's per-row statistics (B, 2, E) in place
        of the term (``SwitchMoE.forward``)."""
        b, t, _ = x.shape
        hd, dt = self.head_dim, self.compute_dtype
        # this rank's heads' width: all of D unless the model axis split them
        d = self.attn_qkv.weight.shape[0] // 3
        q, k, v = self.attn_qkv(self.ln1(x).to(dt)).split(d, dim=-1)
        # (B, H, T, hd), the layout causal_attention takes
        q, k, v = (z.reshape(b, t, d // hd, hd).transpose(1, 2) for z in (q, k, v))
        o = causal_attention(q, k, v, scale=1.0 / math.sqrt(hd))
        x = x + self.attn_out(o.transpose(1, 2).reshape(b, t, d)).to(x.dtype)
        if self.routed:
            y, aux = self.moe(self.ln2(x).to(dt), per_row=per_row)
            return x + y.to(x.dtype), aux
        return x + self._mlp(self.ln2(x).to(dt)).to(x.dtype), None

    def decode_step(self, x: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                    t: int, moe_counts: torch.Tensor | None = None,
                    moe_cap: int = 0) -> torch.Tensor:
        """One position with a KV cache: x (B, D) is the input at position
        t; k_cache/v_cache (B, T, H, hd) hold positions < t and get
        position t written in place. A routed block also updates
        ``moe_counts`` (B, E) int32 in place and drops at ``moe_cap``, the
        full sequence's capacity. Returns y (B, D)."""
        b, d = x.shape
        hd, dt = self.head_dim, self.compute_dtype
        q, k, v = self.attn_qkv(self.ln1(x).to(dt)).split(d, dim=-1)
        k_cache[:, t] = k.reshape(b, self.n_heads, hd)
        v_cache[:, t] = v.reshape(b, self.n_heads, hd)
        # the filled prefix only: the JAX step masks positions > t to -inf
        # over the whole cache, which adds exact zeros to the same sums.
        # The weights are rounded to the compute dtype, P V sums in float32
        att = torch.einsum("bhd,bkhd->bhk", q.reshape(b, self.n_heads, hd).float(),
                           k_cache[:, : t + 1].float()) * (1.0 / math.sqrt(hd))
        att = torch.softmax(att, dim=-1).to(dt)
        o = torch.einsum("bhk,bkhd->bhd", att.float(), v_cache[:, : t + 1].float())
        x = x + self.attn_out(o.reshape(b, d)).to(x.dtype)
        if self.routed:
            return x + self.moe.step(self.ln2(x).to(dt), moe_counts, moe_cap).to(x.dtype)
        return x + self._mlp(self.ln2(x).to(dt)).to(x.dtype)


class TransformerPrior(nn.Module):
    """Decoder-only Transformer over (H, W) code grids:
    ``(codes (B, H, W) int, label (B,) int) -> logits (B, H, W, input_dim)``
    float32, computed in ``dtype`` (float32 or bfloat16; the parameters are
    float32 either way). Weights are initialized from ``generator``."""

    #: set by ``training.sharding``: the embeddings and ``cond_proj`` hold a
    #: slice of the feature axis
    embed_split = False

    def __init__(
        self,
        input_dim: int = 512,
        dim: int = 256,
        n_layers: int = 6,
        n_heads: int = 4,
        n_classes: int = 10,
        mlp_ratio: int = 4,
        n_experts: int = 0,
        capacity_factor: float = 1.25,
        spatial_cond: bool = False,
        cond_dim: int = 0,
        max_rows: int = 64,
        max_cols: int = 64,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if spatial_cond and cond_dim <= 0:
            raise ValueError("a spatially conditioned prior needs cond_dim > 0")
        self.input_dim, self.dim, self.n_layers = input_dim, dim, n_layers
        self.n_heads, self.n_classes = n_heads, n_classes
        self.n_experts, self.compute_dtype = n_experts, dtype
        self.spatial_cond, self.cond_dim = spatial_cond, cond_dim
        self.max_rows, self.max_cols = max_rows, max_cols
        self.tok_embed = nn.Embedding(input_dim, dim)
        self.class_embed = nn.Embedding(n_classes, dim)
        self.bos = nn.Parameter(torch.empty(dim))
        self.row_embed = nn.Embedding(max_rows, dim)
        self.col_embed = nn.Embedding(max_cols, dim)
        self.cond_proj = nn.Linear(cond_dim, dim) if spatial_cond else None
        for i in range(n_layers):
            self.add_module(f"block_{i}",
                            _Block(dim, n_heads, mlp_ratio, n_experts, capacity_factor, dtype))
        self.ln_f = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.head = Linear(dim, input_dim, dtype=dtype)
        self.reset_parameters(generator)

    @property
    def blocks(self) -> list[_Block]:
        return [getattr(self, f"block_{i}") for i in range(self.n_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Linear):
                std = m.in_features**-0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, m.embedding_dim**-0.5, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, SwitchMoE):
                # flax's lecun_normal on (E, fan, out) counts E as a
                # receptive field: fan-in E * D for w_in, E * F for w_out
                for w in (m.w_in, m.w_out):
                    std = (w.shape[0] * w.shape[1])**-0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                          generator=generator)
                nn.init.zeros_(m.b_in)
                nn.init.zeros_(m.b_out)
        self.bos.normal_(0.0, 0.02, generator=generator)

    def _pos_table(self, h: int, w: int) -> torch.Tensor:
        if h > self.max_rows or w > self.max_cols:
            raise ValueError(
                f"code grid {(h, w)} exceeds positional tables "
                f"({self.max_rows}, {self.max_cols}); raise max_rows/max_cols")
        rows = self.row_embed.weight[:h]
        cols = self.col_embed.weight[:w]
        return (rows[:, None, :] + cols[None, :, :]).reshape(h * w, -1)

    def _cond(self, cond: torch.Tensor | None) -> torch.Tensor:
        """``cond_proj`` of the conditioning at one or every position."""
        if cond is None:
            raise ValueError("spatial_cond model needs cond_map")
        return self.cond_proj(cond.to(self.cond_proj.weight.dtype))

    def embed_sequence(self, codes: torch.Tensor, label: torch.Tensor,
                       cond_map: torch.Tensor | None = None) -> torch.Tensor:
        """Shifted token embeddings + positional + class (+ spatial
        conditioning, ``cond_map`` (B, H, W, Cc)): (B, H, W) -> (B, T, D)."""
        b, h, w = codes.shape
        tok = self.tok_embed(codes.reshape(b, h * w).long())
        bos = self._bos().expand(b, 1, tok.shape[-1]).to(tok.dtype)
        x = torch.cat([bos, tok[:, :-1]], dim=1)
        x = x + self._pos_table(h, w)[None]
        x = x + self.class_embed(label.long())[:, None, :]
        if self.spatial_cond:
            x = x + self._cond(None if cond_map is None else cond_map.reshape(b, h * w, -1))
        # the rank's feature slices of the sum -> the whole residual stream
        return split_mesh().gather_channels(x, dim=-1) if self.embed_split else x

    def _bos(self) -> torch.Tensor:
        """``bos``, or under a feature split this rank's slice of it, taken
        through ``copy_to_model``: the replicated leaf's gradient is then
        the model group's sum of the slices' (zero elsewhere), the whole one."""
        if not self.embed_split:
            return self.bos
        mesh, c = split_mesh(), self.tok_embed.weight.shape[1]
        return mesh.copy_to_model(self.bos).narrow(0, mesh.model_rank * c, c)

    def head_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final LayerNorm + vocab head: (..., D) -> (..., K) float32, rounded
        to the compute dtype first (under a vocabulary split, the model
        group's slices gathered)."""
        y = self.head(self.ln_f(x).to(self.compute_dtype))
        if self.head.model_split:
            y = split_mesh().gather_channels(y, dim=-1)
        return y.float()

    def forward(self, codes: torch.Tensor, label: torch.Tensor,
                cond_map: torch.Tensor | None = None, return_moe_aux: bool = False):
        """Logits (B, H, W, K) float32; with ``return_moe_aux``, (logits,
        the routed blocks' load-balance terms in block order)."""
        b, h, w = codes.shape
        x = self.embed_sequence(codes, label, cond_map)
        aux = []
        for blk in self.blocks:
            x, a = blk(x)
            if a is not None:
                aux.append(a)
        logits = self.head_logits(x).reshape(b, h, w, self.input_dim)
        return (logits, aux) if return_moe_aux else logits

    def embed_step(self, prev_tok: torch.Tensor, label: torch.Tensor, t: int, h: int,
                   w: int, cond_row: torch.Tensor | None = None) -> torch.Tensor:
        """Input at position t while sampling: the previous token's
        embedding (``bos`` at t = 0) + pos[t] + class (+ ``cond_proj`` of
        ``cond_row`` (B, Cc), the conditioning at t). prev_tok (B,) -> (B, D)."""
        if t == 0:
            x = self.bos.expand(prev_tok.shape[0], self.dim)
        else:
            x = self.tok_embed(prev_tok.long())
        r, c = divmod(t, w)
        x = x + self.row_embed.weight[r] + self.col_embed.weight[c]
        x = x + self.class_embed(label.long())
        if self.spatial_cond:
            x = x + self._cond(cond_row)
        return x

    def decode_step(self, x: torch.Tensor, caches, t: int, moe_cap: int = 0):
        """One cached position through all blocks: (logits (B, K) float32,
        caches), the caches updated in place. A block's cache is (k, v),
        or (k, v, counts) for a routed model, whose ``moe_cap`` must be the
        capacity of the full sequence (``_moe_cap``)."""
        for blk, (k_cache, v_cache, *counts) in zip(self.blocks, caches):
            x = blk.decode_step(x, k_cache, v_cache, t, *counts, moe_cap=moe_cap)
        return self.head_logits(x), caches


def init_caches(model: TransformerPrior, batch: int, t: int):
    """Per block a zero (k, v) pair of (batch, t, H, hd) in the compute
    dtype (the qkv projection's), on the model's device; a routed model's
    blocks add zero (batch, E) int32 counts of dispatched tokens."""
    device, dt = model.head.weight.device, model.compute_dtype
    shape = (batch, t, model.n_heads, model.dim // model.n_heads)

    def cache():
        kv = (torch.zeros(shape, dtype=dt, device=device),
              torch.zeros(shape, dtype=dt, device=device))
        if model.n_experts > 0:
            return kv + (torch.zeros(batch, model.n_experts, dtype=torch.int32,
                                     device=device),)
        return kv

    return tuple(cache() for _ in range(model.n_layers))


def _moe_cap(model: TransformerPrior, t: int) -> int:
    """The routed blocks' capacity at sequence length t (0 when dense): what
    the cached decode must drop at to match teacher forcing."""
    return model.block_0.moe.capacity(t) if model.n_experts > 0 else 0


def gumbel_noise(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) with U in [tiny, 1), as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.inference_mode()
def generate(
    model: TransformerPrior,
    label: torch.Tensor,
    generator: torch.Generator | None = None,
    shape: tuple[int, int] = (8, 8),
    batch_size: int = 64,
    temperature: float = 1.0,
    gumbel: torch.Tensor | None = None,
    cond_map: torch.Tensor | None = None,
) -> torch.Tensor:
    """KV-cached ancestral sampling of (batch_size, H, W) int32 code grids.

    Position t draws argmax(logits / temperature + G_t). ``gumbel``, when
    given, is the (T, B, K) noise; otherwise it is drawn from
    ``generator`` (on the model's device) one position at a time.
    ``cond_map`` (B, H, W, Cc) conditions a ``spatial_cond`` prior."""
    h, w = shape
    t_len = h * w
    device = model.head.weight.device
    label = label.to(device)
    cond = _cond_rows(cond_map, batch_size, t_len, device)
    caches = init_caches(model, batch_size, t_len)
    cap = _moe_cap(model, t_len)
    prev = torch.zeros(batch_size, dtype=torch.long, device=device)
    out = torch.empty(batch_size, t_len, dtype=torch.int32, device=device)
    for t in range(t_len):
        x = model.embed_step(prev, label, t, h, w, None if cond is None else cond[:, t])
        logits, caches = model.decode_step(x, caches, t, cap)
        noise = gumbel[t].to(device) if gumbel is not None else gumbel_noise(
            logits.shape, generator, device)
        prev = torch.argmax(logits / temperature + noise, dim=-1)
        out[:, t] = prev
    return out.reshape(batch_size, h, w)


def _cond_rows(cond_map: torch.Tensor | None, b: int, t_len: int, device):
    """(B, H, W, Cc) -> (B, T, Cc) on ``device``, or None."""
    return None if cond_map is None else cond_map.to(device).reshape(b, t_len, -1)


@torch.inference_mode()
def incremental_logits(model: TransformerPrior, codes: torch.Tensor,
                       label: torch.Tensor, cond_map: torch.Tensor | None = None) -> torch.Tensor:
    """Teacher-forced logits through the cached decode path, the sampler's
    parity oracle: (B, H, W) codes -> (B, H, W, K) float32."""
    b, h, w = codes.shape
    t_len = h * w
    seq = codes.reshape(b, t_len)
    cond = _cond_rows(cond_map, b, t_len, codes.device)
    caches = init_caches(model, b, t_len)
    cap = _moe_cap(model, t_len)
    out = []
    for t in range(t_len):
        x = model.embed_step(seq[:, max(t - 1, 0)], label, t, h, w,
                             None if cond is None else cond[:, t])
        logits, caches = model.decode_step(x, caches, t, cap)
        out.append(logits)
    return torch.stack(out, dim=1).reshape(b, h, w, model.input_dim)

"""Whole-loop WaveNet generation: the CUDA kernel's wrapper and its plain version.

Counterpart of ``neural_sound_generation_tpu/ops/pallas/wavenet_gen.py``.
The kernel (``csrc/wavenet_gen.cu``) runs the entire batch-1 autoregressive
loop of a mel-conditioned MoL WaveNet in one launch: per step the
conditioning row times every layer's cond weights, the gated residual chain
over the layers with their taps read from a ring of past layer inputs, the
skip sum, the two-layer head and the mixture-of-logistics sample, which
feeds the next step. A teacher-forced variant (a template flag of the same
kernel) reads given inputs instead of its own samples and writes the
per-step logits.

What it computes, with its rounding points (those of the Pallas kernel):

  * weights packed once (``pack_weights``): ``w_in`` = [w_cur; tap_0 ...
    tap_{K-2}] (L, K*R, G), ``w_sr`` = [w_skip | w_res] (L, G/2, S+R),
    ``w_cdot`` (C, L*G), ``w_post1`` (S, S) and ``w_post2`` (S, out padded
    to a multiple of 8) in bf16; f32 biases, ``b_skip`` summed over layers;
    ``w_first``, ``b_first`` in f32;
  * a step: condz = c_up[t] (bf16) @ w_cdot; per layer z = [h | taps] @
    w_in + b_dil + condz, gated = bf16(tanh(z[:G/2]) * sigmoid(z[G/2:])),
    sr = gated @ w_sr, skips += sr[:S], the ring takes h (the layer's input),
    h = bf16(h + sr[S:] + b_res); out = relu(skips + b_skip), o1 =
    relu(bf16(out) @ post1 + b), logits = bf16(o1) @ post2 + b;
  * sampling: Gumbel-max over the first n_mix logits (first index on ties),
    the chosen lane's mean and log-scale (floored at the MoL minimum), u
    clipped to [1e-5, 1 - 1e-5], x = clip(mean + e^ls (log u - log1p(-u)),
    -1, 1); the next input h = bf16(x * w_first + b_first), h0 =
    bf16(b_first);
  * the ring starts at zero (causal zero padding); tap j of layer l reads
    the input of d_l * (K - 1 - j) steps ago.

The products accumulate in float32 in the kernel's order, which the plain
versions repeat (``_matvec``, ``_layer``): a product's rows are cut into
``SLICES`` = 16 slices of consecutive rows (padded with zeros to a multiple
of 16), each summed row by row from zero, and the slice sums are added by
halving (slice s + slice s + 8, then + 4, + 2, + 1). A z column is ((tap
part + h part) + b_dil) + condz, the tap part the product of the taps
[tap_0 | ... | tap_{K-2}] and the h part that of h. So the kernel and its
plain version differ only where CUDA's and PyTorch's tanh, exp and log
differ. The noise is drawn outside the kernel: gumbel (T, n_mix) and
uniform (T,) in the layout of ``models/wavenet.draw_noise``, so the plain
version and the scan sampler can take the same numbers.

The kernel runs as one thread-block cluster of ``CLUSTER`` = 16 CTAs; CTA
c owns 1/16 of the columns of every product and holds its slices of the
chain's weights in shared memory (``kernel_layout``, ``kernel_weights``:
the per-CTA blobs, in the order in which a warp's lanes read them).

``wavenet_generate`` and ``wavenet_teacher_logits`` run the plain versions
for tensors on the CPU and launch the kernel for tensors on a CUDA device,
or raise; there is no fallback between the two. ``launch_counts()`` counts
the launches of each variant.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading

import torch
import torch.nn.functional as F

from neural_sound_generation_tpu_torch.ops.cuda import build

SOURCE = build.CSRC / "wavenet_gen.cu"
KERNELS = ("wavenet_gen_sample", "wavenet_gen_teacher")
#: threads of each CTA: warp 0 runs the chain, warps 1-3 the off-chain parts
THREADS = 128
ROLES = "warp 0: chain, exchanges, head, sample; warps 1-3: taps and condz one step ahead"
#: row slices of every product (a half-warp's lanes); the summation order follows it
SLICES = 16
#: bf16 columns per 16-byte load: every product's width is a multiple
VEC = 8
U_LO, U_HI = 1e-5, 1.0 - 1e-5
#: the Pallas kernel's lane width; its shape rules are kept unchanged
_P = 128
SMEM_LIMIT = 232448  # dynamic shared memory a CTA may use on Hopper
CLUSTER = 16  # CTAs of the one cluster (a non-portable cluster size)
X_BUFS = 4  # the kernel's exchange buffers, used in turn
PASS_ROW = 512  # bytes of one row of a pass: 32 lanes x 16 bytes
_PLAN_KEYS = ("smem_bytes", "resident_bytes", "resident_blob_bytes", "streamed_blob_bytes",
              "threads", "registers", "spill_bytes", "max_active_clusters")

_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)
_plans: dict = {}


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(_launches)


def reset_launch_count() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0


def _weight_bytes(model) -> int:
    """bf16 bytes of the stacked layer weights (the Pallas kernel's VMEM
    estimate)."""
    L, K, R = model.layers, model.kernel_size, model.residual_channels
    G, S, C = model.gate_channels, model.skip_out_channels, max(model.cin_channels, 0)
    return 2 * ((K - 1) * L * R * G + L * R * G + L * (G // 2) * R + L * (G // 2) * S
                + C * L * G)


def generate_supported(model, batch_size: int) -> bool:
    """The shapes the kernel takes: the Pallas kernel's predicate, unchanged
    (including its 10 MB cap on the weights); other calls take the scan."""
    return (
        batch_size == 1
        and model.scalar_input
        and model.out_channels % 3 == 0
        and model.out_channels <= _P
        and model.cin_channels > 0
        and model.gin_channels <= 0
        and model.residual_channels % _P == 0
        and model.gate_channels % (2 * _P) == 0
        and model.skip_out_channels % _P == 0
        and model.cin_channels <= _P
        and model.kernel_size >= 2
        and _weight_bytes(model) <= 10 * 1024 * 1024
    )


@dataclasses.dataclass
class PackedWeights:
    """The kernel's weight layout (see the module docstring)."""

    w_in: torch.Tensor     # (L, K*R, G) bf16
    b_dil: torch.Tensor    # (L, G) f32
    w_sr: torch.Tensor     # (L, G/2, S+R) bf16
    b_res: torch.Tensor    # (L, R) f32
    b_skip: torch.Tensor   # (S,) f32, summed over layers
    w_post1: torch.Tensor  # (S, S) bf16
    b_post1: torch.Tensor  # (S,) f32
    w_post2: torch.Tensor  # (S, OUTP) bf16, zero columns past out_channels
    b_post2: torch.Tensor  # (OUTP,) f32
    w_first: torch.Tensor  # (R,) f32
    b_first: torch.Tensor  # (R,) f32
    w_cdot: torch.Tensor   # (C, L*G) bf16
    dilations: tuple
    kernel_size: int
    out_channels: int

    @property
    def dims(self) -> dict:
        L, KR, G = self.w_in.shape
        return {"L": L, "K": self.kernel_size, "R": KR // self.kernel_size, "G": G,
                "S": self.w_post1.shape[0], "C": self.w_cdot.shape[0],
                "OUT": self.out_channels, "OUTP": self.w_post2.shape[1],
                "n_mix": self.out_channels // 3,
                "RD": (self.kernel_size - 1) * max(self.dilations) + 1}

    def tensors(self) -> list[torch.Tensor]:
        return [self.w_in, self.b_dil, self.w_sr, self.b_res, self.b_skip, self.w_post1,
                self.b_post1, self.w_post2, self.b_post2, self.w_first, self.b_first,
                self.w_cdot]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())


@torch.no_grad()
def pack_weights(model) -> PackedWeights:
    """A mel-conditioned MoL ``WaveNet``'s weights in the kernel's layout,
    on the model's device."""
    from neural_sound_generation_tpu_torch.models.wavenet import _stack_step_params

    st = _stack_step_params(model)
    K = model.kernel_size
    bf16, f32 = torch.bfloat16, torch.float32
    L, C, G = st["w_cond"].shape
    out = model.out_channels
    outp = -(-out // VEC) * VEC
    w_p2 = model.post2.weight[:, :, 0].T  # (S, out)
    return PackedWeights(
        w_in=torch.cat([st["w_cur"]] + [st["w_tap"][j] for j in range(K - 1)],
                       dim=1).to(bf16).contiguous(),
        b_dil=st["b_dil"].to(f32).contiguous(),
        w_sr=torch.cat([st["w_skip"], st["w_res"]], dim=-1).to(bf16).contiguous(),
        b_res=st["b_res"].to(f32).contiguous(),
        b_skip=st["b_skip"].sum(0).to(f32).contiguous(),
        w_post1=model.post1.weight[:, :, 0].T.to(bf16).contiguous(),
        b_post1=model.post1.bias.to(f32).contiguous(),
        w_post2=F.pad(w_p2, (0, outp - out)).to(bf16).contiguous(),
        b_post2=F.pad(model.post2.bias, (0, outp - out)).to(f32).contiguous(),
        w_first=model.first_conv.weight[:, 0, 0].to(f32).contiguous(),
        b_first=model.first_conv.bias.to(f32).contiguous(),
        w_cdot=st["w_cond"].permute(1, 0, 2).reshape(C, L * G).to(bf16).contiguous(),
        dilations=tuple(model.dilation_rates), kernel_size=K, out_channels=out,
    )


# ---------------------------------------------------------------------------
# The plain versions
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, rows) float32 holding bf16 values, w (rows, cols) bf16 ->
    (N, cols) float32 summed in the kernel's order: the rows, padded with
    zeros to a multiple of SLICES, form SLICES slices of rps consecutive rows,
    each summed row by row from zero (each bf16 x bf16 product is exact in
    float32, so the kernel's fma rounds as this add does); the slice sums
    are then added by halving: slice s + slice s + 8, then + 4, + 2, + 1."""
    rows, cols = w.shape
    rps = -(-rows // SLICES)
    pad = SLICES * rps - rows
    xs = F.pad(x, (0, pad)).reshape(x.shape[0], SLICES, rps)
    ws = F.pad(w.float(), (0, 0, 0, pad)).reshape(SLICES, rps, cols)
    acc = torch.zeros(x.shape[0], SLICES, cols, dtype=torch.float32, device=x.device)
    for i in range(rps):
        acc = acc + xs[:, :, i, None] * ws[None, :, i, :]
    n = SLICES
    while n > 1:
        n //= 2
        acc = acc[:, :n] + acc[:, n : 2 * n]
    return acc[:, 0]


def _embed(p: PackedWeights, x: torch.Tensor) -> torch.Tensor:
    """(N,) input samples -> (N, R) bf16-valued layer-0 inputs."""
    return _bf16(x[:, None] * p.w_first + p.b_first)


def _condz(p: PackedWeights, c_up: torch.Tensor, layer: int) -> torch.Tensor:
    """(N, C) conditioning rows -> layer ``layer``'s (N, G) condz."""
    G = p.dims["G"]
    return _matvec(_bf16(c_up.float()), p.w_cdot[:, layer * G : (layer + 1) * G])


def _layer(p: PackedWeights, layer: int, h: torch.Tensor, taps: list, condz: torch.Tensor,
           skips: torch.Tensor):
    """One residual layer over N rows: (h_next, skips). z is summed in the
    kernel's order: ((tap part + h part) + b_dil) + condz."""
    d = p.dims
    G2, R, S = d["G"] // 2, d["R"], d["S"]
    w = p.w_in[layer]
    z = _matvec(torch.cat(taps, dim=1), w[R:]) + _matvec(h, w[:R])
    z = (z + p.b_dil[layer]) + condz
    gated = _bf16(torch.tanh(z[:, :G2]) * torch.sigmoid(z[:, G2:]))
    sr = _matvec(gated, p.w_sr[layer])
    skips = skips + sr[:, :S]
    return _bf16((h + sr[:, S:]) + p.b_res[layer]), skips


def _head(p: PackedWeights, skips: torch.Tensor) -> torch.Tensor:
    out = torch.relu(skips + p.b_skip)
    o1 = torch.relu(_matvec(_bf16(out), p.w_post1) + p.b_post1)
    return (_matvec(_bf16(o1), p.w_post2) + p.b_post2)[:, : p.out_channels]


@torch.no_grad()
def wavenet_teacher_logits_plain(p: PackedWeights, c_up: torch.Tensor,
                                 x: torch.Tensor) -> torch.Tensor:
    """The teacher-forced variant in plain PyTorch: x (T,) inputs (already
    shifted), c_up (>= T, C) -> (T, out) float32 logits. A layer's inputs at
    every step follow from the given x alone, so each layer runs over all T
    steps at once; the rounding points and summation order are the
    kernel's."""
    t_len = x.shape[0]
    d = p.dims
    h = _embed(p, x.float())
    skips = torch.zeros(t_len, d["S"], device=x.device)
    for layer, dil in enumerate(p.dilations):
        taps = [F.pad(h, (0, 0, off, 0))[:t_len]
                for off in (dil * (d["K"] - 1 - j) for j in range(d["K"] - 1))]
        h, skips = _layer(p, layer, h, taps, _condz(p, c_up[:t_len], layer), skips)
    return _head(p, skips)


@torch.no_grad()
def wavenet_generate_plain(p: PackedWeights, c_up: torch.Tensor, gumbel: torch.Tensor,
                           uniform: torch.Tensor, length: int) -> torch.Tensor:
    """The sampling variant in plain PyTorch, one step after another with
    the kernel's ring: (length,) float32 samples. c_up (>= length, C),
    gumbel (>= length, n_mix), uniform (>= length,)."""
    from neural_sound_generation_tpu_torch.models.wavenet import sample_mol

    d = p.dims
    dev = c_up.device
    ring = torch.zeros(d["L"], d["RD"], d["R"], device=dev)
    condz_all = [_condz(p, c_up[:length], layer) for layer in range(d["L"])]
    h = _embed(p, torch.zeros(1, device=dev))
    out = torch.empty(length, device=dev)
    for t in range(length):
        skips = torch.zeros(1, d["S"], device=dev)
        for layer, dil in enumerate(p.dilations):
            taps = [ring[layer, (t - dil * (d["K"] - 1 - j)) % d["RD"]][None]
                    for j in range(d["K"] - 1)]
            ring[layer, t % d["RD"]] = h[0]
            h, skips = _layer(p, layer, h, taps, condz_all[layer][t : t + 1], skips)
        logits = _head(p, skips)
        u = uniform[t : t + 1].clamp(U_LO, U_HI)
        x = sample_mol(logits, gumbel[t : t + 1], u)
        out[t] = x[0]
        h = _embed(p, x)
    return out


# ---------------------------------------------------------------------------
# The kernel's per-CTA layout
# ---------------------------------------------------------------------------


def kernel_layout(d: dict, nc: int = CLUSTER) -> dict:
    """The kernel's layout for shape ``d`` (``PackedWeights.dims``) on a
    cluster of ``nc`` CTAs: the same formulas as ``make_layout`` in
    ``csrc/wavenet_gen.cu``. Byte offsets of each section of a CTA's
    resident blob (biases, the head's weights, then per layer W_cur and
    [W_res | W_skip]) and of its streamed blob (per layer W_tap and
    W_cdot); ``res``, the blob's prefix held in shared memory (whole
    sections while they fit beside the buffers); ``smem``, the shared memory
    of a CTA. A pass is one warp's product of rows x 16 columns: rps rows of
    32 lanes x 16 bytes. Raises ValueError for a shape the kernel cannot
    lay out."""
    L, K, R, G2, S, C, OUTP = d["L"], d["K"], d["R"], d["G"] // 2, d["S"], d["C"], d["OUTP"]
    if nc < 1 or L < 1 or K < 2 or C < 1:
        raise ValueError(f"no layout for L={L}, K={K}, C={C} on {nc} CTAs")
    for name, n in (("R", R), ("G/2", G2), ("S", S)):
        if n % (VEC * nc):
            raise ValueError(f"{name} = {n} is not a multiple of {VEC} x {nc} CTAs: each CTA "
                             f"owns whole 8-column chunks")
    if OUTP < VEC or OUTP % VEC:
        raise ValueError(f"OUTP = {OUTP} is not a positive multiple of {VEC}")
    g8, r8, s8 = G2 // nc, R // nc, S // nc
    y = {"nc": nc, "g8": g8, "r8": r8, "s8": s8, "z": 2 * g8, "npz": g8 // 8,
         "nprs": max(r8, s8) // 8, "np1": -(-(s8 // 8) // 2), "np2": -(-(OUTP // 8) // 2),
         "cp": -(-C // SLICES) * SLICES}
    y.update(rps_r=R // SLICES, rps_g=G2 // SLICES, rps_s=S // SLICES,
             rps_t=(K - 1) * R // SLICES, rps_c=y["cp"] // SLICES)

    def sections(sizes: list) -> tuple[list, int]:
        offs, off = [], 0
        for n in sizes:
            offs.append(off)
            off += -(-n // 16) * 16
        return offs, off

    names = ("bdil", "bres", "bskip", "bp1", "bp2", "wfirst", "bfirst", "wp1", "wp2")
    offs, head = sections([4 * L * y["z"], 4 * L * 8 * y["nprs"], 4 * 8 * y["nprs"],
                           4 * 16 * y["np1"], 4 * 16 * y["np2"], 4 * R, 4 * R,
                           y["np1"] * y["rps_s"] * PASS_ROW, y["np2"] * y["rps_s"] * PASS_ROW])
    y.update(zip(names, offs))
    y["layer0"] = head
    y["wcur_bytes"] = y["npz"] * y["rps_r"] * PASS_ROW
    y["layer_bytes"] = y["wcur_bytes"] + y["nprs"] * y["rps_g"] * PASS_ROW
    y["rb"] = head + L * y["layer_bytes"]
    y["tap_bytes"] = y["npz"] * y["rps_t"] * PASS_ROW
    y["slayer_bytes"] = y["tap_bytes"] + y["npz"] * y["rps_c"] * PASS_ROW
    y["sb"] = L * y["slayer_bytes"]
    y["xw"] = max(G2, R, S)
    bnames = ("b_pre", "b_xbuf", "b_h0", "b_mine", "b_skacc", "b_logits", "b_score", "b_bars")
    boffs, buf = sections([4 * 2 * 2 * L * y["z"], 2 * X_BUFS * y["xw"], 2 * R,
                           2 * 8 * max(y["npz"], y["nprs"], 2 * y["np1"]), 4 * 8 * y["nprs"],
                           4 * 16 * y["np2"], 4 * 16 * y["np2"], 8 * (X_BUFS + 2 * L + 1)])
    y.update(zip(bnames, boffs))
    budget = SMEM_LIMIT - buf
    if budget < 0:
        raise ValueError(f"the kernel's buffers need {buf} bytes of shared memory a CTA "
                         f"(> {SMEM_LIMIT}) at L={L}, R={R}, G={2 * G2}, S={S} on {nc} CTAs")
    ends = [y["wp1"], y["wp2"], head] + [head + (n + 1) * y["layer_bytes"] for n in range(L)]
    res = 0
    for n, end in enumerate(ends):
        if end > budget:
            break
        res = end
    y["res"] = res
    y["resident_layers"] = max(0, (res - head) // y["layer_bytes"]) if res >= head else 0
    y["smem"] = res + buf
    return y


def smem_bytes(p: PackedWeights) -> int:
    """A CTA's dynamic shared memory (the same formula as the C side's
    ``make_layout``)."""
    return kernel_layout(p.dims)["smem"]


def _passes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Passes in the lane order the kernel reads: lo and hi (..., P, rows, 8)
    are each pass's chunks for lanes 0-15 and 16-31; lane l reads rows (l %
    16) * rps .. + rps of its chunk, vector i at [i * 32 + l]. Returns
    (..., P * rows * 32 * 8 / 16) elements."""
    *lead, n, rows, _ = lo.shape
    rps = rows // SLICES
    x = torch.stack([lo, hi], dim=-3).reshape(*lead, n, 2, SLICES, rps, VEC)
    return x.movedim(-2, -4).reshape(*lead, n * rps * 2 * SLICES * VEC)


def _chunks(w: torch.Tensor, nc: int, n: int) -> torch.Tensor:
    """(..., rows, nc * k * 8) -> (nc, ..., n, rows, 8): CTA c's k column
    chunks, zero chunks added up to n."""
    *lead, rows, cols = w.shape
    k = cols // (nc * VEC)
    x = w.reshape(*lead, rows, nc, k, VEC)
    x = F.pad(x, (0, 0, 0, n - k))
    return x.movedim(-3, 0).movedim(-2, -3)


def _bias_chunks(b: torch.Tensor, nc: int, n: int) -> torch.Tensor:
    """(..., nc * k) -> (nc, ..., n): CTA c's k columns, zeros up to n."""
    *lead, cols = b.shape
    x = F.pad(b.reshape(*lead, nc, cols // nc), (0, n - cols // nc))
    return x.movedim(-2, 0)


def _bytes(x: torch.Tensor, nc: int) -> torch.Tensor:
    return x.contiguous().reshape(nc, -1).view(torch.uint8)


@torch.no_grad()
def kernel_weights(p: PackedWeights, nc: int = CLUSTER) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (nc, RB) resident and (nc, SB) streamed blobs, uint8 on
    the weights' device, laid out by ``kernel_layout``."""
    d = p.dims
    y = kernel_layout(d, nc)
    L, R, G2, S, C, OUTP = d["L"], d["R"], d["G"] // 2, d["S"], d["C"], d["OUTP"]
    dev = p.w_in.device

    def zpasses(w):  # (L, rows, G) -> (nc, L, bytes): z column passes (a, b halves)
        return _bytes(_passes(_chunks(w[..., :G2], nc, y["npz"]),
                              _chunks(w[..., G2:], nc, y["npz"])), nc)

    def pair_passes(w, n_chunks):  # (rows, cols) -> (nc, bytes): chunks 2q, 2q + 1 a pass
        x = _chunks(w, nc, 2 * n_chunks)
        return _bytes(_passes(x[..., 0::2, :, :], x[..., 1::2, :, :]), nc)

    res = torch.zeros(nc, y["rb"], dtype=torch.uint8, device=dev)
    bdil = torch.stack([_bias_chunks(p.b_dil[:, :G2], nc, y["g8"]).reshape(nc, L, y["npz"], 8),
                        _bias_chunks(p.b_dil[:, G2:], nc, y["g8"]).reshape(nc, L, y["npz"], 8)],
                       dim=-2)
    w_post2 = p.w_post2.expand(nc, S, OUTP).permute(1, 0, 2).reshape(S, nc * OUTP)
    parts = {
        "bdil": _bytes(bdil, nc),
        "bres": _bytes(_bias_chunks(p.b_res, nc, 8 * y["nprs"]), nc),
        "bskip": _bytes(_bias_chunks(p.b_skip, nc, 8 * y["nprs"]), nc),
        "bp1": _bytes(_bias_chunks(p.b_post1, nc, 16 * y["np1"]), nc),
        "bp2": _bytes(F.pad(p.b_post2, (0, 16 * y["np2"] - OUTP)).expand(nc, -1), nc),
        "wfirst": _bytes(p.w_first.expand(nc, R), nc),
        "bfirst": _bytes(p.b_first.expand(nc, R), nc),
        "wp1": pair_passes(p.w_post1, y["np1"]),
        "wp2": pair_passes(w_post2, y["np2"]),
    }
    for name, blob in parts.items():
        res[:, y[name] : y[name] + blob.shape[1]] = blob
    w_rs = _passes(_chunks(p.w_sr[..., S:], nc, y["nprs"]),
                   _chunks(p.w_sr[..., :S], nc, y["nprs"]))
    layers = torch.cat([zpasses(p.w_in[:, :R]).reshape(nc, L, -1),
                        _bytes(w_rs, nc).reshape(nc, L, -1)], dim=2)
    res[:, y["layer0"] :] = layers.reshape(nc, -1)
    w_cdot = F.pad(p.w_cdot, (0, 0, 0, y["cp"] - C)).reshape(y["cp"], L, 2 * G2)
    stream = torch.cat([zpasses(p.w_in[:, R:]).reshape(nc, L, -1),
                        zpasses(w_cdot.permute(1, 0, 2)).reshape(nc, L, -1)], dim=2)
    return res, stream.reshape(nc, -1).contiguous()


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


_lib: ctypes.CDLL | None = None
#: the C entries' parameters, in order (pointers, then ints, then the stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
PLAN_ARGTYPES = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]


def load(rebuild: bool = False) -> ctypes.CDLL:
    """Build (see ``build.load_library``) and bind the kernel's library."""
    global _lib
    if _lib is None:
        lib = build.load_library("wavenet_gen", [SOURCE], rebuild)
        lib.wavenet_gen_launch.argtypes = LAUNCH_ARGTYPES
        lib.wavenet_gen_launch.restype = ctypes.c_int
        lib.wavenet_gen_plan.argtypes = PLAN_ARGTYPES
        lib.wavenet_gen_plan.restype = ctypes.c_int
        lib.wavenet_gen_error_string.argtypes = [ctypes.c_int]
        lib.wavenet_gen_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.wavenet_gen_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def launch_plan(p: PackedWeights, name: str = KERNELS[0], device=None) -> dict:
    """The launch variant ``name`` makes for these weights on a CUDA device
    (the weights' own unless ``device`` is given): ``cluster`` (CTAs in the
    one cluster), ``threads`` per CTA and their ``roles``, ``smem_bytes``
    and ``resident_bytes`` per CTA, ``resident_layers`` of ``layers`` held
    in shared memory and ``resident_whole`` (all of the chain's weights and
    the head; else the rest streams from L2), ``registers`` and
    ``spill_bytes`` per thread, and ``max_active_clusters``
    (cudaOccupancyMaxActiveClusters). Raises when no cluster fits on the
    device, and for non-CUDA devices."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}: expected one of {KERNELS}")
    dev = torch.device(device) if device is not None else p.w_in.device
    if dev.type != "cuda":
        raise ValueError(f"the wavenet_gen kernel launches only for CUDA tensors, got {dev}")
    d = p.dims
    key = (tuple(sorted(d.items())), dev.index, name)
    if key in _plans:
        return dict(_plans[key])
    lib = load()
    y = kernel_layout(d)
    info = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(dev):
        err = lib.wavenet_gen_plan(d["L"], d["K"], d["R"], d["G"] // 2, d["S"], d["C"],
                                   d["OUTP"], CLUSTER, int(name == KERNELS[1]), info)
    _raise_on(lib, err, f"{name} launch plan")
    got = dict(zip(_PLAN_KEYS, info))
    want = {"smem_bytes": y["smem"], "resident_bytes": y["res"],
            "resident_blob_bytes": y["rb"], "streamed_blob_bytes": y["sb"]}
    if any(got[k] != v for k, v in want.items()):
        raise RuntimeError(f"the kernel's layout {got} differs from the wrapper's {want}")
    if got["max_active_clusters"] < 1:
        raise RuntimeError(f"no cluster of {CLUSTER} CTAs with {y['smem']} bytes of shared "
                           f"memory each fits on {dev}")
    plan = {"cluster": CLUSTER, "ctas": CLUSTER, **got, "roles": ROLES,
            "resident_layers": y["resident_layers"], "layers": d["L"],
            "resident_whole": y["res"] == y["rb"]}
    _plans[key] = plan
    return dict(plan)


def _check(p: PackedWeights, c_up: torch.Tensor, length: int) -> None:
    dev = c_up.device
    for t in p.tensors():
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"packed weights must be contiguous and 16-byte aligned on {dev}, "
                             f"got {t.device}")
    d = p.dims
    if c_up.ndim != 2 or c_up.shape[1] != d["C"] or c_up.shape[0] < length:
        raise ValueError(f"c_up must be (>= {length}, {d['C']}), got {tuple(c_up.shape)}")
    if length < 0:
        raise ValueError(f"length {length} < 0")
    for name, n in (("G", d["G"]), ("S+R", d["S"] + d["R"]), ("S", d["S"]),
                    ("L*G", d["L"] * d["G"]), ("OUTP", d["OUTP"])):
        if n % VEC:
            raise ValueError(f"{name} = {n} is not a multiple of {VEC}")
    if d["G"] % 2 or d["n_mix"] < 1 or 3 * d["n_mix"] != d["OUT"]:
        raise ValueError(f"unsupported gate width {d['G']} or head {d['OUT']}")


def _launch(name: str, p: PackedWeights, c_up, gumbel, uniform, x_teacher, out, length):
    d = p.dims
    dev = c_up.device
    if dev.type != "cuda":
        raise ValueError(f"the wavenet_gen kernel needs CUDA tensors, got {dev}")
    plan = launch_plan(p, name, dev)
    if length == 0:
        return
    nc = plan["cluster"]
    res, stream_blob = kernel_weights(p, nc)
    # from pinned memory, so that the copy does not wait for the stream
    dil = torch.tensor(p.dilations, dtype=torch.int32).pin_memory().to(dev, non_blocking=True)
    ring = torch.zeros(nc, d["L"], d["RD"], d["R"], dtype=torch.bfloat16, device=dev)
    c_bf = c_up[:length].to(torch.bfloat16).contiguous()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    args = [res.data_ptr(), stream_blob.data_ptr(), c_bf.data_ptr(), dil.data_ptr(), ptr(gumbel),
            ptr(uniform), ptr(x_teacher), ring.data_ptr(), out.data_ptr(),
            length, d["L"], d["K"], d["R"], d["G"] // 2, d["S"], d["C"], d["OUT"], d["OUTP"],
            d["RD"], nc, plan["smem_bytes"], int(name == KERNELS[1])]
    lib = load()
    with torch.cuda.device(dev):
        err = lib.wavenet_gen_launch(*args, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, f"{name} kernel launch")
    with _count_lock:
        _launches[name] += 1


def _per_step(t: torch.Tensor, length: int, width: int | None, name: str, dev) -> torch.Tensor:
    """The first ``length`` rows of a per-step input, float32, contiguous."""
    ok = (t.device == dev and t.ndim == (1 if width is None else 2) and t.shape[0] >= length
          and (width is None or t.shape[1] == width))
    if not ok:
        want = "(>= T,)" if width is None else f"(>= T, {width})"
        raise ValueError(f"{name} must be {want} on {dev}, got {tuple(t.shape)} on {t.device}")
    return t[:length].float().contiguous()


def wavenet_generate(p: PackedWeights, c_up: torch.Tensor, gumbel: torch.Tensor,
                     uniform: torch.Tensor, length: int) -> torch.Tensor:
    """Generate ``length`` samples: c_up (>= length, C) upsampled mel
    conditioning, gumbel (>= length, n_mix) and uniform (>= length,) noise.
    (length,) float32. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    _check(p, c_up, length)
    dev = c_up.device
    gumbel = _per_step(gumbel, length, p.dims["n_mix"], "gumbel", dev)
    uniform = _per_step(uniform, length, None, "uniform", dev)
    if dev.type == "cpu":
        return wavenet_generate_plain(p, c_up, gumbel, uniform, length)
    out = torch.empty(length, dtype=torch.float32, device=dev)
    _launch("wavenet_gen_sample", p, c_up, gumbel, uniform, None, out, length)
    return out


def wavenet_teacher_logits(p: PackedWeights, c_up: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits through the kernel's math: x (T,) inputs
    (already shifted), c_up (>= T, C) -> (T, out) float32. CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise."""
    length = x.shape[0]
    _check(p, c_up, length)
    dev = c_up.device
    x = _per_step(x, length, None, "x", dev)
    if dev.type == "cpu":
        return wavenet_teacher_logits_plain(p, c_up, x)
    out = torch.empty(length, p.out_channels, dtype=torch.float32, device=dev)
    _launch("wavenet_gen_teacher", p, c_up, None, None, x, out, length)
    return out

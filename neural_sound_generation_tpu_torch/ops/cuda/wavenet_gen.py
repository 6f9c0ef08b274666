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

The products accumulate in float32 in a fixed order: each output column is
split into ``_slices(cols)`` consecutive row slices, each summed row by row
from zero, and the slice sums are added in slice order. The plain versions
sum in that same order (``_matvec``), so the kernel and its plain version
differ only where CUDA's and PyTorch's tanh, exp and log differ. The noise
is drawn outside the kernel: gumbel (T, n_mix) and uniform (T,) in the
layout of ``models/wavenet.draw_noise``, so the plain version and the
scan sampler can take the same numbers.

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
#: the kernel's block size; the plain versions' summation order follows it
THREADS = 512
#: bf16 columns per 16-byte load: every product's width is a multiple
VEC = 8
U_LO, U_HI = 1e-5, 1.0 - 1e-5
#: the Pallas kernel's lane width; its shape rules are kept unchanged
_P = 128
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on Hopper

_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)


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


def _slices(cols: int) -> int:
    """Row slices per output column in the kernel's products: THREADS
    threads over cols/8 column groups, the rest of the threads splitting
    the rows."""
    groups = cols // VEC
    return THREADS // groups if groups < THREADS else 1


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, rows) float32 holding bf16 values, w (rows, cols) bf16 ->
    (N, cols) float32 summed in the kernel's order: slice s covers rows
    [s*rps, (s+1)*rps) and is summed row by row from zero (each bf16 x bf16
    product is exact in float32, so the kernel's fma rounds as this add
    does); the slice sums are then added in order."""
    rows, cols = w.shape
    ns = _slices(cols)
    rps = -(-rows // ns)
    pad = ns * rps - rows
    xs = F.pad(x, (0, pad)).reshape(x.shape[0], ns, rps)
    ws = F.pad(w.float(), (0, 0, 0, pad)).reshape(ns, rps, cols)
    acc = torch.zeros(x.shape[0], ns, cols, dtype=torch.float32, device=x.device)
    for i in range(rps):
        acc = acc + xs[:, :, i, None] * ws[None, :, i, :]
    y = acc[:, 0]
    for s in range(1, ns):
        y = y + acc[:, s]
    return y


def _embed(p: PackedWeights, x: torch.Tensor) -> torch.Tensor:
    """(N,) input samples -> (N, R) bf16-valued layer-0 inputs."""
    return _bf16(x[:, None] * p.w_first + p.b_first)


def _layer(p: PackedWeights, layer: int, h: torch.Tensor, taps: list, condz: torch.Tensor,
           skips: torch.Tensor):
    """One residual layer over N rows: (h_next, skips)."""
    d = p.dims
    G, G2, S = d["G"], d["G"] // 2, d["S"]
    z = _matvec(torch.cat([h] + taps, dim=1), p.w_in[layer]) + p.b_dil[layer]
    z = z + condz[:, layer * G : (layer + 1) * G]
    gated = _bf16(torch.tanh(z[:, :G2]) * torch.sigmoid(z[:, G2:]))
    sr = _matvec(gated, p.w_sr[layer])
    skips = skips + sr[:, :S]
    return _bf16((h + sr[:, S:]) + p.b_res[layer]), skips


def _head(p: PackedWeights, skips: torch.Tensor) -> torch.Tensor:
    out = torch.relu(skips + p.b_skip)
    o1 = torch.relu(_matvec(_bf16(out), p.w_post1) + p.b_post1)
    return (_matvec(_bf16(o1), p.w_post2) + p.b_post2)[:, : p.out_channels]


def _cond(p: PackedWeights, c_up: torch.Tensor) -> torch.Tensor:
    return _matvec(_bf16(c_up.float()), p.w_cdot)


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
    condz = _cond(p, c_up[:t_len])
    h = _embed(p, x.float())
    skips = torch.zeros(t_len, d["S"], device=x.device)
    for layer, dil in enumerate(p.dilations):
        taps = [F.pad(h, (0, 0, off, 0))[:t_len]
                for off in (dil * (d["K"] - 1 - j) for j in range(d["K"] - 1))]
        h, skips = _layer(p, layer, h, taps, condz, skips)
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
    condz_all = _cond(p, c_up[:length])
    h = _embed(p, torch.zeros(1, device=dev))
    out = torch.empty(length, device=dev)
    for t in range(length):
        skips = torch.zeros(1, d["S"], device=dev)
        for layer, dil in enumerate(p.dilations):
            taps = [ring[layer, (t - dil * (d["K"] - 1 - j)) % d["RD"]][None]
                    for j in range(d["K"] - 1)]
            ring[layer, t % d["RD"]] = h[0]
            h, skips = _layer(p, layer, h, taps, condz_all[t : t + 1], skips)
        logits = _head(p, skips)
        u = uniform[t : t + 1].clamp(U_LO, U_HI)
        x = sample_mol(logits, gumbel[t : t + 1], u)
        out[t] = x[0]
        h = _embed(p, x)
    return out


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


_lib: ctypes.CDLL | None = None


def load(rebuild: bool = False) -> ctypes.CDLL:
    """Build (see ``build.load_library``) and bind the kernel's library."""
    global _lib
    if _lib is None:
        lib = build.load_library("wavenet_gen", [SOURCE], rebuild)
        lib.wavenet_gen_launch.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 13 + [
            ctypes.c_void_p]
        lib.wavenet_gen_launch.restype = ctypes.c_int
        lib.wavenet_gen_smem_bytes.argtypes = [ctypes.c_int] * 9
        lib.wavenet_gen_smem_bytes.restype = ctypes.c_int
        lib.wavenet_gen_error_string.argtypes = [ctypes.c_int]
        lib.wavenet_gen_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(p: PackedWeights) -> int:
    """The kernel's dynamic shared memory (the same formula as the C
    side's ``wavenet_gen_smem_bytes``)."""
    d = p.dims
    floats = (d["L"] * d["G"] + d["K"] * d["R"] + d["G"] + d["G"] // 2 + (d["S"] + d["R"])
              + d["S"] + d["R"] + d["S"] + d["S"] + d["OUTP"] + d["C"] + THREADS * VEC + 4)
    return 4 * floats


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
    need = smem_bytes(p)
    if need > SMEM_LIMIT:
        raise ValueError(f"the model needs {need} bytes of shared memory (> {SMEM_LIMIT})")
    lib = load()
    if lib.wavenet_gen_smem_bytes(d["L"], d["K"], d["R"], d["G"], d["S"], d["C"], d["OUTP"],
                                  THREADS, VEC) != need:
        raise RuntimeError("the kernel's shared-memory layout differs from the wrapper's")
    ring = torch.zeros(d["L"], d["RD"], d["R"], dtype=torch.bfloat16, device=dev)
    dil = torch.tensor(p.dilations, dtype=torch.int32, device=dev)
    c_bf = c_up[:length].to(torch.bfloat16).contiguous()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    args = [t.data_ptr() for t in p.tensors()] + [
        c_bf.data_ptr(), dil.data_ptr(), ptr(gumbel), ptr(uniform), ptr(x_teacher),
        ring.data_ptr(), out.data_ptr(),
        length, d["L"], d["K"], d["R"], d["G"], d["S"], d["C"], d["OUT"], d["OUTP"],
        d["RD"], THREADS, need, int(name == "wavenet_gen_teacher"),
    ]
    if length == 0:
        return
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = lib.wavenet_gen_launch(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = lib.wavenet_gen_launch(*args, stream)
    if err != 0:
        msg = lib.wavenet_gen_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
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

"""Causal flash attention: the CUDA kernels' wrapper and their plain version.

Counterpart of ``neural_sound_generation_tpu/ops/pallas/attention.py::
flash_causal_attention``. q, k and v are (BH, T, D), contiguous, of one dtype
(float32 or bfloat16), with any T >= 1 and D <= ``MAX_D``; the output is the
causal softmax(Q K^T * scale) V in q's dtype. The scale is applied after
Q K^T; logits are float32 with masked keys at ``NEG``; the matmul operands
stay in the input dtype (P and dS are rounded to it) and accumulate in
float32.

``csrc/flash_attention.cu`` holds three kernels: the forward (O and the
float32 row log-sum-exp), a dQ kernel (which also writes delta =
rowsum(dO * O)) and a dK/dV kernel. Their products run on the tensor cores
(``wgmma``): bf16 inputs in bf16, float32 inputs as three TF32 products
each (3xTF32, float32-accurate); this does not turn TF32 on anywhere else.
``launch_plan`` reports a launch's CTAs, registers, spills and shared
memory. The Pallas backward keeps no residual
beyond O, because (T, 1) rows lane-pad 1 -> 128 in the TPU's VMEM; here the
dK/dV kernel walks key tiles and never sees a whole softmax row, so the
forward saves the LSE for the backward.

``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain`` are the
same functions in plain PyTorch: the one-shot softmax of ``_fwd_tile`` and
the explicit dq, dk, dv of ``_bwd_tile``, the latter split as the backward
kernels are (``flash_attention_bwd_dq_plain``, ``flash_attention_bwd_dkdv_plain``).
``flash_causal_attention`` is
differentiable (``torch.autograd.Function``): CPU tensors run the plain
pair, CUDA tensors launch the kernels or raise; there is no fallback between
the two. ``launch_counts()`` counts each kernel's launches, and
``bf16_launch_counts()`` those of them made on bfloat16 inputs.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from neural_sound_generation_tpu_torch.ops.cuda import build

SOURCE = build.CSRC / "flash_attention.cu"
MAX_D = 128
MAX_BH = 65535  # the kernels' grid y dimension
NEG = -1e30  # the masked logit (attention.py _NEG)
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")
_PLAN_KEYS = ("ctas", "threads", "registers", "spill_bytes", "smem_bytes", "ctas_per_sm",
              "streamed_rows", "tma")

_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)
_bf16_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict[str, int]:
    """Each kernel's launches, whatever the dtype."""
    with _count_lock:
        return dict(_launches)


def bf16_launch_counts() -> dict[str, int]:
    """Each kernel's launches on bfloat16 inputs (counted in
    ``launch_counts`` too)."""
    with _count_lock:
        return dict(_bf16_launches)


def reset_launch_count() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = _bf16_launches[name] = 0


def _count(name: str, bf16: bool) -> None:
    with _count_lock:
        _launches[name] += 1
        _bf16_launches[name] += bf16


def _causal_logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(BH, T, T) float32 logits, masked keys at NEG."""
    t = q.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return torch.where(mask, s, torch.full_like(s, NEG))


def _as_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 matmul operand rounded to the input dtype (exact for f32)."""
    return x.to(dtype).float()


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward in plain PyTorch: (O in q's dtype, float32 LSE (BH, T))."""
    s = _causal_logits(q, k, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(_as_operand(p, v.dtype), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_ds(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """P recomputed from the logits and dS = P * (dP - delta) * scale,
    float32 (BH, T, T); delta is (BH, T)."""
    s = _causal_logits(q, k, scale)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dQ kernel's function in plain PyTorch: (dq, float32 delta =
    rowsum(dO * O) (BH, T))."""
    delta = (do.float() * o.float()).sum(-1)
    _, ds = _probs_and_ds(q, k, v, do, delta, scale)
    return torch.matmul(_as_operand(ds, q.dtype), k.float()).to(q.dtype), delta


def flash_attention_bwd_dkdv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function in plain PyTorch, given delta: (dk, dv)."""
    dt = q.dtype
    p, ds = _probs_and_ds(q, k, v, do, delta, scale)
    dk = torch.matmul(_as_operand(ds, dt).transpose(1, 2), q.float())
    dv = torch.matmul(_as_operand(p, dt).transpose(1, 2), do.float())
    return dk.to(dt), dv.to(dt)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv in plain PyTorch, the math of ``_bwd_tile``: P recomputed
    from the logits, delta = rowsum(dO * O) in float32, dS = P * (dP -
    delta) * scale, and each product with its operands in the input dtype.
    Split as the kernels are: the dQ part writes delta, the dK/dV part
    reads it."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, o, do, scale)
    dk, dv = flash_attention_bwd_dkdv_plain(q, k, v, do, delta, scale)
    return dq, dk, dv


def _check(*tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.ndim != 3:
        raise ValueError(f"expected (BH, T, D) tensors, got {tuple(q.shape)}")
    bh, t, d = q.shape
    for x in tensors:
        if x.shape != q.shape:
            raise ValueError(f"shapes differ: {tuple(x.shape)} and {tuple(q.shape)}")
        if x.dtype != q.dtype:
            raise ValueError(f"dtypes differ: {x.dtype} and {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"devices differ: {x.device} and {q.device}")
        if not x.is_contiguous():
            raise ValueError("q, k and v must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected float32 or bfloat16, got {q.dtype}")
    if t < 1 or not 1 <= d <= MAX_D:
        raise ValueError(f"unsupported shape T={t} D={d} (T >= 1, D <= {MAX_D})")


_lib: ctypes.CDLL | None = None


def load(rebuild: bool = False) -> ctypes.CDLL:
    """Build (see ``build.load_library``) and bind the kernels' library."""
    global _lib
    if _lib is None:
        lib = build.load_library("flash_attention", [SOURCE], rebuild)
        tail = [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.flash_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.flash_attention_bwd_dkdv.argtypes = [ctypes.c_void_p] * 8 + tail
        for fn in (lib.flash_attention_fwd, lib.flash_attention_bwd_dq,
                   lib.flash_attention_bwd_dkdv):
            fn.restype = ctypes.c_int
        lib.flash_attention_plan.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                                             + [ctypes.POINTER(ctypes.c_int)])
        lib.flash_attention_plan.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _cuda_call(name: str, fn, device: torch.device, *args) -> None:
    """Launch ``fn(*args, stream)``; the last of ``args`` is the bf16 flag."""
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream)
    if err != 0:
        msg = _lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    _count(name, bool(args[-1]))


def _require_cuda(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"the flash attention kernels need CUDA tensors, got {q.device}")
    if q.shape[0] > MAX_BH:
        raise ValueError(f"BH={q.shape[0]} exceeds the kernels' grid ({MAX_BH})")


def launch_plan(name: str, q: torch.Tensor) -> dict:
    """The launch kernel ``name`` makes for CUDA tensors shaped and placed as
    ``q``: ``ctas``, ``threads`` per CTA, ``registers`` and ``spill_bytes``
    per thread, ``smem_bytes`` per CTA, ``ctas_per_sm`` resident,
    ``streamed_rows`` per streamed tile and ``tma`` (1 when the tiles are
    staged by TMA, 0 by cp.async). Refuses non-CUDA tensors."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}: expected one of {KERNELS}")
    _check(q)
    _require_cuda(q)
    lib = load()
    bh, t, d = q.shape
    info = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_plan(KERNELS.index(name), q.data_ptr(), bh, t, d,
                                       int(q.dtype == torch.bfloat16), info)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"{name} launch plan failed: {msg} ({err})")
    return dict(zip(_PLAN_KEYS, info))


def launch_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: (O, float32 LSE). Refuses non-CUDA tensors."""
    _check(q, k, v)
    _require_cuda(q)
    lib = load()
    bh, t, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    if bh:
        _cuda_call("flash_fwd", lib.flash_attention_fwd, q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                   bh, t, d, scale, int(q.dtype == torch.bfloat16))
    return o, lse


def _check_rows(name: str, x: torch.Tensor, q: torch.Tensor) -> None:
    bh, t, _ = q.shape
    if (x.shape != (bh, t) or x.dtype != torch.float32 or not x.is_contiguous()
            or x.device != q.device):
        raise ValueError(f"{name}: expected contiguous float32 ({bh}, {t}) on {q.device}, "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def launch_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dQ kernel: (dQ, float32 delta = rowsum(dO * O)). Refuses
    non-CUDA tensors."""
    _check(q, k, v, o, do)
    _require_cuda(q)
    _check_rows("lse", lse, q)
    lib = load()
    bh, t, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty(bh, t, dtype=torch.float32, device=q.device)
    if bh:
        _cuda_call("flash_bwd_dq", lib.flash_attention_bwd_dq, q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, t, d, scale,
                   int(q.dtype == torch.bfloat16))
    return dq, delta


def launch_bwd_dkdv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
    delta: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel, given the LSE and delta: (dK, dV). Refuses
    non-CUDA tensors."""
    _check(q, k, v, do)
    _require_cuda(q)
    _check_rows("lse", lse, q)
    _check_rows("delta", delta, q)
    lib = load()
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if bh:
        _cuda_call("flash_bwd_dkdv", lib.flash_attention_bwd_dkdv, q.device,
                   q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, t, d, scale,
                   int(q.dtype == torch.bfloat16))
    return dk, dv


def launch_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward kernels (dQ, which writes delta, then dK/dV): (dQ, dK,
    dV). Refuses non-CUDA tensors."""
    dq, delta = launch_bwd_dq(q, k, v, o, do, lse, scale)
    dk, dv = launch_bwd_dkdv(q, k, v, do, lse, delta, scale)
    return dq, dk, dv


class _FlashCausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_fwd_plain(q, k, v, scale)
        else:
            o, lse = launch_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, do, ctx.scale)
        else:
            dq, dk, dv = launch_bwd(q, k, v, o, do, lse, ctx.scale)
        return dq, dk, dv, None


def flash_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Causal softmax(Q K^T * scale) V over (BH, T, D), differentiable.

    CPU tensors run the plain pair; CUDA tensors launch the kernels or
    raise."""
    _check(q, k, v)
    return _FlashCausalAttention.apply(q, k, v, float(scale))

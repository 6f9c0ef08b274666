"""Fused Adam (+ parameter EMA): the CUDA kernel's wrapper and its plain version.

Counterpart of ``neural_sound_generation_tpu/ops/pallas/fused_adam.py``. One
pass over flat vectors of n elements (``csrc/fused_adam.cu``): the clip
scale, weight decay, the Adam moments with bias correction, the parameter
step and the optional EMA. ``p``, ``m``, ``v`` and ``ema`` are updated in
place, as the Pallas kernel's input/output aliases do; ``g``, ``p`` and
``ema`` are float32, ``m`` and ``v`` float32 or bfloat16 (updated in float32,
rounded to nearest even on store).

The five per-step scalars come as a float32 device tensor ``scalars`` =
``[gscale, lr, bias_corr1, bias_corr2, ema_decay]`` (``gscale`` the clip
factor, ``bias_corr{1,2}`` = 1 - beta**(count+1)), so a step never waits on
the host. ``training.train_state.fused_flat_update`` builds them.

``fused_adam_update`` runs the plain version for tensors on the CPU and the
kernel for tensors on a CUDA device; ``launch`` runs the kernel only and
refuses anything else. There is no fallback between the two.
``launch_count()`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from neural_sound_generation_tpu_torch.ops.cuda import build

SOURCE = build.CSRC / "fused_adam.cu"
N_SCALARS = 5

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def fused_adam_plain(
    flat_g: torch.Tensor, flat_p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    ema: torch.Tensor | None, scalars: torch.Tensor, *,
    b1: float, b2: float, eps: float, clip: bool, wd: float,
) -> None:
    """The kernel's function in plain PyTorch, in place: the math of
    ``fused_flat_update`` (clip -> weight decay -> Adam -> EMA) on tensors.
    Each operation rounds to float32, in the order the kernel runs them."""
    gscale, lr, bc1, bc2, d = scalars.unbind()
    g = flat_g.to(torch.float32)
    if clip:
        g = g * gscale
    if wd > 0:
        g = g + wd * flat_p
    m_f = b1 * m.to(torch.float32) + (1.0 - b1) * g
    v_f = b2 * v.to(torch.float32) + (1.0 - b2) * g * g
    m_hat = m_f / bc1
    v_hat = v_f / bc2
    flat_p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
    m.copy_(m_f)
    v.copy_(v_f)
    if ema is not None:
        ema.copy_(d * ema + (1.0 - d) * flat_p)


def _check(flat_g, flat_p, m, v, ema, scalars) -> None:
    n = flat_p.numel()
    vectors = [("g", flat_g), ("p", flat_p), ("m", m), ("v", v)]
    if ema is not None:
        vectors.append(("ema", ema))
    for name, t in vectors:
        if t.ndim != 1 or t.numel() != n:
            raise ValueError(f"{name}: expected a flat vector of {n}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != flat_p.device:
            raise ValueError(f"{name} on {t.device}, p on {flat_p.device}")
    for name, t in (("g", flat_g), ("p", flat_p), ("ema", ema)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if m.dtype != v.dtype or m.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"moments must be both float32 or both bfloat16: {m.dtype}, {v.dtype}")
    if scalars.shape != (N_SCALARS,) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars: expected ({N_SCALARS},) float32, got "
                         f"{tuple(scalars.shape)} {scalars.dtype}")
    if scalars.device != flat_p.device:
        raise ValueError(f"scalars on {scalars.device}, p on {flat_p.device}")
    spans = sorted(
        (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size(), name)
        for name, t in vectors
    )
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        if start < end:
            raise ValueError(f"{a} and {b} overlap: the update is in place")


_lib: ctypes.CDLL | None = None


def load(rebuild: bool = False) -> ctypes.CDLL:
    """Build (see ``build.load_library``) and bind the kernel's library."""
    global _lib
    if _lib is None:
        lib = build.load_library("fused_adam", [SOURCE], rebuild)
        lib.fused_adam_f32.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int]
            + [ctypes.c_float] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        lib.fused_adam_f32.restype = ctypes.c_int
        lib.fused_adam_error_string.argtypes = [ctypes.c_int]
        lib.fused_adam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(
    flat_g: torch.Tensor, flat_p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    ema: torch.Tensor | None, scalars: torch.Tensor, *,
    b1: float, b2: float, eps: float, clip: bool, wd: float,
) -> None:
    """Launch the CUDA kernel (in place). Refuses tensors that are not on
    a CUDA device."""
    global _launches
    _check(flat_g, flat_p, m, v, ema, scalars)
    device = flat_p.device
    if device.type != "cuda":
        raise ValueError(f"the fused_adam kernel needs CUDA tensors, got {device}")
    lib = load()
    n = flat_p.numel()
    if n == 0:
        return
    bf16 = m.dtype == torch.bfloat16
    vectors = [flat_g, flat_p, ema] if ema is not None else [flat_g, flat_p]
    vec = all(t.data_ptr() % 16 == 0 for t in vectors) and all(
        t.data_ptr() % (8 if bf16 else 16) == 0 for t in (m, v)
    )
    with torch.cuda.device(device):
        err = lib.fused_adam_f32(
            flat_g.data_ptr(), flat_p.data_ptr(), m.data_ptr(), v.data_ptr(),
            ema.data_ptr() if ema is not None else None, scalars.data_ptr(),
            n, int(bf16), b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
            int(bool(clip)), int(ema is not None), int(vec),
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        msg = lib.fused_adam_error_string(err).decode()
        raise RuntimeError(f"fused_adam kernel launch failed: {msg} ({err})")
    with _count_lock:
        _launches += 1


def fused_adam_update(
    flat_g: torch.Tensor, flat_p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
    ema: torch.Tensor | None, scalars: torch.Tensor, *,
    b1: float, b2: float, eps: float, clip: bool, wd: float,
) -> None:
    """One fused update, in place on ``flat_p``, ``m``, ``v`` and ``ema``.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    if flat_p.device.type == "cpu":
        _check(flat_g, flat_p, m, v, ema, scalars)
        fused_adam_plain(flat_g, flat_p, m, v, ema, scalars,
                         b1=b1, b2=b2, eps=eps, clip=clip, wd=wd)
        return
    launch(flat_g, flat_p, m, v, ema, scalars, b1=b1, b2=b2, eps=eps, clip=clip, wd=wd)

"""3x3 SAME convolution in bf16: the CUDA kernels' wrappers and their plain version.

Counterpart of ``scripts/ab_conv3x3.py``'s two Pallas kernels, ``pallas_conv``
(tap-accumulate) and ``pallas_conv_im2col`` (one contraction over the patch
row), and of ``xla_conv``, the function both compute: ``x`` (B, H, W, C)
bf16 NHWC and ``w`` (3, 3, C, C) bf16 HWIO, zero padding of 1, products
summed in float32 and rounded once to a bf16 output.

``csrc/conv3x3.cu`` holds both as one kernel template for Hopper: a CTA
takes a run of 64 pixels in (b, h, w) order against 128 output channels,
the weights stream in by TMA through an mbarrier-guarded ring, and the
products run on the tensor cores (``wgmma``, bf16 in, f32 out, each short
chain summed into a fresh accumulator and added to the running sum in
IEEE f32). ``conv3x3_taps`` stages each 64-channel chunk's halo once for
the nine taps (no patch matrix); ``conv3x3_im2col`` gathers each
(tap, chunk) slice of the patch row. They take any B, H, W >= 1 and C a
multiple of 16 up to 512, in one launch per call. ``launch_plan`` reports
a launch's CTAs, registers, spills and shared memory.

The kernels sit on no training path: the port's ``--bf16`` step runs
cuDNN's convolution, as the JAX package's runs XLA's. Their entry point is
the A/B script ``scripts/torch_ab_conv3x3.py``. Each wrapper runs the plain
version for tensors on the CPU and launches its kernel for tensors on a
CUDA device, or raises; there is no fallback between the two.
``launch_counts()`` counts each kernel's launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from neural_sound_generation_tpu_torch.ops.cuda import build

SOURCE = build.CSRC / "conv3x3.cu"
KERNELS = ("conv3x3_taps", "conv3x3_im2col")
MAX_C = 512
_PLAN_KEYS = ("ctas", "threads", "registers", "spill_bytes", "smem_bytes", "ctas_per_sm")

_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict[str, int]:
    with _count_lock:
        return dict(_launches)


def reset_launch_count() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernels' function in plain PyTorch: nine shifted tap products in
    float32, summed in tap order (dy, then dx), rounded once to x's dtype."""
    _, h, wd, _ = x.shape
    xp = F.pad(x.to(torch.float32), (0, 0, 1, 1, 1, 1))
    acc = None
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        term = xp[:, dy : dy + h, dx : dx + wd, :] @ w[dy, dx].to(torch.float32)
        acc = term if acc is None else acc + term
    return acc.to(x.dtype)


def bf16_ulp_error(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """|got - want| in bf16 ulps of ``want``, float32, elementwise. The ulp
    is taken at the larger of |want| and 2**-8 of the largest |want|: two
    float32 sums of the same products in another order differ by their
    rounding noise, which near a cancellation to zero is many bf16 ulps of
    the tiny result but stays below one ulp at that floor."""
    g, w = got.to(torch.float32), want.to(torch.float32)
    mag = torch.maximum(w.abs(), w.abs().max() * 2.0**-8)
    mag = mag.clamp(min=torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # 8 significand bits
    return (g - w).abs() / ulp


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(
            f"expected x (B, H, W, C) and w (3, 3, C, C), got {tuple(x.shape)} and "
            f"{tuple(w.shape)}"
        )
    b, h, wd, c = x.shape
    if tuple(w.shape) != (3, 3, c, c):
        raise ValueError(f"w {tuple(w.shape)} for x with {c} channels: expected (3, 3, {c}, {c})")
    if min(b, h, wd) < 1 or c % 16 or not 16 <= c <= MAX_C:
        raise ValueError(
            f"unsupported shape B={b} H={h} W={wd} C={c} "
            f"(C a multiple of 16 up to {MAX_C})"
        )
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"expected bfloat16, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")


_lib: ctypes.CDLL | None = None


def load(rebuild: bool = False) -> ctypes.CDLL:
    """Build (see ``build.load_library``) and bind the kernels' library."""
    global _lib
    if _lib is None:
        lib = build.load_library("conv3x3", [SOURCE], rebuild)
        for name in ("conv3x3_taps_bf16", "conv3x3_im2col_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.conv3x3_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        lib.conv3x3_plan.restype = ctypes.c_int
        lib.conv3x3_error_string.argtypes = [ctypes.c_int]
        lib.conv3x3_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.conv3x3_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def launch_plan(name: str, x: torch.Tensor, w: torch.Tensor) -> dict:
    """The launch kernel ``name`` makes for these CUDA tensors: ``ctas``,
    ``threads`` per CTA, ``registers`` per thread, ``spill_bytes`` per
    thread, ``smem_bytes`` per CTA and ``ctas_per_sm`` resident."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel {name!r}: expected one of {KERNELS}")
    _check(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches only for CUDA tensors, got {x.device}")
    lib = load()
    info = (ctypes.c_int * len(_PLAN_KEYS))()
    with torch.cuda.device(x.device):
        err = lib.conv3x3_plan(KERNELS.index(name), *x.shape, info)
    _raise_on(lib, err, f"{name} launch plan")
    return dict(zip(_PLAN_KEYS, info))


def _conv(name: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check(x, w)
    device = x.device
    if device.type == "cpu":
        return conv3x3_plain(x, w)
    if device.type != "cuda":
        raise ValueError(f"no {name} kernel for device {device}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name} needs 16-byte aligned x and w")
    lib = load()
    out = torch.empty_like(x)
    with torch.cuda.device(device):
        err = getattr(lib, f"{name}_bf16")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), *x.shape,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, f"{name} kernel launch")
    with _count_lock:
        _launches[name] += 1
    return out


def conv3x3_taps(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x (3, 3, C, C) bf16 -> (B, H, W, C) bf16, tap-accumulate.
    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    return _conv("conv3x3_taps", x, w)


def conv3x3_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function as ``conv3x3_taps``, by one contraction of length
    9C over the patch row. CPU tensors run the plain version; CUDA tensors
    launch the kernel or raise."""
    return _conv("conv3x3_im2col", x, w)

"""Nearest-code search: the CUDA kernel's wrapper and its plain version.

Counterpart of ``neural_sound_generation_tpu/ops/pallas/vq_kernel.py``. The
kernel (``csrc/vq_nearest.cu``) computes, for (N, D) inputs and a (K, D)
codebook, ``argmin_k(|e_k|^2 - 2 x.e_k)`` with the dot products inside the
kernel and a running (min, index) per row, so the (N, K) score matrix never
reaches device memory. Ties go to the first index, as ``torch.argmin`` and
``jnp.argmin`` break them. Unlike the Pallas version it has no alignment
constraint: any N, any K, and D up to ``MAX_D``.

``nearest_codebook_indices`` runs the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device; there is no fallback between
the two. ``launch_count()`` counts kernel launches, so a run can show that
its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from neural_sound_generation_tpu_torch.ops.cuda import build

SOURCE = build.CSRC / "vq_nearest.cu"
MAX_D = 1024
_INT32_MAX = 2**31 - 1

_count_lock = threading.Lock()
_launches = 0


def launch_count() -> int:
    return _launches


def reset_launch_count() -> None:
    global _launches
    with _count_lock:
        _launches = 0


def nearest_codebook_indices_plain(
    inputs_flat: torch.Tensor, codebook: torch.Tensor
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (N,) int32 indices."""
    cbsq = torch.sum(codebook * codebook, dim=1)
    scores = cbsq[None, :] - 2.0 * (inputs_flat @ codebook.T)
    return torch.argmin(scores, dim=1).to(torch.int32)


def _check(inputs_flat: torch.Tensor, codebook: torch.Tensor) -> None:
    if inputs_flat.ndim != 2 or codebook.ndim != 2:
        raise ValueError(
            f"expected (N, D) inputs and a (K, D) codebook, got "
            f"{tuple(inputs_flat.shape)} and {tuple(codebook.shape)}"
        )
    n, d = inputs_flat.shape
    k, d_cb = codebook.shape
    if d != d_cb:
        raise ValueError(f"feature widths differ: inputs {d}, codebook {d_cb}")
    if not 1 <= d <= MAX_D or not 1 <= k <= _INT32_MAX or n > _INT32_MAX:
        raise ValueError(f"unsupported shape N={n} K={k} D={d} (D <= {MAX_D})")
    if inputs_flat.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise ValueError(
            f"expected float32, got {inputs_flat.dtype} and {codebook.dtype}"
        )
    if inputs_flat.device != codebook.device:
        raise ValueError(
            f"inputs on {inputs_flat.device}, codebook on {codebook.device}"
        )
    if not (inputs_flat.is_contiguous() and codebook.is_contiguous()):
        raise ValueError("inputs and codebook must be contiguous")


_lib: ctypes.CDLL | None = None


def load(rebuild: bool = False) -> ctypes.CDLL:
    """Build (see ``build.load_library``) and bind the kernel's library."""
    global _lib
    if _lib is None:
        lib = build.load_library("vq_nearest", [SOURCE], rebuild)
        lib.vq_nearest_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        )
        lib.vq_nearest_f32.restype = ctypes.c_int
        lib.vq_nearest_error_string.argtypes = [ctypes.c_int]
        lib.vq_nearest_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def nearest_codebook_indices(
    inputs_flat: torch.Tensor, codebook: torch.Tensor
) -> torch.Tensor:
    """(N, D) x (K, D) -> (N,) int32 nearest-code indices.

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    global _launches
    _check(inputs_flat, codebook)
    device = inputs_flat.device
    if device.type == "cpu":
        return nearest_codebook_indices_plain(inputs_flat, codebook)
    if device.type != "cuda":
        raise ValueError(f"no nearest-code search for device {device}")
    lib = load()
    n, d = inputs_flat.shape
    k = codebook.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    cbsq = torch.sum(codebook * codebook, dim=1)
    with torch.cuda.device(device):
        err = lib.vq_nearest_f32(
            inputs_flat.data_ptr(), codebook.data_ptr(), cbsq.data_ptr(),
            out.data_ptr(), n, k, d, torch.cuda.current_stream(device).cuda_stream,
        )
    if err != 0:
        msg = lib.vq_nearest_error_string(err).decode()
        raise RuntimeError(f"vq_nearest kernel launch failed: {msg} ({err})")
    with _count_lock:
        _launches += 1
    return out

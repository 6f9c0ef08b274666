"""Nearest-code search: the CUDA kernel's wrapper and its plain version.

Counterpart of ``neural_sound_generation_tpu/ops/pallas/vq_kernel.py``. The
kernel (``csrc/vq_nearest.cu``) computes, for (N, D) inputs and a (K, D)
codebook, ``argmin_k(|e_k|^2 - 2 x.e_k)`` in one launch, with the dot
products inside the kernel and a running (min, index) per row, so the
(N, K) score matrix never reaches device memory. Ties go to the first
index, as ``torch.argmin`` and ``jnp.argmin`` break them, and an all-NaN
row gives 0. Unlike the Pallas version it has no alignment constraint: any
N, any K, and D up to ``MAX_D``.

The kernel is built for Hopper: each CTA takes 64 rows against a slice of
the codebook, the slices of one row tile form a thread-block cluster that
merges its (min, index) pairs through distributed shared memory, the
codebook streams in through TMA, and the products run on the tensor cores
as three TF32 products (3xTF32) summed per 32-feature step into a fresh
accumulator, so that they keep float32's accuracy and near-ties stay
near-ties. The arithmetic rate bounds it. ``launch_plan`` reports the
cluster size and CTA count of a launch. The result is deterministic run
to run.

With ``return_scores`` the kernel also writes each row's winning score
(|e_k|^2 - 2 x.e_k, float32): a codebook sharded by rows over the mesh's
model axis is searched shard by shard, and the shards' (score, index)
pairs merge lexicographically (``ops.vq``) into the whole codebook's
answer. A code's score does not depend on where its tile or cluster CTA
sits, so a shard's scores are bit-identical to the whole codebook's.

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
    inputs_flat: torch.Tensor, codebook: torch.Tensor, return_scores: bool = False
):
    """The kernel's function in plain PyTorch: (N,) int32 indices, and with
    ``return_scores`` the (N,) float32 winning scores beside them."""
    cbsq = torch.sum(codebook * codebook, dim=1)
    scores = cbsq[None, :] - 2.0 * (inputs_flat @ codebook.T)
    idx = torch.argmin(scores, dim=1)
    if not return_scores:
        return idx.to(torch.int32)
    return idx.to(torch.int32), scores.gather(1, idx[:, None])[:, 0]


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
        lib.vq_nearest_plan.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_int)] * 3
        )
        lib.vq_nearest_plan.restype = ctypes.c_int
        lib.vq_nearest_error_string.argtypes = [ctypes.c_int]
        lib.vq_nearest_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.vq_nearest_error_string(err).decode()
        raise RuntimeError(f"vq_nearest {what} failed: {msg} ({err})")


def launch_plan(inputs_flat: torch.Tensor, codebook: torch.Tensor) -> dict:
    """The launch the kernel makes for these CUDA tensors: cluster size
    ``split`` (CTAs sharing one 64-row tile), ``ctas`` and whether it
    stages through ``tma``."""
    _check(inputs_flat, codebook)
    lib = load()
    n, d = inputs_flat.shape
    split, ctas, tma = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(inputs_flat.device):
        err = lib.vq_nearest_plan(
            inputs_flat.data_ptr(), codebook.data_ptr(), n, codebook.shape[0], d,
            ctypes.byref(split), ctypes.byref(ctas), ctypes.byref(tma),
        )
    _raise_on(lib, err, "launch plan")
    return {"split": split.value, "ctas": ctas.value, "tma": bool(tma.value)}


def nearest_codebook_indices(
    inputs_flat: torch.Tensor, codebook: torch.Tensor, return_scores: bool = False
):
    """(N, D) x (K, D) -> (N,) int32 nearest-code indices, and with
    ``return_scores`` the (N,) float32 winning scores (one launch either
    way).

    CPU tensors run the plain version; CUDA tensors launch the kernel or
    raise."""
    global _launches
    _check(inputs_flat, codebook)
    device = inputs_flat.device
    if device.type == "cpu":
        return nearest_codebook_indices_plain(inputs_flat, codebook, return_scores)
    if device.type != "cuda":
        raise ValueError(f"no nearest-code search for device {device}")
    lib = load()
    n, d = inputs_flat.shape
    k = codebook.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=device)
    scores = torch.empty(n, dtype=torch.float32, device=device) if return_scores else None
    if n == 0:
        return (out, scores) if return_scores else out
    with torch.cuda.device(device):
        err = lib.vq_nearest_f32(
            inputs_flat.data_ptr(), codebook.data_ptr(), out.data_ptr(),
            None if scores is None else scores.data_ptr(), n, k, d,
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(lib, err, "kernel launch")
    with _count_lock:
        _launches += 1
    return (out, scores) if return_scores else out

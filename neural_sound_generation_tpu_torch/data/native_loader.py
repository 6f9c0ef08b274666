"""ctypes binding to the native data-loader runtime (``native/loader.cpp``).

Counterpart of ``neural_sound_generation_tpu/data/native_loader.py``: the
same C ABI of ``native/loader.cpp`` (a copy of the JAX package's source)
bound the same way. The corpus shards are mmap'd once by the C++ runtime
and a batch is assembled by memcpy into preallocated numpy buffers with
the GIL released, so the loader's prefetch thread overlaps the step in
one process. Crop and pad semantics and the RNG call order are
``data.collate.collate_mel_batch``'s: native batches are bit-equal to the
Python collate.

The library is compiled at first use by the ``g++`` on ``PATH`` with the
flags of ``native/Makefile`` into ``build/native/`` (``native_build``, as
``motion.capture``'s runtime is).

Which path a loader takes is decided once, up front
(``data.pipeline.MelFrameLoader``'s ``use_native``): by default native
where ``g++`` is on ``PATH`` (``native_available``). A build or load
failure then raises; the loader never falls back to the Python collate
quietly, as the JAX package's does.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from neural_sound_generation_tpu_torch import native_build
from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.data.collate import (
    _mulaw_quantize_np,
    static_crop_frames,
)

NATIVE_SOURCE = Path(__file__).resolve().parent / "native" / "loader.cpp"
BUILD_DIR = native_build.BUILD_DIR
_lib = None
_lib_lock = threading.Lock()

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def native_available() -> bool:
    """Whether a loader takes the native path by default: a ``g++`` on
    ``PATH``. Whether the library then builds and loads is not tried here:
    a failure there raises when a loader is made."""
    return shutil.which("g++") is not None


def library_path() -> Path:
    """Where the library of this source, compiler and flags lives."""
    return native_build.library_path(NATIVE_SOURCE, "libnsgloader", what="the native loader")


def build(path: Path) -> None:
    """Compile ``native/loader.cpp`` into ``path``."""
    native_build.build(NATIVE_SOURCE, path, what="the native loader")


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    """Build (once per digest, or again with ``rebuild`` on the first load
    in a process) and load the library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if rebuild or not path.exists():
            build(path)
        lib = ctypes.CDLL(str(path))
        lib.nsg_corpus_open.restype = ctypes.c_void_p
        lib.nsg_corpus_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ]
        lib.nsg_corpus_close.argtypes = [ctypes.c_void_p]
        lib.nsg_corpus_len.restype = ctypes.c_int
        lib.nsg_corpus_len.argtypes = [ctypes.c_void_p]
        lib.nsg_corpus_meta.argtypes = [ctypes.c_void_p, _i64p, _i64p, _i64p]
        lib.nsg_fill_mel_batch.restype = ctypes.c_int
        lib.nsg_fill_mel_batch.argtypes = [
            ctypes.c_void_p, _i32p, _i64p, _i64p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, _f32p,
        ]
        lib.nsg_fill_audio_f32.restype = ctypes.c_int
        lib.nsg_fill_audio_f32.argtypes = [
            ctypes.c_void_p, _i32p, _i64p, _i64p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, _f32p,
        ]
        lib.nsg_fill_audio_i32.restype = ctypes.c_int
        lib.nsg_fill_audio_i32.argtypes = [
            ctypes.c_void_p, _i32p, _i64p, _i64p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, _i32p,
        ]
        lib.nsg_corpus_willneed.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        _lib = lib
        return lib


class NativeCorpus:
    """mmap'd view of a preprocessed corpus (paired audio and mel shards).

    ``audio_paths``/``mel_paths`` are absolute paths in manifest order. A
    None mel entry opens (the C layer skips empty paths), but ``collate``
    needs every batch item's mel shard and fails there with a clear
    error. A shard the runtime cannot map (truncated, not a .npy, more
    than two dimensions, an unsupported dtype) fails the open with
    ``OSError``."""

    def __init__(self, audio_paths: Sequence[str], mel_paths: Sequence[Optional[str]]):
        lib = load_library()
        n = len(audio_paths)
        a_arr = (ctypes.c_char_p * n)(*[p.encode() for p in audio_paths])
        m_arr = (ctypes.c_char_p * n)(*[(p or "").encode() for p in mel_paths])
        handle = lib.nsg_corpus_open(a_arr, m_arr, n)
        if not handle:
            raise OSError("nsg_corpus_open failed (see stderr)")
        self._lib = lib
        self._handle = handle
        self.n = n
        self.audio_len = np.zeros(n, np.int64)
        self.mel_frames = np.zeros(n, np.int64)
        self.mel_bins = np.zeros(n, np.int64)
        lib.nsg_corpus_meta(handle, self.audio_len.ctypes.data_as(_i64p),
                            self.mel_frames.ctypes.data_as(_i64p),
                            self.mel_bins.ctypes.data_as(_i64p))

    def close(self):
        if self._handle:
            self._lib.nsg_corpus_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        return self.n

    def collate(
        self,
        indices: Sequence[int],
        cfg: AudioConfig,
        max_time_steps: Optional[int],
        rng: Optional[np.random.Generator] = None,
        latent_stride: int = 4,
        frames_out: Optional[int] = None,
        speaker_ids: Optional[Sequence[Optional[int]]] = None,
        need_audio: bool = True,
    ) -> Dict[str, np.ndarray]:
        """``collate_mel_batch`` over the mmap'd shards: the same outputs
        (its ``one_hot=False`` contract), the same RNG call order, the
        bytes moved in C++. ``need_audio=False`` skips the x/y fills for
        mel-mode training, which reads only ``c`` (and ``g``)."""
        rng = rng or np.random.default_rng()
        hop = cfg.effective_hop_size
        if frames_out is None:
            frames_out = static_crop_frames(max_time_steps, hop, latent_stride)
        samples_out = frames_out * hop
        b = len(indices)
        idx = np.asarray(indices, np.int32)
        a_len = self.audio_len[idx]
        m_frames = self.mel_frames[idx]
        n_mels = int(self.mel_bins[idx].max()) if b else 0
        if b and n_mels == 0:
            raise ValueError("collate needs paired mel shards; this corpus was opened "
                             "with empty mel paths for the requested items")

        usable = np.minimum(a_len // hop, m_frames)
        starts = np.zeros(b, np.int64)
        # collate_mel_batch's RNG call order: one draw per item that crops
        for i in range(b):
            if usable[i] > frames_out:
                starts[i] = int(rng.integers(0, usable[i] - frames_out))
        # the audio placed in the batch, as collate_mel_batch counts it:
        # usable * hop when padding, samples_out when cropping
        lengths = (np.minimum(usable, frames_out) * hop).astype(np.int32)

        lib, h = self._lib, self._handle
        ip, sp, up = (idx.ctypes.data_as(_i32p), starts.ctypes.data_as(_i64p),
                      usable.ctypes.data_as(_i64p))
        c = np.empty((b, frames_out, n_mels), np.float32)
        rc = lib.nsg_fill_mel_batch(h, ip, sp, up, b, frames_out, n_mels,
                                    c.ctypes.data_as(_f32p))
        if rc != 0:
            raise RuntimeError(f"nsg_fill_mel_batch failed: {rc}")
        out: Dict[str, np.ndarray] = {"c": np.ascontiguousarray(c.transpose(0, 2, 1)),
                                      "input_lengths": lengths}
        if need_audio:
            if cfg.is_mulaw_quantize:
                # the pad value is one of the compared bytes: the Python
                # collate's own formula, never a second one
                pad = int(_mulaw_quantize_np(np.float64(0.0), cfg.quantize_channels))
                y32 = np.empty((b, samples_out), np.int32)
                rc = lib.nsg_fill_audio_i32(h, ip, sp, up, b, frames_out, hop, pad,
                                            y32.ctypes.data_as(_i32p))
                if rc != 0:
                    raise RuntimeError(f"nsg_fill_audio_i32 failed: {rc}")
                out["y"] = y32.astype(np.int64)
                out["x"] = y32  # one_hot=False: int codes
            else:
                y = np.empty((b, samples_out), np.float32)
                rc = lib.nsg_fill_audio_f32(h, ip, sp, up, b, frames_out, hop, 0.0,
                                            y.ctypes.data_as(_f32p))
                if rc != 0:
                    raise RuntimeError(f"nsg_fill_audio_f32 failed: {rc}")
                out["y"] = y
                out["x"] = y[..., None]
        if speaker_ids is not None and b > 0 and all(g is not None for g in speaker_ids):
            out["g"] = np.asarray(speaker_ids, np.int32)
        else:
            out["g"] = None
        return out

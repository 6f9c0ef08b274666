"""LibriVox corpus adapter (src/librivox.py).

Long-form audiobook recordings: every audio file under ``<in_dir>`` is
chunked into fixed ~8 s utterances (the reference's long-context strategy
— offline chunking instead of sequence parallelism, src/librivox.py:55-62).
A copy of ``neural_sound_generation_tpu/data/corpora/librivox.py`` on the
port's engine.
"""

from __future__ import annotations

import glob
import os
import threading
from collections import OrderedDict
from typing import List, Optional

import numpy as np

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.data.corpora.engine import (
    UtteranceSpec,
    convention,
    preprocess_utterances,
)
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry
from neural_sound_generation_tpu_torch.ops import dsp

CHUNK_SECONDS = 8.0


def collect(in_dir: str, cfg: AudioConfig) -> List[UtteranceSpec]:
    specs: List[UtteranceSpec] = []
    paths = sorted(glob.glob(os.path.join(in_dir, "**", "*.wav"), recursive=True))
    chunk = int(CHUNK_SECONDS * cfg.sample_rate)
    for path in paths:
        # chunk lazily: each spec loads the file and slices its window
        wav_len = _wav_num_samples(path, cfg.sample_rate)
        n_chunks = max(1, wav_len // chunk)
        base = os.path.splitext(os.path.basename(path))[0]
        for ci in range(n_chunks):
            specs.append(
                UtteranceSpec(
                    utt_id=f"{base}_{ci:04d}",
                    text=f"{base} chunk {ci}",
                    loader=_make_loader(path, cfg.sample_rate, ci * chunk, chunk),
                )
            )
    return specs


# Decoded-file cache: an 8h audiobook is ~2.5 GB of float32 and yields
# ~3600 chunk specs — re-decoding the whole file per chunk would make
# preprocessing quadratic per file. Chunks are generated (and processed)
# in file order, so a tiny LRU turns that into ~one decode per file;
# capacity 2 tolerates worker interleaving at file boundaries.
_DECODE_CACHE: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_DECODE_LOCK = threading.Lock()
_DECODE_CAPACITY = 2


def _load_full(path: str, sr: int) -> np.ndarray:
    key = (path, sr)
    with _DECODE_LOCK:
        if key in _DECODE_CACHE:
            _DECODE_CACHE.move_to_end(key)
            return _DECODE_CACHE[key]
    wav = dsp.load_wav(path, sr)
    with _DECODE_LOCK:
        _DECODE_CACHE[key] = wav
        _DECODE_CACHE.move_to_end(key)
        while len(_DECODE_CACHE) > _DECODE_CAPACITY:
            _DECODE_CACHE.popitem(last=False)
    return wav


def _wav_num_samples(path: str, sample_rate: int) -> int:
    # length probe; warms the decode cache for the file's chunk loaders
    return len(_load_full(path, sample_rate))


def _make_loader(path: str, sr: int, start: int, length: int):
    def load() -> np.ndarray:
        wav = _load_full(path, sr)
        # copy: a view would pin the whole decoded file in memory past
        # eviction and alias the shared cache entry
        return wav[start : start + length].copy()

    return load


def build_from_path(
    in_dir: str,
    out_dir: str,
    num_workers: int = 8,
    cfg: Optional[AudioConfig] = None,
    skip_errors: bool = False,
    tqdm=lambda x, **kw: x,
    device=None,
    device_batch: int = 16,
    **_legacy_kwargs,
) -> List[ManifestEntry]:
    # the reference's chain for this corpus is LWS-only (audio.py:112-127)
    cfg = convention(cfg or AudioConfig())
    specs = collect(in_dir, cfg)
    return preprocess_utterances(
        specs, out_dir, cfg, name="librivox", num_workers=num_workers,
        device_batch=device_batch, skip_errors=skip_errors, tqdm=tqdm, device=device,
    )

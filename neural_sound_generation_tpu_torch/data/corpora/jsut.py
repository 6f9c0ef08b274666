"""JSUT corpus adapter (src/jsut.py).

Layout: ``<in_dir>/<subset>/wav/*.wav`` with ``<in_dir>/<subset>/
transcript_utf8.txt`` (``id:text`` lines). The reference trims silence
using HTS-style ``.lab`` alignment files (src/jsut.py:41-49); when a
``lab/`` directory with matching files exists we honor it (first/last
non-``silB/silE`` segment), otherwise fall back to energy trimming. A copy
of ``neural_sound_generation_tpu/data/corpora/jsut.py`` on the port's
engine.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.data.corpora.engine import (
    UtteranceSpec,
    convention,
    preprocess_utterances,
)
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry
from neural_sound_generation_tpu_torch.ops import dsp

_HTS_UNITS_PER_SEC = 10_000_000  # HTS lab timestamps are in 100ns units


def _lab_trim(lab_path: str, sample_rate: int):
    """(start_sample, end_sample) from an HTS .lab alignment, skipping
    leading/trailing silence labels."""
    segs = []
    with open(lab_path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                segs.append((int(parts[0]), int(parts[1]), parts[2]))
    if not segs:
        return None
    silence = {"silB", "silE", "sil", "pau", "sp"}
    voiced = [s for s in segs if s[2] not in silence]
    if not voiced:
        return None
    start = voiced[0][0] * sample_rate // _HTS_UNITS_PER_SEC
    end = voiced[-1][1] * sample_rate // _HTS_UNITS_PER_SEC
    return start, end


def _read_transcripts(subset_dir: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    path = os.path.join(subset_dir, "transcript_utf8.txt")
    if not os.path.isfile(path):
        return out
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            utt, _, text = line.strip().partition(":")
            if utt:
                out[utt] = text
    return out


def collect(in_dir: str, cfg: AudioConfig) -> List[UtteranceSpec]:
    specs: List[UtteranceSpec] = []
    subsets = sorted(
        d for d in glob.glob(os.path.join(in_dir, "*")) if os.path.isdir(d)
    )
    if not subsets:
        subsets = [in_dir]
    for subset in subsets:
        transcripts = _read_transcripts(subset)
        for wav_path in sorted(glob.glob(os.path.join(subset, "wav", "*.wav"))):
            utt = os.path.splitext(os.path.basename(wav_path))[0]
            lab_path = os.path.join(subset, "lab", f"{utt}.lab")
            trim_fn = _make_trim(lab_path, cfg)
            specs.append(
                UtteranceSpec(
                    utt_id=utt,
                    text=transcripts.get(utt, utt),
                    wav_path=wav_path,
                    trim_fn=trim_fn,
                )
            )
    return specs


def _make_trim(lab_path: str, cfg: AudioConfig):
    def trim(wav: np.ndarray) -> np.ndarray:
        if os.path.isfile(lab_path):
            bounds = _lab_trim(lab_path, cfg.sample_rate)
            if bounds is not None:
                s, e = bounds
                return wav[max(0, s) : min(len(wav), e)]
        return dsp.trim_silence(wav, cfg) if cfg.trim_silence else wav

    return trim


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
    cfg = convention(cfg or AudioConfig(sample_rate=24000, fmax=11000))
    specs = collect(in_dir, cfg)
    return preprocess_utterances(
        specs, out_dir, cfg, name="jsut", num_workers=num_workers,
        device_batch=device_batch, skip_errors=skip_errors, tqdm=tqdm, device=device,
    )

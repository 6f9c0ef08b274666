"""LJSpeech corpus adapter (src/ljspeech.py).

Layout: ``<in_dir>/metadata.csv`` with ``id|raw_text|normalized_text``
lines and ``<in_dir>/wavs/<id>.wav``. The normalized text (parts[2]) is
the manifest text, matching src/ljspeech.py:21-23. A copy of
``neural_sound_generation_tpu/data/corpora/ljspeech.py`` on the port's
engine, with the engine's ``device`` and ``device_batch``.
"""

from __future__ import annotations

import os
from typing import List

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.data.corpora.engine import (
    UtteranceSpec,
    preprocess_utterances,
)
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry


def collect(in_dir: str) -> List[UtteranceSpec]:
    specs: List[UtteranceSpec] = []
    with open(os.path.join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if not parts or not parts[0]:
                continue
            wav_path = os.path.join(in_dir, "wavs", f"{parts[0]}.wav")
            text = parts[2] if len(parts) > 2 else parts[-1]
            specs.append(UtteranceSpec(utt_id=parts[0], text=text, wav_path=wav_path))
    return specs


def build_from_path(
    in_dir: str,
    out_dir: str,
    num_workers: int = 8,
    cfg: AudioConfig | None = None,
    skip_errors: bool = False,
    tqdm=lambda x, **kw: x,
    device=None,
    device_batch: int = 16,
    **_legacy_kwargs,
) -> List[ManifestEntry]:
    """Reference surface: build_from_path(in_dir, out_dir, num_workers,
    ..., tqdm) (src/ljspeech.py:15). Extra legacy kwargs
    (sample_rate/fft_size/hop_size/n_mels) are accepted via ``cfg``."""
    cfg = cfg or _cfg_from_legacy(_legacy_kwargs)
    specs = collect(in_dir)
    return preprocess_utterances(
        specs, out_dir, cfg, name="ljspeech", num_workers=num_workers,
        device_batch=device_batch, skip_errors=skip_errors, tqdm=tqdm, device=device,
    )


def _cfg_from_legacy(kw) -> AudioConfig:
    mapping = {
        "sample_rate": "sample_rate",
        "fft_size": "fft_size",
        "hop_size": "hop_size",
        "n_mels": "num_mels",
    }
    fields = {mapping[k]: v for k, v in kw.items() if k in mapping}
    return AudioConfig(**fields)

"""CMU Arctic corpus adapter (src/cmu_arctic.py).

Layout: ``<in_dir>/cmu_us_<spk>_arctic/wav/arctic_*.wav`` for the seven
speakers (awb, bdl, clb, jmk, ksp, rms, slt); speaker ids are assigned in
that order (0-6), matching the reference's 7-speaker setup
(src/cmu_arctic.py:22-31, hparams.py:84). Leading/trailing silence is
energy-trimmed (the reference trims with librosa/hts alignments,
src/cmu_arctic.py:61-72). A copy of
``neural_sound_generation_tpu/data/corpora/cmu_arctic.py`` on the port's
engine.
"""

from __future__ import annotations

import glob
import os
from typing import List

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.data.corpora.engine import (
    UtteranceSpec,
    convention,
    preprocess_utterances,
)
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry
from neural_sound_generation_tpu_torch.ops import dsp

SPEAKERS = ["awb", "bdl", "clb", "jmk", "ksp", "rms", "slt"]


def collect(in_dir: str, cfg: AudioConfig) -> List[UtteranceSpec]:
    specs: List[UtteranceSpec] = []
    trim = (lambda w: dsp.trim_silence(w, cfg)) if cfg.trim_silence else None
    for sid, spk in enumerate(SPEAKERS):
        spk_dir = os.path.join(in_dir, f"cmu_us_{spk}_arctic")
        if not os.path.isdir(spk_dir):
            continue
        for wav_path in sorted(glob.glob(os.path.join(spk_dir, "wav", "*.wav"))):
            utt = os.path.splitext(os.path.basename(wav_path))[0]
            specs.append(
                UtteranceSpec(
                    utt_id=f"{spk}_{utt}",
                    text=utt,
                    wav_path=wav_path,
                    speaker_id=sid,
                    trim_fn=trim,
                )
            )
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
    cfg = convention(cfg or AudioConfig(sample_rate=16000))
    specs = collect(in_dir, cfg)
    return preprocess_utterances(
        specs, out_dir, cfg, name="cmu_arctic", num_workers=num_workers,
        device_batch=device_batch, skip_errors=skip_errors, tqdm=tqdm, device=device,
    )

"""ASR-style log-spectrogram dataset.

Counterpart of ``neural_sound_generation_tpu/utils/spectrogram_dataset.py``:
the ``SpectrogramParser`` / ``SpectrogramDataset`` capability of the
reference (src/util.py:199-292). A manifest of ``wav_path,transcript_path``
lines, each utterance's windowed STFT magnitude -> log1p -> optional
per-utterance mean/std normalization, the transcript mapped through a
label alphabet. The STFT is the port's ``ops.dsp.stft`` on ``device``: the
CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.ops import dsp


class SpectrogramParser:
    def __init__(
        self,
        sample_rate: int = 16000,
        window_size_s: float = 0.02,
        window_stride_s: float = 0.01,
        normalize: bool = True,
        device: Optional[str | torch.device] = None,
    ):
        self.sample_rate = sample_rate
        self.n_fft = int(sample_rate * window_size_s)
        self.hop = int(sample_rate * window_stride_s)
        self.normalize = normalize
        self.device = resolve_device(device)

    def parse_audio(self, path: str) -> np.ndarray:
        """wav -> (n_freq, frames) float32 log1p spectrogram."""
        wav = dsp.load_wav(path, self.sample_rate)
        spec = dsp.stft(torch.from_numpy(wav).to(self.device), self.n_fft, self.hop)
        spect = np.log1p(spec.abs().cpu().numpy()).T.astype(np.float32)
        if self.normalize:
            mean, std = spect.mean(), spect.std()
            spect = (spect - mean) / max(std, 1e-5)
        return spect


class SpectrogramDataset(SpectrogramParser):
    """Manifest rows: ``/path/audio.wav,/path/transcript.txt``."""

    def __init__(self, manifest_filepath: str, labels: str, **kwargs):
        super().__init__(**kwargs)
        with open(manifest_filepath, "r", encoding="utf-8") as f:
            self.ids: List[Tuple[str, str]] = [
                tuple(line.strip().split(",")[:2]) for line in f if line.strip()
            ]
        self.labels_map: Dict[str, int] = {c: i for i, c in enumerate(labels)}

    def __len__(self) -> int:
        return len(self.ids)

    def parse_transcript(self, path: str) -> List[int]:
        with open(path, "r", encoding="utf-8") as f:
            transcript = f.read().replace("\n", "")
        return [self.labels_map[c] for c in transcript if c in self.labels_map]

    def __getitem__(self, index: int):
        audio_path, transcript_path = self.ids[index]
        return self.parse_audio(audio_path), self.parse_transcript(transcript_path)

"""train.txt manifest read/write.

Format compatibility surface (dataloader.py:97-142, preprocess.py:32-45):
``|``-separated lines ``audio_npy|mel_npy|timesteps|text[|speaker_id]``;
4 columns single-speaker, 5 multi-speaker.

A copy of ``neural_sound_generation_tpu/data/manifest.py`` (no JAX in it), kept
in the port so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class ManifestEntry:
    audio_path: str
    mel_path: str
    timesteps: int
    text: str
    speaker_id: Optional[int] = None

    def to_line(self) -> str:
        cols = [self.audio_path, self.mel_path, str(self.timesteps), self.text]
        if self.speaker_id is not None:
            cols.append(str(self.speaker_id))
        return "|".join(cols)


def write_manifest(out_dir: str, entries: Sequence[ManifestEntry]) -> str:
    path = os.path.join(out_dir, "train.txt")
    with open(path, "w", encoding="utf-8") as f:
        for e in entries:
            f.write(e.to_line() + "\n")
    return path


def read_manifest(data_root: str) -> List[ManifestEntry]:
    path = os.path.join(data_root, "train.txt")
    entries: List[ManifestEntry] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            cols = line.split("|")
            if len(cols) not in (4, 5):
                raise ValueError(
                    f"manifest line must have 4 or 5 columns, got {len(cols)}: "
                    f"{line[:80]!r}"
                )
            entries.append(
                ManifestEntry(
                    audio_path=cols[0],
                    mel_path=cols[1],
                    timesteps=int(cols[2]),
                    text=cols[3],
                    speaker_id=int(cols[4]) if len(cols) == 5 else None,
                )
            )
    return entries


def manifest_stats(entries: Sequence[ManifestEntry], sample_rate: int, hop_size: int):
    """Hours/frames summary (preprocess.py:36-45 behavior)."""
    frames = sum(e.timesteps for e in entries)
    sr = sample_rate
    hours = frames / sr / 3600
    return {
        "utterances": len(entries),
        "total_timesteps": frames,
        "hours": hours,
        "mel_frames": frames // hop_size,
    }

"""Manifest-backed data sources with a deterministic train/test split.

Counterpart of ``neural_sound_generation_tpu/data/sources.py``: read
train.txt, filter by speaker, split train/test, lazy per-utterance ``.npy``
loads. The JAX package splits with sklearn's ``train_test_split``; the port
computes the same split with numpy (``train_test_indices``), since scikit-learn
is not a dependency of the port.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional

import numpy as np

from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, read_manifest


def train_test_indices(
    n: int, test_size: float | int, random_state: int
) -> tuple[np.ndarray, np.ndarray]:
    """The (train, test) split of ``np.arange(n)`` that
    ``sklearn.model_selection.train_test_split(np.arange(n),
    test_size=test_size, random_state=random_state)`` returns: a float
    test size takes ceil(test_size * n) items, an int that many; both parts
    are cut from ``RandomState(random_state).permutation(n)``, test first
    (sklearn's ``ShuffleSplit``)."""
    if isinstance(test_size, (int, np.integer)) and not isinstance(test_size, bool):
        if not 0 < test_size < n:
            raise ValueError(f"test_size={test_size} should be in (0, {n}) for {n} samples")
        n_test = int(test_size)
    else:
        if not 0.0 < float(test_size) < 1.0:
            raise ValueError(f"test_size={test_size} should be in the (0, 1) range")
        n_test = math.ceil(float(test_size) * n)
    n_train = n - n_test
    if n_train <= 0:
        raise ValueError(
            f"With n_samples={n} and test_size={test_size}, the train set is empty"
        )
    permutation = np.random.RandomState(random_state).permutation(n)
    return permutation[n_test : n_test + n_train], permutation[:n_test]


class NpyDataSource:
    """col: 0 = raw audio paths, 1 = mel paths (RawAudioDataSource /
    MelSpecDataSource, dataloader.py:148-156)."""

    def __init__(
        self,
        data_root: str,
        col: int,
        speaker_id: Optional[int] = None,
        train: bool = True,
        test_size: Optional[float] = 0.05,
        test_num_samples: Optional[int] = None,
        random_state: int = 1234,
    ):
        self.data_root = data_root
        self.col = col
        self.speaker_id = speaker_id
        self.train = train
        self.test_size = test_size
        self.test_num_samples = test_num_samples
        self.random_state = random_state

        entries = read_manifest(data_root)
        self.multi_speaker = entries[0].speaker_id is not None if entries else False

        if self.multi_speaker and speaker_id is not None:
            entries = [e for e in entries if e.speaker_id == speaker_id]
            self.multi_speaker = False

        idx = self._interest_indices(len(entries))
        entries = [entries[i] for i in idx]

        self.entries: List[ManifestEntry] = entries
        self.lengths = [e.timesteps for e in entries]
        self.speaker_ids = (
            [e.speaker_id for e in entries] if self.multi_speaker else None
        )

    def _interest_indices(self, n: int) -> np.ndarray:
        if self.test_size is None:
            test_size = self.test_num_samples / n
        else:
            test_size = self.test_size
        train_idx, test_idx = train_test_indices(n, test_size, self.random_state)
        return train_idx if self.train else test_idx

    def path(self, i: int) -> str:
        entry = self.entries[i]
        rel = entry.audio_path if self.col == 0 else entry.mel_path
        return os.path.join(self.data_root, rel)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> np.ndarray:
        return np.load(self.path(i))

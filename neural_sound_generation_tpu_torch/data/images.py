"""Local MNIST / CIFAR-10 readers (no torchvision, no network).

A copy of ``neural_sound_generation_tpu/data/images.py`` (numpy only), so the
port imports nothing of the JAX package.

The reference's image path (``--dataset MNIST|CIFAR10``) uses torchvision
datasets (dataloader.py:43-59, via ``eval('datasets.'+name)`` — SURVEY §8
flags the eval). Here the standard on-disk binary formats are parsed
directly from ``datadir``:
  * MNIST: ``train-images-idx3-ubyte`` / ``train-labels-idx1-ubyte`` (+
    ``t10k-*``), raw or ``.gz``, under ``<datadir>/MNIST/raw`` or flat.
  * CIFAR-10: ``cifar-10-batches-py/data_batch_{1..5}`` pickle batches.
"""

from __future__ import annotations

import glob
import gzip
import os
import pickle
from typing import Iterator, Tuple

import numpy as np


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def _find(datadir: str, filename: str) -> str:
    for cand in (
        os.path.join(datadir, filename),
        os.path.join(datadir, "MNIST", "raw", filename),
        os.path.join(datadir, "mnist", filename),
    ):
        if os.path.exists(cand) or os.path.exists(cand + ".gz"):
            return cand
    raise FileNotFoundError(f"{filename}[.gz] not found under {datadir}")


def load_mnist(datadir: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N, 28, 28, 1) float32 in [0,1], labels (N,) int32)."""
    prefix = "train" if train else "t10k"
    with _open_maybe_gz(_find(datadir, f"{prefix}-images-idx3-ubyte")) as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    assert magic == 2051, f"bad MNIST image magic {magic}"
    n = int.from_bytes(data[4:8], "big")
    images = np.frombuffer(data, np.uint8, offset=16).reshape(n, 28, 28, 1)
    with _open_maybe_gz(_find(datadir, f"{prefix}-labels-idx1-ubyte")) as f:
        data = f.read()
    assert int.from_bytes(data[0:4], "big") == 2049
    labels = np.frombuffer(data, np.uint8, offset=8).astype(np.int32)
    return images.astype(np.float32) / 255.0, labels


def load_cifar10(datadir: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (images (N, 32, 32, 3) float32 in [0,1], labels (N,) int32)."""
    base = os.path.join(datadir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = datadir
    files = (
        sorted(glob.glob(os.path.join(base, "data_batch_*")))
        if train
        else [os.path.join(base, "test_batch")]
    )
    if not files:
        raise FileNotFoundError(f"no CIFAR-10 batches under {base}")
    xs, ys = [], []
    for path in files:
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8))
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0, np.asarray(ys, np.int32)


def image_batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    seed: int = 0,
    shuffle: bool = True,
) -> Iterator[dict]:
    """Model-batch iterator over an image set; tanh-output models expect
    inputs in [-1, 1]."""
    n = len(images)
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    for s in range(0, n - batch_size + 1, batch_size):
        idx = order[s : s + batch_size]
        yield {"x": images[idx] * 2.0 - 1.0, "label": labels[idx]}

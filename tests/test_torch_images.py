"""The port's copy of the MNIST / CIFAR-10 readers (data/images.py) held
against the JAX package's on synthetic files written as ``tests/test_cli.py``
writes them: idx files raw or gzipped, flat or under ``MNIST/raw``, CIFAR-10
pickle batches; the batch iterator's order and scaling; and the image paths
of ``cli.main`` and ``cli.evaluate`` (the flat VQ-VAE and the VAE on MNIST
and CIFAR-10)."""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu.data import images as jimages
from neural_sound_generation_tpu_torch.cli import evaluate, main
from neural_sound_generation_tpu_torch.data import images
from neural_sound_generation_tpu_torch.training import checkpoint

torch.set_num_threads(1)


def _make_mnist(root, n=32, gz=True, nested=True):
    raw = os.path.join(root, "MNIST", "raw") if nested else root
    os.makedirs(raw, exist_ok=True)
    rng = np.random.default_rng(0)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    for prefix, count in (("train", n), ("t10k", n // 2)):
        imgs = rng.integers(0, 256, (count, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, count, dtype=np.uint8)
        with opener(os.path.join(raw, f"{prefix}-images-idx3-ubyte{suffix}"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, count, 28, 28) + imgs.tobytes())
        with opener(os.path.join(raw, f"{prefix}-labels-idx1-ubyte{suffix}"), "wb") as f:
            f.write(struct.pack(">II", 2049, count) + labels.tobytes())
    return root


def _make_cifar(root, n=12, batches=2):
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.default_rng(1)
    names = [f"data_batch_{i + 1}" for i in range(batches)] + ["test_batch"]
    for name in names:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)
    return root


@pytest.mark.parametrize("gz,nested", [(True, True), (False, False)])
def test_mnist_reader_matches_jax(tmp_path, gz, nested):
    root = _make_mnist(str(tmp_path), gz=gz, nested=nested)
    for train in (True, False):
        x, y = images.load_mnist(root, train=train)
        jx, jy = jimages.load_mnist(root, train=train)
        assert x.shape == ((32 if train else 16), 28, 28, 1) and x.dtype == np.float32
        assert 0.0 <= x.min() and x.max() <= 1.0 and y.dtype == np.int32
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)


def test_cifar_reader_matches_jax(tmp_path):
    root = _make_cifar(str(tmp_path))
    for train, n in ((True, 24), (False, 12)):
        x, y = images.load_cifar10(root, train=train)
        jx, jy = jimages.load_cifar10(root, train=train)
        assert x.shape == (n, 32, 32, 3) and y.shape == (n,)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    # the channel-major pickle rows become NHWC
    with open(os.path.join(root, "cifar-10-batches-py", "test_batch"), "rb") as f:
        raw = pickle.load(f, encoding="bytes")[b"data"][0]
    np.testing.assert_array_equal(images.load_cifar10(root, train=False)[0][0, 0, 1],
                                  raw[[1, 1024 + 1, 2048 + 1]] / np.float32(255.0))


def test_readers_refuse_missing_files(tmp_path):
    with pytest.raises(FileNotFoundError):
        images.load_mnist(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        images.load_cifar10(str(tmp_path))


@pytest.mark.parametrize("shuffle,seed", [(True, 3), (False, 0)])
def test_image_batches_match_jax(shuffle, seed):
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (22, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 22).astype(np.int32)
    got = list(images.image_batches(x, y, 5, seed=seed, shuffle=shuffle))
    want = list(jimages.image_batches(x, y, 5, seed=seed, shuffle=shuffle))
    assert len(got) == len(want) == 4  # the partial batch is dropped
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"], w["x"])
        np.testing.assert_array_equal(g["label"], w["label"])
        assert -1.0 <= g["x"].min() and g["x"].max() <= 1.0


def test_the_copy_imports_nothing_of_jax():
    import ast

    tree = ast.parse(open(images.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {m for m in names if m and m.split(".")[0] in ("jax", "flax",
                                                               "neural_sound_generation_tpu")}


def _cli(tmp_path, model, dataset, datadir, *extra):
    return ["--model", model, "--dataset", dataset, "--datadir", datadir, "--dim", "8",
            "--z-dim", "16", "--batch-size", "8", "--log-interval", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "models"), "--sampledir", str(tmp_path / "results"),
            *extra]


def test_cli_trains_and_evaluates_the_vqvae_on_mnist(tmp_path):
    """The parser's default dataset on the flat VQ-VAE: 28 x 28 images, a
    7 x 7 code grid, data-seeded codebook; the reconstruction artifact is
    the .npy alone (no audio for images)."""
    root = _make_mnist(str(tmp_path / "data"))
    main.main(_cli(tmp_path, "vqvae", "MNIST", root, "--epochs", "1", "--codebook-init", "data"))
    ckpt = os.path.join(tmp_path, "models", "vqvae", "checkpoint_MNIST_8_16")
    assert checkpoint.latest_step(ckpt) == 4
    results = os.listdir(tmp_path / "results" / "MNIST")
    assert "reconstruction_vqvae_data_MNIST_dim_8_z_dim_16_epoch_1.npy" in results
    assert not [r for r in results if r.endswith(".wav")]
    means = evaluate.main(["--model", "vqvae", "--dataset", "MNIST", "--datadir", root,
                           "--ckpt-dir", ckpt, "--dim", "8", "--z-dim", "16",
                           "--device", "cpu"])
    assert {"loss", "perplexity"} <= set(means) and np.isfinite(means["loss"])


def test_cli_trains_the_vqvae_on_cifar10_with_three_channels(tmp_path):
    root = _make_cifar(str(tmp_path / "data"), n=16)
    main.main(_cli(tmp_path, "vqvae", "CIFAR10", root, "--epochs", "1"))
    ckpt = os.path.join(tmp_path, "models", "vqvae", "checkpoint_CIFAR10_8_16")
    state = torch.load(os.path.join(ckpt, "step_4", "state.pt"), weights_only=True)
    assert tuple(state["params/encoder.Conv_0.weight"].shape) == (8, 3, 4, 4)
    recon = np.load(tmp_path / "results" / "CIFAR10" /
                    "reconstruction_vqvae_data_CIFAR10_dim_8_z_dim_16_epoch_1.npy")
    assert recon.shape == (8, 32, 32)  # channel 0 kept, as the JAX CLI does

"""The port's data path (split, sources, sampler, collate, loader) held
against the JAX package on the CPU. The port splits without scikit-learn;
its split must equal sklearn's ``train_test_split``, which the JAX package
calls (sklearn is installed here, the port does not import it). Batches are
compared exactly: the same seed and epoch give the same arrays."""

import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split

from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.data import pipeline as jpipe
from neural_sound_generation_tpu.data.manifest import ManifestEntry, write_manifest
from neural_sound_generation_tpu.data.sources import NpyDataSource as JaxSource
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.data import pipeline, sources

torch.set_num_threads(1)

HOP, N_MELS = 256, 80


@pytest.mark.parametrize("n,test_size", [
    (2, 0.5), (7, 0.3), (40, 0.0441), (100, 0.05), (101, 0.2), (999, 0.0441),
    (13, 3), (500, 1),
])
@pytest.mark.parametrize("seed", [0, 1234])
def test_numpy_split_equals_sklearn(n, test_size, seed):
    want_train, want_test = train_test_split(np.arange(n), test_size=test_size,
                                             random_state=seed)
    got_train, got_test = sources.train_test_indices(n, test_size, seed)
    np.testing.assert_array_equal(got_train, want_train)
    np.testing.assert_array_equal(got_test, want_test)


@pytest.mark.parametrize("n,test_size", [(10, 0.0), (10, 1.0), (10, 10), (1, 0.5)])
def test_numpy_split_refuses_what_sklearn_refuses(n, test_size):
    with pytest.raises(ValueError):
        train_test_split(np.arange(n), test_size=test_size, random_state=0)
    with pytest.raises(ValueError):
        sources.train_test_indices(n, test_size, 0)


def _corpus(root, n=40, speakers=False):
    """Chirp-like audio and random mels of 20-60 frames (some shorter than
    the 28-frame crop, so both the crop and the pad branch run)."""
    rng = np.random.default_rng(0)
    entries = []
    for i in range(n):
        frames = int(rng.integers(20, 60))
        audio = np.sin(np.cumsum(rng.uniform(0.01, 0.2, frames * HOP))).astype(np.float32)
        mel = rng.uniform(0, 1, (frames, N_MELS)).astype(np.float32)
        np.save(root / f"a{i}.npy", audio)
        np.save(root / f"m{i}.npy", mel)
        entries.append(ManifestEntry(f"a{i}.npy", f"m{i}.npy", len(audio), "t",
                                     i % 3 if speakers else None))
    write_manifest(str(root), entries)
    return root


def _pairs(root, train, **kw):
    args = dict(test_size=0.1, random_state=1234)
    jx = JaxSource(str(root), 0, train=train, **args)
    jm = JaxSource(str(root), 1, train=train, **args)
    tx = sources.NpyDataSource(str(root), 0, train=train, **args)
    tm = sources.NpyDataSource(str(root), 1, train=train, **args)
    assert [e.audio_path for e in tx.entries] == [e.audio_path for e in jx.entries]
    jl = jpipe.MelFrameLoader(jpipe.AudioDataset(jx, jm), JaxConfig(), 4, seed=1234,
                              shuffle=train, drop_last=train, use_native=False, **kw)
    tl = pipeline.MelFrameLoader(pipeline.AudioDataset(tx, tm), Config(), 4, seed=1234,
                                 shuffle=train, drop_last=train, **kw)
    return jl, tl


def _assert_same_pass(jl, tl):
    jb, tb = list(jl), list(tl)
    assert len(jb) == len(tb) == len(tl) > 0
    for a, b in zip(jb, tb):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    return tb


@pytest.mark.parametrize("speakers", [False, True])
def test_loader_batches_equal_the_jax_python_loader(tmp_path, speakers):
    root = _corpus(tmp_path, speakers=speakers)
    jl, tl = _pairs(root, train=True)
    first = _assert_same_pass(jl, tl)        # epoch 0
    second = _assert_same_pass(jl, tl)       # epoch 1: another order and crops
    assert any(not np.array_equal(a["x"], b["x"]) for a, b in zip(first, second))
    assert first[0]["x"].shape == (4, N_MELS, 28, 1)
    assert ("g" in first[0]) == speakers
    jl.set_epoch(0)
    tl.set_epoch(0)
    replay = _assert_same_pass(jl, tl)       # a resumed epoch replays its order
    for a, b in zip(first, replay):
        np.testing.assert_array_equal(a["x"], b["x"])
    # the test split: no shuffle, the last partial batch padded cyclically
    _assert_same_pass(*_pairs(root, train=False))


def test_get_audio_data_loaders_split_and_shapes(tmp_path):
    root = _corpus(tmp_path)
    loaders = pipeline.get_audio_data_loaders(str(root), None, 4, Config())
    n_test = int(np.ceil(Config().data.test_size * 40))
    assert len(loaders["train"].dataset) == 40 - n_test
    assert len(loaders["test"].dataset) == n_test
    batch = next(iter(loaders["train"]))
    assert batch["x"].shape == (4, N_MELS, 28, 1) and batch["x"].dtype == np.float32


def test_device_prefetch_keeps_order_and_values():
    batches = [{"x": np.full((2, 3), i, np.float32), "g": None} for i in range(5)]
    out = list(pipeline.device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor) and b["g"] is None
        assert torch.equal(b["x"], torch.full((2, 3), float(i)))
    assert list(pipeline.device_prefetch(iter([]), device="cpu")) == []


def test_loader_surfaces_a_data_error(tmp_path):
    root = _corpus(tmp_path)
    (root / "m3.npy").write_bytes(b"not an array")
    _, tl = _pairs(root, train=True)
    with pytest.raises(Exception):
        list(tl)

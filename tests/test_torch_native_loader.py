"""The port's native data loader (``data.native_loader``, built from
``data/native/loader.cpp`` with the ``g++`` on ``PATH``) against the port's
Python collate and the JAX package's native loader.

Every case of ``tests/test_native_loader.py`` runs through three paths on
the same shards, indices and seeded RNG: the port's ``NativeCorpus``, the
port's ``collate_mel_batch`` and JAX's ``NativeCorpus``; and the loaders
(``MelFrameLoader``) in every ``batch_mode`` through the port's native
path, its Python path and JAX's native path. Tolerance: none, the batches
are bit-equal (the same bytes are copied; the pad values come from one
formula). The refusals of JAX's tests hold: a truncated shard and an
overrunning header fail the open with ``OSError`` (no SIGBUS), a 3-D shard
is rejected, and bad frame counts are rejected through the C ABI (the
motion runtime's ``record_csv``). The path is decided once: a failed
build raises and never falls back to the Python collate.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.data import native_loader as jax_native
from neural_sound_generation_tpu.data import pipeline as jax_pipeline
from neural_sound_generation_tpu.data import sources as jax_sources
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.data import native_loader, pipeline
from neural_sound_generation_tpu_torch.data.collate import collate_mel_batch
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, write_manifest
from neural_sound_generation_tpu_torch.data.sources import NpyDataSource

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not native_loader.native_available(),
                                reason="no g++ on PATH for the native loader")

HOP = 64
N_MELS = 20


def _write_corpus(tmp_path, n=6, mulaw_q=None, seed=0):
    """Shards shaped like preprocessing's output (JAX's test's): varied
    lengths, so both the crop and the pad branch run."""
    rng = np.random.default_rng(seed)
    audio_paths, mel_paths, audio_arrays, mel_arrays = [], [], [], []
    for i in range(n):
        frames = int(rng.integers(4, 40))
        samples = frames * HOP + int(rng.integers(0, HOP))
        if mulaw_q is None:
            audio = rng.standard_normal(samples).astype(np.float32) * 0.3
        else:
            dtype = np.int16 if mulaw_q <= 32768 else np.int32
            audio = rng.integers(0, mulaw_q, samples).astype(dtype)
        mel = rng.standard_normal((frames, N_MELS)).astype(np.float32)
        ap = os.path.join(tmp_path, f"audio-{i:05d}.npy")
        mp = os.path.join(tmp_path, f"mel-{i:05d}.npy")
        np.save(ap, audio)
        np.save(mp, mel)
        audio_paths.append(ap)
        mel_paths.append(mp)
        audio_arrays.append(audio)
        mel_arrays.append(mel)
    return audio_paths, mel_paths, audio_arrays, mel_arrays


def _cfgs(**over):
    over = {"hop_size": HOP, "num_mels": N_MELS, **over}
    return Config().parse_json(over), JaxConfig().parse_json(over)


def _assert_same(got: dict, want: dict, dtypes: bool = True):
    assert set(got) == set(want)
    for k in got:
        if want[k] is None:
            assert got[k] is None, k
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        np.testing.assert_array_equal(a, b, err_msg=k)
        if dtypes:
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)


def test_corpus_meta(tmp_path):
    ap, mp, audio, mel = _write_corpus(tmp_path)
    corpus = native_loader.NativeCorpus(ap, mp)
    jax_corpus = jax_native.NativeCorpus(ap, mp)
    assert len(corpus) == len(ap)
    for i in range(len(ap)):
        assert corpus.audio_len[i] == len(audio[i])
        assert corpus.mel_frames[i] == mel[i].shape[0]
        assert corpus.mel_bins[i] == N_MELS
    for name in ("audio_len", "mel_frames", "mel_bins"):
        np.testing.assert_array_equal(getattr(corpus, name), getattr(jax_corpus, name))
    corpus.close()
    jax_corpus.close()


#: name -> (corpus kwargs, config overrides, indices, max_time_steps,
#: seed, collate kwargs)
COLLATE_CASES = {
    "raw": ({}, {"input_type": "raw"}, [0, 3, 5, 1], 16 * HOP, 42, {}),
    "mulaw_quantize_256": ({"mulaw_q": 256},
                           {"input_type": "mulaw-quantize", "quantize_channels": 256},
                           [2, 4, 0], 12 * HOP, 7, {}),
    "mulaw_quantize_65536": ({"mulaw_q": 65536},
                             {"input_type": "mulaw-quantize", "quantize_channels": 65536},
                             [2, 4, 0], 12 * HOP, 7, {}),
    "bucket_frames": ({}, {}, [1, 2], 64 * HOP, 3, {"frames_out": 8}),
    "speakers": ({"n": 4}, {}, [0, 1], 8 * HOP, 0, {"speaker_ids": [3, 5]}),
    "need_audio_false": ({"n": 3}, {}, [0, 2], 8 * HOP, 0, {"need_audio": False}),
}


@pytest.mark.parametrize("case", COLLATE_CASES)
def test_collate_is_bit_equal_across_the_three_paths(tmp_path, case):
    corpus_kw, over, indices, max_steps, seed, kw = COLLATE_CASES[case]
    ap, mp, audio, mel = _write_corpus(tmp_path, **corpus_kw)
    cfg, jax_cfg = _cfgs(**over)
    corpus = native_loader.NativeCorpus(ap, mp)
    jax_corpus = jax_native.NativeCorpus(ap, mp)
    got = corpus.collate(indices, cfg.audio, max_steps, np.random.default_rng(seed), **kw)
    jax_got = jax_corpus.collate(indices, jax_cfg.audio, max_steps,
                                 np.random.default_rng(seed), **kw)
    _assert_same(got, jax_got)
    gs = kw.get("speaker_ids") or [None] * len(indices)
    items = [(audio[i], mel[i], g) for i, g in zip(indices, gs)]
    ref = collate_mel_batch(items, cfg.audio, max_steps, np.random.default_rng(seed),
                            frames_out=kw.get("frames_out"), one_hot=False)
    if not kw.get("need_audio", True):
        assert "x" not in got and "y" not in got
        assert got["c"].shape[1] == N_MELS
        ref = {k: v for k, v in ref.items() if k not in ("x", "y")}
    # the Python collate's lengths are its own integer type: values held
    _assert_same({k: v for k, v in got.items() if k != "input_lengths"},
                 {k: v for k, v in ref.items() if k != "input_lengths"})
    np.testing.assert_array_equal(got["input_lengths"], ref["input_lengths"])
    if case == "speakers":
        np.testing.assert_array_equal(got["g"], np.asarray([3, 5], np.int32))
    corpus.close()
    jax_corpus.close()


def _manifest(tmp_path, ap, mp, speakers: bool):
    entries = [ManifestEntry(os.path.basename(a), os.path.basename(m),
                             int(np.load(a).shape[0]), "t",
                             speaker_id=i % 3 if speakers else None)
               for i, (a, m) in enumerate(zip(ap, mp))]
    write_manifest(str(tmp_path), entries)


#: name -> (multi-speaker, bucket boundaries, max_time_steps frames, seed)
LOADER_CASES = {"plain": (False, None, 8, 99), "speakers_and_buckets": (True, (8, 16), 16, 5)}


@pytest.mark.parametrize("batch_mode", ["mel", "wave", "raw"])
@pytest.mark.parametrize("case", LOADER_CASES)
def test_loader_epochs_are_bit_equal_across_the_three_paths(tmp_path, case, batch_mode):
    """MelFrameLoader's epoch through the port's native path, its Python
    path and JAX's native path, batch for batch."""
    speakers, buckets, frames, seed = LOADER_CASES[case]
    ap, mp, _, _ = _write_corpus(tmp_path, n=8)
    _manifest(tmp_path, ap, mp, speakers)
    cfg, jax_cfg = _cfgs(max_time_steps=frames * HOP)
    if buckets:
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, bucket_boundaries=buckets))
        jax_cfg = dataclasses.replace(jax_cfg, data=dataclasses.replace(
            jax_cfg.data, bucket_boundaries=buckets))

    def port_loader(use_native):
        ds = pipeline.AudioDataset(NpyDataSource(str(tmp_path), 0, test_size=0.125),
                                   NpyDataSource(str(tmp_path), 1, test_size=0.125))
        return pipeline.MelFrameLoader(ds, cfg, batch_size=2, seed=seed, use_native=use_native,
                                       num_workers=1, batch_mode=batch_mode)

    ds = jax_pipeline.AudioDataset(jax_sources.NpyDataSource(str(tmp_path), 0, test_size=0.125),
                                   jax_sources.NpyDataSource(str(tmp_path), 1, test_size=0.125))
    jax_loader = jax_pipeline.MelFrameLoader(ds, jax_cfg, batch_size=2, seed=seed,
                                             use_native=True, num_workers=1,
                                             batch_mode=batch_mode)
    native, python = port_loader(True), port_loader(False)
    assert native.use_native and not python.use_native
    assert jax_loader._native is not None
    nb, pb, jb = list(native), list(python), list(jax_loader)
    assert native.native is not None and python.native is None
    assert len(nb) == len(pb) == len(jb) > 0
    saw_g = False
    for a, b, c in zip(nb, pb, jb):
        _assert_same(a, c)
        _assert_same({k: v for k, v in a.items() if k != "input_lengths"},
                     {k: v for k, v in b.items() if k != "input_lengths"})
        if "input_lengths" in a:
            np.testing.assert_array_equal(a["input_lengths"], b["input_lengths"])
        saw_g |= a.get("g") is not None
    assert saw_g == speakers


def test_the_default_decides_once_from_gxx(tmp_path, monkeypatch):
    """use_native=None is native where g++ is on PATH and the corpus pairs
    mel shards, the Python path where g++ is missing."""
    ap, mp, _, _ = _write_corpus(tmp_path, n=8)
    _manifest(tmp_path, ap, mp, False)
    cfg, _ = _cfgs(max_time_steps=8 * HOP)

    def loader(with_mel=True):
        ds = pipeline.AudioDataset(
            NpyDataSource(str(tmp_path), 0, test_size=0.125),
            NpyDataSource(str(tmp_path), 1, test_size=0.125) if with_mel else None)
        return pipeline.MelFrameLoader(ds, cfg, batch_size=2, num_workers=1)

    assert loader().use_native
    assert not loader(with_mel=False).use_native
    monkeypatch.setattr(native_loader.shutil, "which", lambda name: None)
    assert not loader().use_native
    loaders = pipeline.get_audio_data_loaders(str(tmp_path), None, 2, cfg)
    assert not any(ld.use_native for ld in loaders.values())


def test_a_bad_shard_fails_the_pass(tmp_path):
    """The corpus is mapped at the first pass: a shard the runtime cannot
    map fails that pass with OSError, as a bad shard fails the Python
    path's pass."""
    ap, mp, _, _ = _write_corpus(tmp_path, n=8)
    _manifest(tmp_path, ap, mp, False)
    with open(mp[3], "wb") as f:
        f.write(b"not an array")
    cfg, _ = _cfgs(max_time_steps=8 * HOP)
    ds = pipeline.AudioDataset(NpyDataSource(str(tmp_path), 0, test_size=0.125),
                               NpyDataSource(str(tmp_path), 1, test_size=0.125))
    loader = pipeline.MelFrameLoader(ds, cfg, batch_size=2, num_workers=1, use_native=True)
    with pytest.raises(OSError):
        list(loader)


@pytest.mark.parametrize("use_native", [None, True])
def test_a_failed_build_raises_and_never_falls_back(tmp_path, monkeypatch, use_native):
    ap, mp, _, _ = _write_corpus(tmp_path, n=8)
    _manifest(tmp_path, ap, mp, False)
    cfg, _ = _cfgs(max_time_steps=8 * HOP)
    broken = tmp_path / "loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "NATIVE_SOURCE", broken)
    monkeypatch.setattr(native_loader.native_build, "BUILD_DIR", tmp_path / "build")
    ds = pipeline.AudioDataset(NpyDataSource(str(tmp_path), 0, test_size=0.125),
                               NpyDataSource(str(tmp_path), 1, test_size=0.125))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pipeline.MelFrameLoader(ds, cfg, batch_size=2, num_workers=1, use_native=use_native)


def test_truncated_shard_errors_not_sigbus(tmp_path):
    """A shard truncated inside its header, or a header length past the
    file's end, fails the open with OSError, never a SIGBUS in C++."""
    ap, mp, _, _ = _write_corpus(tmp_path, n=2)
    with open(ap[1], "r+b") as f:
        f.truncate(9)
    with pytest.raises(OSError):
        native_loader.NativeCorpus(ap, mp)
    bogus = os.path.join(str(tmp_path), "bogus.npy")
    with open(bogus, "wb") as f:
        f.write(b"\x93NUMPY" + bytes([1, 0]) + (0xFFFF).to_bytes(2, "little"))
        f.write(b"x" * 64)
    with pytest.raises(OSError):
        native_loader.NativeCorpus([bogus], [mp[0]])


def test_3d_shard_rejected_not_truncated(tmp_path):
    """A (N, T, C) shard is rejected, not read as its first two axes."""
    ap, mp, _, _ = _write_corpus(tmp_path, n=2)
    three_d = os.path.join(str(tmp_path), "stereo.npy")
    np.save(three_d, np.zeros((4, 8, 2), np.float32))
    with pytest.raises(OSError):
        native_loader.NativeCorpus([ap[0], three_d], [mp[0], mp[1]])


def test_record_csv_rejects_bad_frame_counts(tmp_path):
    """Negative or absurd frame counts error through the C ABI (the port's
    motion runtime), and the handle works after the rejected calls."""
    from neural_sound_generation_tpu_torch.motion.capture import scripted_gesture_controller

    ctrl = scripted_gesture_controller(fps=200.0)
    out = os.path.join(str(tmp_path), "x.csv")
    with pytest.raises(IOError):
        ctrl.record_csv(out, -1)
    with pytest.raises(IOError):
        ctrl.record_csv(out, 1 << 40)
    assert ctrl.record_csv(out, 3) == 3

"""The port's ``utils`` against the JAX package's, case by case
(``tests/test_utils.py``'s augment, visualize, profiling and spectrogram
cases).

Tolerances: augmentation and tempo and gain arrays bit-equal to JAX's
(the same numpy and scipy calls); the gain ratio 1e-5 relative; the noise
SNR 5% (a property of one draw, as in JAX's test); the codebook projection
within 1e-6 of JAX's scikit-learn PCA (the port's numpy PCA, the same
component signs); the spectrogram parser and dataset within 1e-5 of the
largest magnitude of JAX's on the CPU. Two float32 FFT libraries (XLA's
and PyTorch's) round a tone's stopband bins, some 1e-4 of the peak, apart
by about 1e-5 absolute, which log1p keeps and the normalization scales by
1 / std.
"""

import os
import time

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu import utils as jax_utils
from neural_sound_generation_tpu.ops import dsp as jax_dsp
from neural_sound_generation_tpu.utils import spectrogram_dataset as jax_spec
from neural_sound_generation_tpu_torch import utils
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.utils import spectrogram_dataset as spec

torch.set_num_threads(1)

SPEC_ATOL = 1e-5
PCA_ATOL = 1e-6


def _tone(n=22050, f=440.0, sr=22050):
    t = np.arange(n) / sr
    return (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)


# ------------------------------------------------------------------ augment


@pytest.mark.parametrize("rate", [1.25, 0.8, 1.0])
def test_change_tempo_length(rate):
    wav = _tone()
    got = utils.change_tempo(wav, rate)
    assert abs(len(got) - len(wav) / rate) < 100
    np.testing.assert_array_equal(got, jax_utils.change_tempo(wav, rate))
    if rate == 1.0:
        assert np.array_equal(got, wav)


def test_change_gain_db():
    wav = _tone()
    louder = utils.change_gain(wav, 6.0)
    np.testing.assert_allclose(np.abs(louder).max() / np.abs(wav).max(), 10 ** (6 / 20),
                               rtol=1e-5)
    np.testing.assert_array_equal(louder, jax_utils.change_gain(wav, 6.0))


def test_augment_deterministic_under_seed():
    wav = _tone()
    a = utils.augment_audio(wav, np.random.default_rng(5))
    b = utils.augment_audio(wav, np.random.default_rng(5))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, jax_utils.augment_audio(wav, np.random.default_rng(5)))


def test_noise_injection_snr():
    wav = _tone()
    noise = np.random.default_rng(0).standard_normal(30000).astype(np.float32) * 0.1
    out = utils.NoiseInjection(noises=[noise], noise_levels=(0.25, 0.25)).inject(
        wav, np.random.default_rng(1))
    assert out.shape == wav.shape
    ratio = np.sum((out - wav) ** 2) / np.sum(wav**2)
    np.testing.assert_allclose(ratio, 0.25, rtol=0.05)
    ref = jax_utils.NoiseInjection(noises=[noise], noise_levels=(0.25, 0.25)).inject(
        wav, np.random.default_rng(1))
    np.testing.assert_array_equal(out, ref)


def test_noise_injection_reads_a_directory_of_wavs(tmp_path):
    """``noise_dir`` goes through the port's ``load_wav``."""
    noise = np.random.default_rng(2).uniform(-0.5, 0.5, 8000).astype(np.float32)
    dsp.save_wav(noise, str(tmp_path / "n.wav"), 22050)
    got = utils.NoiseInjection(noise_dir=str(tmp_path)).noises
    want = jax_utils.NoiseInjection(noise_dir=str(tmp_path)).noises
    assert len(got) == 1
    np.testing.assert_array_equal(got[0], want[0])


def test_noise_injection_requires_sources():
    with pytest.raises(ValueError):
        utils.NoiseInjection(noises=[])


# ---------------------------------------------------------------- visualize


@pytest.mark.parametrize("shape", [(64, 16), (32, 8), (300, 12)])
def test_project_codebook_2d_equals_scikit_learn(shape):
    """(64, 16) and (32, 8) take scikit-learn's full SVD; (300, 12) its
    covariance eigendecomposition."""
    cb = np.random.default_rng(sum(shape)).standard_normal(shape)
    coords = utils.project_codebook_2d(cb)
    assert coords.shape == (shape[0], 2)
    np.testing.assert_allclose(coords, jax_utils.project_codebook_2d(cb), rtol=0,
                               atol=PCA_ATOL)


def test_project_codebook_2d_takes_a_projector():
    cb = np.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(utils.project_codebook_2d(cb, lambda c: c[:, ::-1]),
                                  cb[:, ::-1])


def test_visualize_embedding_writes_png(tmp_path):
    cb = np.random.default_rng(1234).standard_normal((32, 8))
    path = str(tmp_path / "codebook.png")
    coords = utils.visualize_embedding(cb, path)
    assert os.path.exists(path) and os.path.getsize(path) > 0
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_allclose(coords, jax_utils.project_codebook_2d(cb), rtol=0, atol=PCA_ATOL)


def test_visualize_embedding_names_a_missing_matplotlib(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="matplotlib"):
        utils.visualize_embedding(np.eye(4), str(tmp_path / "x.png"))


# ---------------------------------------------------------------- profiling


def test_step_timer():
    timer = utils.StepTimer()
    for _ in range(5):
        with timer.step():
            time.sleep(0.002)
    s = timer.summary()
    jax_timer = jax_utils.StepTimer()
    jax_timer.times = list(timer.times)
    assert s == jax_timer.summary()
    assert set(s) == {"steps", "mean_s", "p50_s", "p90_s", "steps_per_sec"}
    assert s["steps"] == 4  # the first skipped
    assert s["mean_s"] >= 0.002
    assert s["steps_per_sec"] > 0
    assert utils.StepTimer().summary() == {}


def test_trace_context_annotation_only():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with utils.trace_context(None, "unit"):
            x = torch.ones(16).sum()
    assert float(x) == 16
    assert "unit" in {e.key for e in prof.key_averages()}


def test_trace_context_with_logdir(tmp_path):
    logdir = tmp_path / "trace"
    with utils.trace_context(str(logdir), "unit"):
        torch.ones(16).sum()
    files = list(os.scandir(logdir))
    assert files
    assert any('"unit"' in open(f.path, encoding="utf-8").read() for f in files)


# ------------------------------------------------------ spectrogram dataset


def test_spectrogram_parser(tmp_path):
    wav = _tone(sr=16000, n=16000)
    path = str(tmp_path / "a.wav")
    dsp.save_wav(wav, path, 16000)
    parser = spec.SpectrogramParser(sample_rate=16000, device="cpu")
    got = parser.parse_audio(path)
    assert got.shape[0] == parser.n_fft // 2 + 1
    assert abs(got.mean()) < 1e-5
    np.testing.assert_allclose(got.std(), 1.0, rtol=1e-3)
    want = jax_spec.SpectrogramParser(sample_rate=16000).parse_audio(path)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=SPEC_ATOL * np.abs(want).max())


@pytest.mark.parametrize("normalize", [True, False])
def test_spectrogram_dataset(tmp_path, normalize):
    wav_path = str(tmp_path / "a.wav")
    txt_path = str(tmp_path / "a.txt")
    jax_dsp.save_wav(_tone(sr=16000, n=8000), wav_path, 16000)
    with open(txt_path, "w") as f:
        f.write("abc ba")
    manifest = str(tmp_path / "manifest.csv")
    with open(manifest, "w") as f:
        f.write(f"{wav_path},{txt_path}\n")
    ds = spec.SpectrogramDataset(manifest, labels="_abc ", normalize=normalize, device="cpu")
    ref = jax_spec.SpectrogramDataset(manifest, labels="_abc ", normalize=normalize)
    assert len(ds) == len(ref) == 1
    got, transcript = ds[0]
    want, want_transcript = ref[0]
    assert got.ndim == 2
    assert transcript == want_transcript == [1, 2, 3, 4, 2, 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=SPEC_ATOL * np.abs(want).max())


def test_spectrogram_parser_runs_on_the_card_by_default(monkeypatch):
    """No device named: the CUDA card, which raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spec.SpectrogramParser()

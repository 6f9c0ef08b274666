"""The port's DSP chain (neural_sound_generation_tpu_torch.ops.dsp) held
against the JAX package's, on the CPU, with inputs made by numpy.

Tolerances: the analysis functions agree to 1e-4 absolute on normalized
mels in [0, 1] and to 1e-4 on spectra of unit-scale signals (float32 FFTs
in another order differ by a few 1e-6). Griffin-Lim iterates 30 times over
float32 FFTs, which carries that rounding along, so its waveforms agree to
5e-4 absolute on signals of peak about 2 (measured about 8e-5).
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.config import AudioConfig as JaxAudioConfig
from neural_sound_generation_tpu.ops import dsp as jdsp
from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.ops import dsp

torch.set_num_threads(1)

MEL_ATOL = 1e-4
SPEC_ATOL = 1e-4
GL_ATOL = 5e-4


def _signal(n, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 300, 2000])
def test_reflect_pad_matches_numpy_past_the_signal(n):
    y = np.arange(1, n + 1, dtype=np.float32)
    for pad in (7, 512):
        got = dsp._reflect_pad(torch.from_numpy(y), pad).numpy()
        np.testing.assert_array_equal(got, np.pad(y, (pad, pad), mode="reflect"))


@pytest.mark.parametrize("n", [4000, 1000, 700])
def test_stft_matches_jax(n):
    y = _signal(n, seed=n)
    want = np.asarray(jdsp.stft(jnp.asarray(y), 1024, 256))
    got = dsp.stft(_t(y), 1024, 256).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=SPEC_ATOL)


def test_stft_batch_and_win_size():
    ys = np.stack([_signal(3000, seed=s) for s in range(3)])
    got = dsp.stft(_t(ys), 512, 128, win_size=400).numpy()
    for i in range(3):
        want = np.asarray(jdsp.stft(jnp.asarray(ys[i]), 512, 128, win_size=400))
        np.testing.assert_allclose(got[i], want, atol=SPEC_ATOL)


def test_istft_matches_jax():
    y = _signal(4000, seed=1)
    spec = np.asarray(jdsp.stft(jnp.asarray(y), 1024, 256))
    for length in (None, 3000, 5000):
        want = np.asarray(jdsp.istft(jnp.asarray(spec), 1024, 256, length=length))
        got = dsp.istft(_t(spec), 1024, 256, length=length).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=SPEC_ATOL)


@pytest.mark.parametrize("n", [1, 2, 100, 511, 600, 5000])
def test_melspectrogram_matches_jax_any_length(n):
    """Sub-frame signals reflect-pad past their own length, as jnp.pad does."""
    y = _signal(n, seed=n)
    want = np.asarray(jdsp.melspectrogram(jnp.asarray(y), JaxAudioConfig()))
    got = dsp.melspectrogram(_t(y), AudioConfig()).numpy()
    assert got.shape == want.shape == (80, dsp.num_stft_frames(n, 1024, 256))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MEL_ATOL)


def test_melspectrogram_silence_is_finite():
    got = dsp.melspectrogram(torch.zeros(3000), AudioConfig()).numpy()
    want = np.asarray(jdsp.melspectrogram(jnp.zeros(3000), JaxAudioConfig()))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=MEL_ATOL)


def test_melspectrogram_batch_matches_jax():
    wavs = np.stack([_signal(2500, seed=s) for s in range(3)])
    want = np.asarray(jdsp.melspectrogram_batch(jnp.asarray(wavs), JaxAudioConfig()))
    got = dsp.melspectrogram_batch(_t(wavs), AudioConfig()).numpy()
    np.testing.assert_allclose(got, want, atol=MEL_ATOL)
    with pytest.raises(ValueError):
        dsp.melspectrogram_batch(_t(wavs[0]), AudioConfig())


def test_golden_wav_to_mel():
    path = os.path.join(os.path.dirname(__file__), "golden", "dsp_golden.npz")
    g = np.load(path)
    got = dsp.melspectrogram(_t(g["wav"]), AudioConfig()).numpy()
    np.testing.assert_allclose(got, g["mel"], atol=MEL_ATOL)


def test_preemphasis_and_inverse_match_jax_and_scipy():
    from scipy.signal import lfilter

    x = _signal(5000, seed=3)
    want_pre = np.asarray(jdsp.preemphasis(jnp.asarray(x), 0.97))
    np.testing.assert_allclose(dsp.preemphasis(_t(x), 0.97).numpy(), want_pre, atol=1e-6)
    got = dsp.inv_preemphasis(_t(x), 0.97).numpy()
    want = np.asarray(jdsp.inv_preemphasis(jnp.asarray(x), 0.97))
    exact = lfilter([1.0], [1.0, -0.97], x.astype(np.float64))
    # a first-order IIR with pole 0.97 sums about 33 terms of unit scale:
    # float32 sums in two different orders agree to a few 1e-6
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, exact, atol=1e-5)
    # the batch dimension and the off switches
    both = dsp.inv_preemphasis(_t(np.stack([x, 2 * x])), 0.97).numpy()
    np.testing.assert_allclose(both[1], 2 * got, atol=1e-5)
    np.testing.assert_array_equal(dsp.inv_preemphasis(_t(x), 0.97, False).numpy(), x)
    np.testing.assert_array_equal(dsp.preemphasis(_t(x), 0.97, False).numpy(), x)


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_normalization_matches_jax(symmetric, clip):
    kw = dict(symmetric_mels=symmetric, allow_clipping_in_normalization=clip,
              max_abs_value=4.0)
    S = np.linspace(-130.0, 20.0, 301, dtype=np.float32)
    jcfg, tcfg = JaxAudioConfig(**kw), AudioConfig(**kw)
    want = np.asarray(jdsp.normalize_spectrogram(jnp.asarray(S), jcfg))
    got = dsp.normalize_spectrogram(_t(S), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    back = np.asarray(jdsp.denormalize_spectrogram(jnp.asarray(want), jcfg))
    np.testing.assert_allclose(dsp.denormalize_spectrogram(_t(want), tcfg).numpy(), back, atol=1e-4)
    np.testing.assert_allclose(
        dsp.amp_to_db(_t(np.abs(S)), -100.0).numpy(),
        np.asarray(jdsp.amp_to_db(jnp.asarray(np.abs(S)), -100.0)), atol=1e-4)
    np.testing.assert_allclose(
        dsp.db_to_amp(_t(S / 10)).numpy(),
        np.asarray(jdsp.db_to_amp(jnp.asarray(S / 10))), rtol=1e-5)


@pytest.mark.parametrize("momentum", [0.0, 0.99])
def test_griffin_lim_matches_jax_with_injected_phase(momentum):
    """JAX draws the initial phase from jax.random; the port is fed the same
    angles, so the two iterations start from the same point."""
    y = _signal(4000, seed=5)
    jcfg = dataclasses.replace(JaxAudioConfig(), griffin_lim_iters=30,
                               griffin_lim_momentum=momentum)
    tcfg = dataclasses.replace(AudioConfig(), griffin_lim_iters=30,
                               griffin_lim_momentum=momentum)
    mel = jdsp.melspectrogram(jnp.asarray(y), jcfg)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jdsp.inv_mel_spectrogram(mel, jcfg, key))
    u = np.asarray(jax.random.uniform(key, (mel.shape[1], 513), dtype=jnp.float32))
    angles = _t(2 * np.pi * u)
    got = dsp.inv_mel_spectrogram(_t(mel), tcfg, init_angles=angles).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=GL_ATOL)
    # the batch entry point broadcasts the same phase over the batch; a
    # batched FFT may sum in another order than a single one
    batch = dsp.inv_mel_spectrogram_batch(
        _t(np.stack([np.asarray(mel)] * 2)), tcfg, init_angles=angles).numpy()
    np.testing.assert_allclose(batch[1], got, atol=GL_ATOL)


def test_griffin_lim_generator_is_deterministic_and_zero_bins_keep_phase():
    cfg = dataclasses.replace(AudioConfig(), griffin_lim_iters=3)
    S = torch.rand(12, 513, generator=torch.Generator().manual_seed(1))
    S[:, 100:] = 0.0  # zero bins: angle(0) = 0, as in JAX
    a = dsp.griffin_lim(S, cfg, torch.Generator().manual_seed(0))
    b = dsp.griffin_lim(S, cfg, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert a.shape == (256 * 11,)


def test_wav_io_matches_jax(tmp_path):
    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    for sr, data in [
        (22050, (rng.standard_normal(2000) * 8000).astype(np.int16)),
        (16000, (rng.standard_normal((1600, 2)) * 1e8).astype(np.int32)),
        (22050, rng.uniform(-1, 1, 500).astype(np.float32)),
    ]:
        buf = io.BytesIO()
        wavfile.write(buf, sr, data)
        raw = buf.getvalue()
        np.testing.assert_array_equal(
            dsp.load_wav_bytes(raw, 22050), jdsp.load_wav_bytes(raw, 22050))
    path = str(tmp_path / "x.wav")
    dsp.save_wav(_signal(1000), path, 22050)
    np.testing.assert_array_equal(dsp.load_wav(path, 22050), jdsp.load_wav(path, 22050))

"""The port's LWS (neural_sound_generation_tpu_torch.ops.lws) and the LWS
convention of its DSP chain, held against the JAX package on the CPU with
inputs made by numpy.

Tolerances:
  * the window pair and the kernel weights are numpy in both packages and
    equal bit for bit;
  * STFT and ISTFT agree to 1e-6 of the largest magnitude (float32 FFTs in
    another order; measured 1.4e-7);
  * one application of the weighted sums agrees to 1e-5 of the largest
    magnitude: the JAX package evaluates the phase ramps
    exp(-2i pi w q H / N) in float32 at arguments up to 2400 rad, 2e-4 rad
    off, where the port reduces w q H modulo N in integers first (measured
    2e-6);
  * run_lws is held element by element for 3 iterations, to 5e-4 of the
    largest magnitude (measured 7e-5). Over 100 Jacobi iterations the
    division by |g| amplifies those differences at near-zero bins into
    other phase paths (5% of the largest magnitude apart), so there the
    spectral convergence of the two results is held, to 1e-4 absolute
    (measured 6e-6);
  * normalized mel spectrograms in [0, 1] agree to 1e-4; single linear
    bins near the -100 dB floor turn the FFT's absolute rounding (a few
    1e-6 of the largest magnitude) into a relative error, so linear
    spectrograms agree to 5e-4 (measured 1.0e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.config import AudioConfig as JaxAudioConfig
from neural_sound_generation_tpu.ops import dsp as jdsp
from neural_sound_generation_tpu.ops import lws as jlws
from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.ops import dsp, lws

torch.set_num_threads(1)

FSIZE, FSHIFT = 1024, 256
SPEC_REL = 1e-6
KERNEL_REL = 1e-5
LWS_ITER_REL = 5e-4
SC_ATOL = 1e-4
MEL_ATOL = 1e-4
LINEAR_ATOL = 5e-4


def _sig(n=8000, seed=0, noise=0.2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    x = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 880 * t + 0.7)
    return (x + noise * rng.standard_normal(n)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_rel(got, want, rel):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


@pytest.mark.parametrize("fsize,fshift", [(1024, 256), (512, 128), (800, 200), (64, 32)])
def test_windows_and_kernel_weights_are_exact(fsize, fshift):
    for a, b in zip(lws.lws_windows(fsize, fshift), jlws.lws_windows(fsize, fshift)):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    for kr in (1, 2, 5):
        got = lws.lws_kernel_weights(fsize, fshift, kr)
        want = jlws.lws_kernel_weights(fsize, fshift, kr)
        assert got.dtype == want.dtype == np.complex64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_windows_refuse_a_hop_that_does_not_divide():
    with pytest.raises(ValueError):
        lws.lws_windows(1000, 300)


@pytest.mark.parametrize("n", [16000, 16384, 15999, FSHIFT, FSHIFT * 3 + 1])
def test_lws_stft_matches_jax(n):
    y = _sig(n, seed=n)
    want = np.asarray(jlws.lws_stft(jnp.asarray(y), FSIZE, FSHIFT))
    got = lws.lws_stft(_t(y), FSIZE, FSHIFT).numpy()
    assert got.shape == want.shape == (dsp.lws_num_frames(n, FSIZE, FSHIFT), 513)
    assert got.dtype == np.complex64
    _close_rel(got, want, SPEC_REL)


def test_lws_stft_prepadded_and_batch():
    ys = np.stack([_sig(5000, seed=s) for s in range(3)])
    got = lws.lws_stft(_t(ys), FSIZE, FSHIFT).numpy()
    l, r = dsp.lws_pad_lr(5000, FSIZE, FSHIFT)
    pre = lws.lws_stft_prepadded(_t(np.pad(ys, ((0, 0), (l, r)))), FSIZE, FSHIFT).numpy()
    np.testing.assert_array_equal(pre, got)
    for i in range(3):
        want = np.asarray(jlws.lws_stft_prepadded(
            jnp.asarray(np.pad(ys[i], (l, r))), FSIZE, FSHIFT))
        _close_rel(got[i], want, SPEC_REL)


@pytest.mark.parametrize("n", [15999, 4096])
def test_lws_istft_inverts_lws_stft_and_matches_jax(n):
    x = _sig(n, noise=0.3)
    z = np.asarray(jlws.lws_stft(jnp.asarray(x), FSIZE, FSHIFT))
    y = lws.lws_istft(_t(z), FSIZE, FSHIFT, length=n).numpy()
    np.testing.assert_allclose(y, x, atol=2e-6)  # perfect reconstruction
    for length in (None, n):
        want = np.asarray(jlws.lws_istft(jnp.asarray(z), FSIZE, FSHIFT, length=length))
        got = lws.lws_istft(_t(z), FSIZE, FSHIFT, length=length).numpy()
        assert got.shape == want.shape
        _close_rel(got, want, SPEC_REL)
    batch = lws.lws_istft(_t(np.stack([z, 2 * z])), FSIZE, FSHIFT, length=n).numpy()
    np.testing.assert_allclose(batch[1], 2 * y, atol=4e-6)


@pytest.mark.parametrize("k", [-2, -1, 0, 1, 2])
def test_freq_shift_matches_jax(k):
    rng = np.random.default_rng(3)
    v = (rng.standard_normal((4, 17)) + 1j * rng.standard_normal((4, 17))).astype(np.complex64)
    np.testing.assert_array_equal(lws._freq_shift(_t(v), k).numpy(),
                                  np.asarray(jlws._freq_shift(jnp.asarray(v), k)))


@pytest.mark.parametrize("k_radius", [1, 2, 5])
def test_lws_apply_kernel_matches_jax(k_radius):
    z = np.asarray(jlws.lws_stft(jnp.asarray(_sig()), FSIZE, FSHIFT))
    want = np.asarray(jlws.lws_apply_kernel(jnp.asarray(z), FSIZE, FSHIFT, k_radius))
    got = lws.lws_apply_kernel(_t(z), FSIZE, FSHIFT, k_radius).numpy()
    assert got.shape == want.shape and got.dtype == np.complex64
    _close_rel(got, want, KERNEL_REL)


def test_lws_apply_kernel_ramps_are_exact_quarter_turns():
    """At H / N = 1/4 every ramp value is a power of -i."""
    ramps = lws._ramps(FSIZE, FSHIFT, 513, torch.device("cpu")).numpy()
    q = np.arange(-3, 4)[:, None]
    w = np.arange(513)[None, :]
    np.testing.assert_allclose(ramps, (-1j) ** ((w * q) % 4), atol=1e-7)


@pytest.mark.parametrize("iterations", [1, 3])
def test_run_lws_matches_jax_for_a_few_iterations(iterations):
    mag = np.abs(np.asarray(jlws.lws_stft(jnp.asarray(_sig()), FSIZE, FSHIFT)))
    want = np.asarray(jlws.run_lws(jnp.asarray(mag), FSIZE, FSHIFT, iterations=iterations))
    got = lws.run_lws(_t(mag), FSIZE, FSHIFT, iterations=iterations).numpy()
    _close_rel(got, want, LWS_ITER_REL)
    np.testing.assert_allclose(np.abs(got), mag, rtol=1e-5, atol=1e-5)


def test_run_lws_consistency_matches_jax_over_100_iterations():
    x = _sig()
    n = len(x)
    mag = np.abs(np.asarray(jlws.lws_stft(jnp.asarray(x), FSIZE, FSHIFT)))

    def sc_port(z):
        zr = lws.lws_stft(lws.lws_istft(_t(z), FSIZE, FSHIFT, length=n), FSIZE, FSHIFT)
        return float(np.linalg.norm(np.abs(zr.numpy()) - mag) / np.linalg.norm(mag))

    want = np.asarray(jlws.run_lws(jnp.asarray(mag), FSIZE, FSHIFT, iterations=100))
    got = lws.run_lws(_t(mag), FSIZE, FSHIFT, iterations=100).numpy()
    sc0, sc_got, sc_want = sc_port(mag.astype(np.complex64)), sc_port(got), sc_port(want)
    assert abs(sc_got - sc_want) <= SC_ATOL, (sc_got, sc_want)
    assert sc_got < 0.5 * sc0  # the iteration converges (tests/test_lws.py's bound)
    # a batch iterates each row on its own
    both = lws.run_lws(_t(np.stack([mag, mag])), FSIZE, FSHIFT, iterations=2).numpy()
    np.testing.assert_allclose(both[1], lws.run_lws(_t(mag), FSIZE, FSHIFT, 2).numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("use_lws", [False, True])
@pytest.mark.parametrize("n", [15999, 700])
def test_linear_and_mel_spectrogram_match_jax_in_both_conventions(use_lws, n):
    kw = dict(use_lws=use_lws, sample_rate=16000, fmax=7600.0)
    jcfg, tcfg = JaxAudioConfig(**kw), AudioConfig(**kw)
    y = _sig(n, seed=n)
    for tfn, jfn, atol in ((dsp.linearspectrogram, jdsp.linearspectrogram, LINEAR_ATOL),
                           (dsp.melspectrogram, jdsp.melspectrogram, MEL_ATOL)):
        want = np.asarray(jfn(jnp.asarray(y), jcfg))
        got = tfn(_t(y), tcfg).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=atol)
    frames = dsp.lws_num_frames(n, 1024, 256) if use_lws else dsp.num_stft_frames(n, 1024, 256)
    assert got.shape == (80, frames)
    batch = dsp.linearspectrogram_batch(_t(np.stack([y, y])), tcfg).numpy()
    np.testing.assert_allclose(batch[1], dsp.linearspectrogram(_t(y), tcfg).numpy(), atol=1e-6)
    with pytest.raises(ValueError):
        dsp.linearspectrogram_batch(_t(y), tcfg)


def test_inv_mel_spectrogram_under_lws_matches_jax():
    """use_lws runs LWS phase estimation and synthesis, then the inverse
    preemphasis; no phase is drawn (the generator is not used)."""
    kw = dict(use_lws=True, sample_rate=16000, fmax=7600.0, lws_iterations=3)
    jcfg, tcfg = JaxAudioConfig(**kw), AudioConfig(**kw)
    y = _sig(6000)
    mel = np.asarray(jdsp.melspectrogram(jnp.asarray(y), jcfg))
    want = np.asarray(jdsp.inv_mel_spectrogram(jnp.asarray(mel), jcfg, jax.random.PRNGKey(0)))
    gen = torch.Generator().manual_seed(0)
    got = dsp.inv_mel_spectrogram(_t(mel), tcfg, gen).numpy()
    assert got.shape == want.shape == (FSHIFT * mel.shape[1],)
    _close_rel(got, want, LWS_ITER_REL)
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(0).get_state())

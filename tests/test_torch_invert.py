"""Mel inversion, unit extraction and audio from codes in the port, on the
CPU, held against the JAX package: ``inv_linear_spectrogram``,
``inference.audio.{extract_units, reconstruct_audio, codes_to_audio}``
with the same weights through ``convert.py`` (dim 32, 64 codes),
``cli.invert``, and ``/reconstruct`` served under ``use_lws=True``.

Parity criteria:
  * codes are equal (the test checks that the codebook is exercised);
  * mels agree to 1e-4 (float32 convolutions in another order);
  * Griffin-Lim starts from JAX's own initial phases (``jax.random``
    draws injected as ``init_angles``) and iterates 30 times over float32
    FFTs, which carries their rounding along: waveforms agree to 5e-4 on
    signals of peak about 2 (tests/test_torch_dsp.py's bound);
  * LWS runs 3 iterations here, element by element to 5e-4 of the largest
    magnitude (tests/test_torch_lws.py says why not 100).
"""

import dataclasses
import io
import json
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.cli import invert as jinvert
from neural_sound_generation_tpu.cli import serve as jserve
from neural_sound_generation_tpu.config import AudioConfig as JaxAudioConfig
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.inference import audio as jaudio
from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu.ops import dsp as jdsp
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import invert, serve
from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.inference import audio
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.ops import dsp

torch.set_num_threads(1)

DIM, Z_DIM, FRAMES, SR = 32, 64, 16, 22050
MEL_ATOL = 1e-4
GL_ATOL = 5e-4
LWS_REL = 5e-4
GL_ITERS = 30


def _chirp(seconds, sr=SR, f0=220.0):
    t = np.arange(int(sr * seconds)) / sr
    f = f0 + 1500.0 * t / seconds
    return (0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _gl_angles(key, batch, frames):
    """The initial phases JAX's batched inversion draws: one split key per
    utterance, uniform (frames, n_freq) each."""
    keys = jax.random.split(key, batch)
    return _t(np.stack([2 * np.pi * np.asarray(
        jax.random.uniform(k, (frames, 513), dtype=jnp.float32)) for k in keys]))


@pytest.fixture(scope="module")
def pair():
    """A JAX VQ-VAE with perturbed statistics and a codebook drawn from its
    own encoder outputs, the port's copy of it, and a batch of mel windows
    of chirps."""
    rng = np.random.default_rng(0)
    cfg = JaxAudioConfig()
    mels = np.stack([np.asarray(jdsp.melspectrogram(jnp.asarray(_chirp(0.5, f0=f)), cfg))
                     [:, :FRAMES] for f in (150.0, 260.0, 410.0)])[..., None]
    jm = JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(mels[:1]), train=False))
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(0.5 if p[-1].key == "var" else -0.5,
                                 1.5 if p[-1].key == "var" else 0.5,
                                 a.shape).astype(np.float32),
        v["batch_stats"])
    ze = np.asarray(jm.apply(v, jnp.asarray(mels), train=False)[1]).reshape(-1, DIM)
    pick = rng.choice(len(ze), Z_DIM, replace=False)
    v["params"]["codebook"] = (ze[pick] + 0.05 * ze.std(0) * rng.standard_normal(
        (Z_DIM, DIM))).astype(np.float32)
    tm = VQVAE(1, DIM, Z_DIM)
    tm.load_state_dict(convert.flax_to_state_dict(v))
    tm.eval()
    return jm, v, tm, mels.astype(np.float32)


def _cfgs(**kw):
    return (dataclasses.replace(JaxAudioConfig(), griffin_lim_iters=GL_ITERS, **kw),
            dataclasses.replace(AudioConfig(), griffin_lim_iters=GL_ITERS, **kw))


def test_extract_units_matches_jax(pair):
    jm, v, tm, mels = pair
    want = np.asarray(jaudio.extract_units(jm, v, jnp.asarray(mels)))
    got = audio.extract_units(tm, _t(mels))
    assert got.dtype == torch.int32 and got.shape == (3, 20, FRAMES // 4)
    assert len(np.unique(want)) > 8
    np.testing.assert_array_equal(got.numpy(), want)


def test_reconstruct_audio_matches_jax(pair):
    jm, v, tm, mels = pair
    jcfg, tcfg = _cfgs()
    key = jax.random.PRNGKey(3)
    jmel, jwav = jaudio.reconstruct_audio(jm, v, jnp.asarray(mels), jcfg, key)
    tmel, twav = audio.reconstruct_audio(tm, _t(mels), tcfg,
                                         init_angles=_gl_angles(key, 3, FRAMES))
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), atol=MEL_ATOL)
    assert twav.shape == jwav.shape == (3, 256 * (FRAMES - 1))
    np.testing.assert_allclose(twav.numpy(), np.asarray(jwav), atol=GL_ATOL)
    # a generator draws the phases when none are given, one utterance after another
    a = audio.reconstruct_audio(tm, _t(mels), tcfg, torch.Generator().manual_seed(1))[1]
    b = audio.reconstruct_audio(tm, _t(mels), tcfg, torch.Generator().manual_seed(1))[1]
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_codes_to_audio_matches_jax(pair):
    jm, v, tm, mels = pair
    jcfg, tcfg = _cfgs()
    codes = np.asarray(jaudio.extract_units(jm, v, jnp.asarray(mels)))
    key = jax.random.PRNGKey(4)
    want = np.asarray(jaudio.codes_to_audio(jm, v, jnp.asarray(codes), jcfg, key))
    got = audio.codes_to_audio(tm, _t(codes), tcfg, init_angles=_gl_angles(key, 3, FRAMES))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=GL_ATOL)


def test_codes_to_audio_under_lws_matches_jax(pair):
    """Under use_lws the phases come from LWS, so no draw is injected."""
    jm, v, tm, mels = pair
    jcfg, tcfg = _cfgs(use_lws=True, lws_iterations=3)
    codes = np.asarray(jaudio.extract_units(jm, v, jnp.asarray(mels)))
    want = np.asarray(jaudio.codes_to_audio(jm, v, jnp.asarray(codes), jcfg,
                                            jax.random.PRNGKey(0)))
    got = audio.codes_to_audio(tm, _t(codes), tcfg).numpy()
    assert got.shape == want.shape == (3, 256 * FRAMES)
    np.testing.assert_allclose(got, want, atol=LWS_REL * float(np.abs(want).max()))


@pytest.mark.parametrize("use_lws", [False, True])
def test_inv_linear_spectrogram_matches_jax(use_lws):
    kw = dict(use_lws=use_lws, lws_iterations=3)
    jcfg, tcfg = _cfgs(**kw)
    lin = np.asarray(jdsp.linearspectrogram(jnp.asarray(_chirp(0.3)), jcfg))
    key = jax.random.PRNGKey(5)
    want = np.asarray(jdsp.inv_linear_spectrogram(jnp.asarray(lin), jcfg, key))
    angles = None
    if not use_lws:  # the unbatched JAX call draws from the key itself
        angles = _t(2 * np.pi * np.asarray(
            jax.random.uniform(key, (lin.shape[1], 513), dtype=jnp.float32)))
    got = dsp.inv_linear_spectrogram(_t(lin), tcfg, init_angles=angles).numpy()
    assert got.shape == want.shape
    if use_lws:
        np.testing.assert_allclose(got, want, atol=LWS_REL * float(np.abs(want).max()))
    else:
        np.testing.assert_allclose(got, want, atol=GL_ATOL)


def _read_wav(path_or_bytes):
    from scipy.io import wavfile

    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    sr, wav = wavfile.read(src)
    assert wav.dtype == np.int16
    return sr, wav


def test_invert_cli_matches_the_jax_surface(tmp_path, capsys, monkeypatch):
    mel = np.asarray(jdsp.melspectrogram(jnp.asarray(_chirp(0.4)), JaxAudioConfig())).T
    np.save(tmp_path / "ljspeech-mel-00001.npy", mel)
    common = [str(tmp_path), "22050", "1024", "256", "80", "--gl-iters", "5"]
    jinvert.main(common + ["--output", str(tmp_path / "j.wav")])
    out = invert.main(common + ["--output", str(tmp_path / "t.wav"), "--device", "cpu"])
    assert out == str(tmp_path / "t.wav") and f"wrote {out}" in capsys.readouterr().out
    (jsr, jwav), (tsr, twav) = _read_wav(str(tmp_path / "j.wav")), _read_wav(out)
    assert tsr == jsr == 22050 and twav.shape == jwav.shape == (256 * (mel.shape[0] - 1),)
    # --seed seeds the phases; the same seed writes the same file
    again = invert.main(common + ["--output", str(tmp_path / "u.wav"), "--device", "cpu"])
    other = invert.main(common + ["--output", str(tmp_path / "v.wav"), "--device", "cpu",
                                  "--seed", "1"])
    assert np.array_equal(_read_wav(again)[1], twav)
    assert not np.array_equal(_read_wav(other)[1], twav)
    # the same chain as dsp.inv_mel_spectrogram with a generator seeded the same
    cfg = AudioConfig(griffin_lim_iters=5)
    direct = dsp.inv_mel_spectrogram(_t(mel.T), cfg, torch.Generator().manual_seed(0))
    dsp.save_wav(direct.numpy(), str(tmp_path / "d.wav"), 22050)
    assert np.array_equal(_read_wav(str(tmp_path / "d.wav"))[1], twav)
    # under use_lws the CLI inverts with LWS, with no further change
    monkeypatch.setattr(invert, "AudioConfig",
                        lambda **kw: AudioConfig(use_lws=True, lws_iterations=3, **kw))
    lws_out = invert.main(common + ["--output", str(tmp_path / "l.wav"), "--device", "cpu"])
    assert _read_wav(lws_out)[1].shape == (256 * mel.shape[0],)
    with pytest.raises(SystemExit):
        invert.main([str(tmp_path), "22050", "1024", "256", "40", "--device", "cpu"])


def test_invert_cli_defaults_to_the_card(tmp_path, monkeypatch):
    assert invert.parse_args([".", "22050", "1024", "256", "80"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        invert.main([str(tmp_path), "22050", "1024", "256", "80"])


def test_reconstruct_served_under_lws(pair, tmp_path):
    """serve --preset with use_lws: /reconstruct analyses with the LWS
    framing and inverts with LWS, with no change to the server; its length
    equals the JAX server's."""
    from scipy.io import wavfile

    jm, v, tm, _ = pair
    preset = tmp_path / "lws.json"
    preset.write_text(json.dumps({"use_lws": True, "lws_iterations": 5}))
    args = serve.parse_args(["--preset", str(preset), "--dim", str(DIM), "--z-dim",
                             str(Z_DIM), "--frames", str(FRAMES), "--device", "cpu"])
    svc = serve.build_service(args)
    assert svc.cfg.audio.use_lws
    svc.model.load_state_dict(tm.state_dict())
    jcfg = JaxConfig().parse_json({"use_lws": True, "lws_iterations": 5})
    jsvc = jserve.InferenceService(jcfg, jm, v, frames=FRAMES)
    buf = io.BytesIO()
    wavfile.write(buf, SR, (_chirp(0.5) * 32767).astype(np.int16))
    wav_bytes = buf.getvalue()

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/reconstruct"
        with urllib.request.urlopen(urllib.request.Request(url, data=wav_bytes),
                                    timeout=120) as r:
            assert r.status == 200
            body = r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    sr, got = _read_wav(body)
    _, want = _read_wav(jsvc.reconstruct(wav_bytes))
    assert sr == SR and got.shape == want.shape and np.abs(got).max() > 0
    # the windows the LWS analysis gives agree with the JAX server's
    jwin = np.asarray(jsvc._wav_to_mel(wav_bytes)[0])
    twin = svc._wav_to_mel(wav_bytes)[0].numpy()
    np.testing.assert_allclose(twin, jwin, atol=MEL_ATOL)

"""The port's mel VQ-VAE server (neural_sound_generation_tpu_torch.cli.serve)
over real HTTP on the CPU, and the whole slice held against the JAX
package's InferenceService with the same weights (through the bridge) on the
same wav bytes.

Parity criteria:
  * /encode codes are equal, except at near-ties: positions where the JAX
    top-2 distance gap is at most 1e-5 of the distance (float32 sums in
    another order may pick either), at most 0.5% of positions;
  * the analysed mel windows and the reconstructed mels agree to 1e-4
    (float32 convolutions and FFTs summed in another order);
  * the reconstructed waveforms have equal lengths (Griffin-Lim's initial
    phase comes from jax.random on one side and torch on the other).
"""

import argparse
import io
import json
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.cli import serve as jserve
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import serve
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import VQVAE

torch.set_num_threads(1)

DIM, Z_DIM, FRAMES = 32, 64, 16
SR = 22050


def _wav_bytes(seconds=0.3, sr=SR, f0=330.0):
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    f = f0 + 1500.0 * t / max(seconds, 1e-3)
    wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr) * 32767).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, sr, wav)
    return buf.getvalue()


def _read_wav(data):
    from scipy.io import wavfile

    sr, wav = wavfile.read(io.BytesIO(data))
    assert sr == SR and wav.dtype == np.int16
    return wav.astype(np.float64)


@pytest.fixture(scope="module")
def pair():
    """The JAX service and the port's, holding the same weights: JAX init
    with perturbed BatchNorm statistics and a codebook on the scale of the
    encoder's output, so that many codes are in use."""
    jcfg = JaxConfig()
    jm = JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 80, FRAMES, 1)), train=False))
    rng = np.random.default_rng(0)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: rng.uniform(0.5 if p[-1].key == "var" else -0.5,
                                 1.5 if p[-1].key == "var" else 0.5,
                                 a.shape).astype(np.float32),
        v["batch_stats"])
    jsvc = jserve.InferenceService(jcfg, jm, v, frames=FRAMES)
    windows, _, _ = jsvc._wav_to_mel(_wav_bytes(1.0))
    ze = np.asarray(jm.apply(v, windows, train=False)[1]).reshape(-1, DIM)
    pick = rng.choice(len(ze), Z_DIM, replace=False)
    v["params"]["codebook"] = (
        ze[pick] + 0.3 * ze.std(0) * rng.standard_normal((Z_DIM, DIM))
    ).astype(np.float32)
    jsvc = jserve.InferenceService(jcfg, jm, v, frames=FRAMES)
    tm = VQVAE(1, DIM, Z_DIM)
    tm.load_state_dict(convert.flax_to_state_dict(v))
    tsvc = serve.InferenceService(Config(), tm, frames=FRAMES, device="cpu")
    return jm, v, jsvc, tsvc


@pytest.fixture(scope="module")
def server(pair):
    svc = pair[3]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def _post(url, data):
    return urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=120)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _code_cols(seconds):
    from neural_sound_generation_tpu_torch.ops.dsp import num_stft_frames

    return -(-num_stft_frames(int(SR * seconds), 1024, 256) // 4)


def test_health(server):
    assert _get_json(server + "/health") == {"status": "ok", "backend": "cpu"}


@pytest.mark.parametrize("seconds", [0.3, 2.0])
def test_encode_endpoint(server, seconds):
    """Audio longer than the serving window is tiled and stitched."""
    with _post(server + "/encode", _wav_bytes(seconds)) as r:
        body = json.loads(r.read())
    assert body["shape"] == [20, _code_cols(seconds)]
    codes = np.asarray(body["codes"])
    assert codes.shape == tuple(body["shape"])
    assert codes.min() >= 0 and codes.max() < Z_DIM


@pytest.mark.parametrize("seconds", [0.3, 2.0])
def test_reconstruct_endpoint(server, seconds):
    with _post(server + "/reconstruct", _wav_bytes(seconds)) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        wav = _read_wav(r.read())
    assert len(wav) == int(SR * seconds)
    assert 0 < np.abs(wav).max() <= 32767


def test_decode_endpoint(server):
    codes = np.random.default_rng(0).integers(0, Z_DIM, (20, 4)).tolist()
    with _post(server + "/decode", json.dumps({"codes": codes}).encode()) as r:
        wav = _read_wav(r.read())
    assert len(wav) == 256 * (4 * 4 - 1)


@pytest.mark.parametrize("payload,status", [
    (b"this is not json", 400),
    (json.dumps({"codes": [[99999] * 4] * 20}).encode(), 400),  # out of range
    (json.dumps({"codes": [[1] * 4] * 7}).encode(), 400),       # wrong height
    (json.dumps({"nope": 1}).encode(), 400),
])
def test_decode_bad_requests_keep_serving(server, payload, status):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server + "/decode", payload)
    assert err.value.code == status
    assert json.loads(err.value.read())["error"].startswith("bad request:")
    assert _get_json(server + "/health")["status"] == "ok"


def test_internal_error_is_sanitized(server):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server + "/encode", b"\x00" * 64)
    assert err.value.code in (400, 500)
    body = json.loads(err.value.read())
    if err.value.code == 500:
        assert body["error"] == "internal error" and len(body["id"]) == 12
    assert _get_json(server + "/health")["status"] == "ok"


def test_unknown_route(server):
    for call in (lambda: _post(server + "/nope", b""),
                 lambda: urllib.request.urlopen(server + "/nope", timeout=30)):
        with pytest.raises(urllib.error.HTTPError) as err:
            call()
        assert err.value.code == 404


def test_metrics_endpoint(server):
    def stat(s, path, field):
        return s["endpoints"].get(path, {}).get(field, 0)

    before = _get_json(server + "/metrics")
    with _post(server + "/encode", _wav_bytes(0.2)) as r:
        assert r.status == 200
    with pytest.raises(urllib.error.HTTPError):
        _post(server + "/decode", b"not json")
    after = _get_json(server + "/metrics")
    assert after["backend"] == "cpu"
    assert stat(after, "/encode", "requests") == stat(before, "/encode", "requests") + 1
    assert stat(after, "/decode", "errors") == stat(before, "/decode", "errors") + 1
    lat = after["endpoints"]["/encode"]["latency_ms"]
    assert 0 < lat["p50"] <= lat["p99"]


def test_reconstruct_batched_matches_unbatched(pair):
    """Each request of a coalesced batch gets the unbatched waveform, also
    across length buckets, and a malformed upload fails alone."""
    svc = pair[3]
    reqs = [_wav_bytes(0.2), _wav_bytes(0.3, f0=200.0), _wav_bytes(0.7), b"not a wav"]
    singles = [svc.reconstruct(wb) for wb in reqs[:3]]
    batched = svc.reconstruct_batched(reqs)
    assert isinstance(batched[3], Exception)
    for single, batch in zip(singles, batched):
        a, b = _read_wav(single), _read_wav(batch)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2.0)  # int16 LSB jitter


def test_batched_reconstruct_over_http(pair):
    svc = pair[3]
    reference = _read_wav(svc.reconstruct(_wav_bytes(0.3)))
    svc.enable_batching(window_ms=50.0, max_batch=4)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/reconstruct"
    results, errors = [None] * 4, []

    def hit(i):
        try:
            with _post(url, _wav_bytes(0.3)) as r:
                results[i] = r.read()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        for r in results:
            np.testing.assert_allclose(_read_wav(r), reference, atol=2.0)
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.batcher = None


@pytest.mark.parametrize("seconds", [0.5, 2.5])
def test_slice_matches_jax_service(pair, seconds):
    jm, v, jsvc, tsvc = pair
    wav_bytes = _wav_bytes(seconds)

    # analysis and windows
    jwin, jt, jn = jsvc._wav_to_mel(wav_bytes)
    twin, tt, tn = tsvc._wav_to_mel(wav_bytes)
    assert (jt, jn) == (tt, tn) and tuple(twin.shape) == jwin.shape
    np.testing.assert_allclose(twin.numpy(), np.asarray(jwin), atol=1e-4)

    # /encode: codes equal up to near-ties
    jcodes = np.asarray(jsvc.encode(wav_bytes)["codes"])
    tcodes = np.asarray(tsvc.encode(wav_bytes)["codes"])
    assert jcodes.shape == tcodes.shape == (20, _code_cols(seconds))
    assert len(np.unique(jcodes)) > 8
    diff = np.argwhere(jcodes != tcodes)
    assert len(diff) <= 0.005 * jcodes.size
    if len(diff):
        ze = np.asarray(jm.apply(v, jwin, train=False)[1]).astype(np.float64)
        cb = v["params"]["codebook"].astype(np.float64)
        for h, col in diff:
            x = ze[col // 4, h, col % 4]
            d = np.sort(((x[None] - cb) ** 2).sum(1))
            assert d[1] - d[0] <= 1e-5 * d[0], (h, col)

    # the reconstructed mels, before Griffin-Lim
    with torch.inference_mode():
        tmel = tsvc._reconstruct(twin).numpy()
    np.testing.assert_allclose(tmel, np.asarray(jsvc._reconstruct(jwin)), atol=1e-4)

    # /reconstruct: the same length
    assert len(_read_wav(tsvc.reconstruct(wav_bytes))) == len(
        _read_wav(jsvc.reconstruct(wav_bytes)))


def _args(**kw):
    base = dict(preset=None, dim=DIM, z_dim=Z_DIM, frames=FRAMES, gl_iters=None,
                gl_momentum=None, batch_window_ms=0.0, batch_max=8,
                speaker_id=None, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_parse_args_defaults_are_the_flagship():
    args = serve.parse_args([])
    assert (args.dim, args.z_dim, args.frames, args.device) == (256, 512, 84, "cuda")
    assert args.batch_window_ms == 0.0 and args.gl_iters is None


def test_build_service_gl_defaults_and_preset(tmp_path):
    svc = serve.build_service(_args())
    assert (svc.cfg.audio.griffin_lim_iters, svc.cfg.audio.griffin_lim_momentum) == (30, 0.99)
    preset = tmp_path / "p.json"
    preset.write_text(json.dumps({"griffin_lim_iters": 45}))
    svc = serve.build_service(_args(preset=str(preset)))
    assert (svc.cfg.audio.griffin_lim_iters, svc.cfg.audio.griffin_lim_momentum) == (45, 0.0)
    svc = serve.build_service(_args(preset=str(preset), gl_momentum=0.5, batch_window_ms=5.0))
    assert svc.cfg.audio.griffin_lim_momentum == 0.5 and svc.batcher is not None


def test_build_service_multispeaker_preset(tmp_path):
    preset = tmp_path / "ms.json"
    preset.write_text(json.dumps({"gin_channels": 16, "n_speakers": 3}))
    with pytest.raises(SystemExit):
        serve.build_service(_args(preset=str(preset)))
    with pytest.raises(SystemExit):
        serve.build_service(_args(preset=str(preset), speaker_id=3))
    svc0 = serve.build_service(_args(preset=str(preset), speaker_id=0))
    svc2 = serve.build_service(_args(preset=str(preset), speaker_id=2))
    assert svc0.model.speakered
    codes = {"codes": np.zeros((20, 3), int).tolist()}
    assert svc0.decode(codes) != svc2.decode(codes)  # the voice follows --speaker-id


def test_reference_presets_parse():
    import glob
    import os

    import neural_sound_generation_tpu
    from neural_sound_generation_tpu.config import load_preset as jax_load_preset
    from neural_sound_generation_tpu_torch.config import load_preset

    pattern = os.path.join(
        os.path.dirname(neural_sound_generation_tpu.__file__), "config", "presets", "*.json")
    paths = sorted(glob.glob(pattern))
    assert paths
    for path in paths:
        assert load_preset(path).to_flat_dict() == jax_load_preset(path).to_flat_dict()


def test_service_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.InferenceService(Config(), VQVAE(1, 8, 16), frames=FRAMES)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_service(_args(device="cuda"))


# ---------------------------------------------------------------------------
# --vocoder wavenet: the streaming endpoints and the stream mux
# ---------------------------------------------------------------------------


def _vocoder_service(**mux):
    """A seeded VQ-VAE, a one-layer transformer prior and a two-layer
    WaveNet (80 mels, hop 256) on the CPU, streaming in chunks of 512 so
    that short inputs span several; ``mux`` enables the stream mux."""
    from neural_sound_generation_tpu_torch.cli.prior import PriorSpec
    from neural_sound_generation_tpu_torch.models.wavenet import WaveNet

    svc = serve.InferenceService(
        Config(), VQVAE(1, DIM, Z_DIM, generator=torch.Generator().manual_seed(0)),
        frames=FRAMES, device="cpu")
    svc.STREAM_CHUNK = 512
    svc.attach_prior(PriorSpec("transformer", Z_DIM, 32, 1, 1, 10).build(seed=0))
    svc.attach_vocoder(WaveNet(layers=2, stacks=1, residual_channels=8, gate_channels=8,
                               skip_out_channels=8, generator=torch.Generator().manual_seed(1)))
    if mux:
        svc.enable_stream_mux(**mux)
    return svc


@pytest.fixture(scope="module")
def voc_server():
    svc = _vocoder_service()
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield svc, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)


def _pcm(body: bytes) -> np.ndarray:
    return np.frombuffer(body, "<i2").astype(np.float64)


def _mel_frames(seconds):
    from neural_sound_generation_tpu_torch.ops.dsp import num_stft_frames

    return num_stft_frames(int(SR * seconds), 1024, 256)


def test_reconstruct_stream_endpoint(voc_server):
    """Chunked s16le PCM of t x hop samples at a fixed 32767 scale, equal to
    the WaveNet's float output of the stitched reconstructed mel."""
    svc, url = voc_server
    wav_bytes = _wav_bytes(0.1)
    with _post(url + "/reconstruct_stream", wav_bytes) as r:
        assert r.headers["Transfer-Encoding"] == "chunked"
        assert (r.headers["X-Sample-Rate"], r.headers["X-PCM-Format"]) == (str(SR), "s16le")
        pcm = _pcm(r.read())
    assert len(pcm) == _mel_frames(0.1) * 256  # 2304: four chunks and a trimmed fifth
    with torch.inference_mode():
        want = svc._synthesize(svc._reconstruct_full_mel(wav_bytes))
    np.testing.assert_array_equal(pcm, (np.clip(want, -1, 1) * 32767).astype(np.int16))


def test_vocoder_backs_the_buffered_endpoints(voc_server):
    """/reconstruct and /decode synthesize through the WaveNet: mel frames
    x hop samples, peak-normalized WAVs."""
    _, url = voc_server
    with _post(url + "/reconstruct", _wav_bytes(0.1)) as r:
        assert len(_read_wav(r.read())) == _mel_frames(0.1) * 256
    codes = np.random.default_rng(0).integers(0, Z_DIM, (20, 2)).tolist()
    with _post(url + "/decode", json.dumps({"codes": codes}).encode()) as r:
        wav = _read_wav(r.read())
    assert len(wav) == 4 * 2 * 256 and np.abs(wav).max() == 32767


def test_sample_stream_equals_buffered_sample(voc_server):
    """The n utterances stream back to back, utterance i from seed + i:
    the same audio as the buffered /sample up to its peak normalization."""
    _, url = voc_server
    payload = json.dumps({"n": 2, "label": 1, "seed": 3}).encode()
    with _post(url + "/sample_stream", payload) as r:
        stream = _pcm(r.read()) / 32767
    with _post(url + "/sample", payload) as r:
        buffered = _read_wav(r.read())
    assert len(stream) == len(buffered) == 2 * FRAMES * 256
    peak = np.abs(stream).max()
    np.testing.assert_allclose(stream, buffered * peak / 32767, atol=3 / 32767)


def test_stream_endpoints_need_a_vocoder(server):
    for path, body in (("/reconstruct_stream", _wav_bytes(0.2)),
                       ("/sample_stream", json.dumps({"n": 1}).encode())):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server + path, body)
        assert err.value.code == 400
        assert "requires --vocoder wavenet" in json.loads(err.value.read())["error"]
    assert "stream_mux" not in _get_json(server + "/metrics")


def test_stream_mux_over_http():
    """Two concurrent /reconstruct_stream share the slots and each gets its
    full length; a full mux (a slot busy, the other promised to a waiting
    session, max_pending 0) answers 503 with
    Retry-After; /metrics reports the mux."""
    svc = _vocoder_service(slots=2, max_pending=0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(svc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    mux = svc._stream_mux
    try:
        results = [None, None]

        def hit(i):
            with _post(url + "/reconstruct_stream", _wav_bytes(0.05 + 0.05 * i)) as r:
                results[i] = _pcm(r.read())

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert [len(p) for p in results] == [_mel_frames(0.05 + 0.05 * i) * 256 for i in range(2)]

        release = threading.Event()
        orig = mux._dispatch
        mux._dispatch = lambda *a: (release.wait(timeout=60), orig(*a))[1]
        held = [mux.open(torch.zeros(2, 80), 0)]  # a slot; its chunk is held
        deadline = time.time() + 30
        while mux.active < 1 and time.time() < deadline:
            time.sleep(0.01)
        held.append(mux.open(torch.zeros(2, 80), 1))  # waits for the free slot
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url + "/reconstruct_stream", _wav_bytes(0.05))
        assert err.value.code == 503 and err.value.headers["Retry-After"] == "1"
        assert _get_json(url + "/metrics")["stream_mux"] == {
            "slots": 2, "active": 1, "pending": 1, "max_pending": 0}
        release.set()
        for h in held:
            assert len(np.concatenate(list(h))) == 2 * 256
    finally:
        httpd.shutdown()
        httpd.server_close()
    deadline = time.time() + 30
    while (mux.active or mux.pending or mux.busy) and time.time() < deadline:
        time.sleep(0.02)

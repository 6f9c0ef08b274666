"""The port's corpus preprocessing (neural_sound_generation_tpu_torch.
data.corpora and cli.preprocess, on the CPU) held against the JAX package's
CLI on the same synthetic corpora, and the host-side DSP it rests on.

Parity criteria:
  * the train.txt manifests are identical;
  * every raw audio shard is bit-equal: the host arithmetic (decode,
    rescale, trims, pads) is the same numpy code in both packages;
  * mu-law shards keep their dtype (float32; int16, or int32 at 65536
    channels). XLA's float32 log1p and torch's differ by one ulp at some
    arguments (2.6% of uniform draws), so the encoding is held where the
    device batch leaves it, on the same inputs: mu-law floats within 4
    ulps (relative 2^-21), and mu-law integers equal except where the
    exact value (mulaw(x) + 1) / 2 * Q, before the truncation, lies within
    Q * 2^-21 of an integer (8 ulps at the top of the range: 1.2e-4 at
    Q = 256, 0.031 at 65536). A shard differs only where its batch row
    did, by one level;
  * every mel agrees to 1e-4 in the normalized [0, 1] range (float32 FFTs
    and mel products summed in another order: a few 1e-6; the dB of bins
    near the -100 dB floor magnify that);
  * the pad math, the trims and adjust_time_resolution are exact.

Corpora are a few utterances of at most 1 s, so that the JAX engine compiles
one length bucket per configuration; librivox needs a file longer than two
8 s chunks.
"""

import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_sound_generation_tpu.cli import preprocess as jpre
from neural_sound_generation_tpu.config import AudioConfig as JaxAudioConfig
from neural_sound_generation_tpu.data.corpora import engine as jengine
from neural_sound_generation_tpu.data.corpora import librivox as jlibrivox
from neural_sound_generation_tpu.data.corpora import ljspeech as jljspeech
from neural_sound_generation_tpu.ops import dsp as jdsp
from neural_sound_generation_tpu_torch.cli import preprocess as tpre
from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.data.corpora import engine, librivox, ljspeech
from neural_sound_generation_tpu_torch.data.corpora import jsut as tjsut
from neural_sound_generation_tpu_torch.ops import dsp

torch.set_num_threads(1)

MEL_ATOL = 1e-4


# ---------------------------------------------------------------- host DSP


def test_pad_math_matches_jax_over_a_grid_of_lengths():
    for fsize, fshift in ((1024, 256), (512, 128), (800, 200), (1024, 300)):
        for n in list(range(1, 2100, 7)) + [22050, 65536, 160000]:
            assert dsp.lws_num_frames(n, fsize, fshift) == jdsp.lws_num_frames(n, fsize, fshift)
            assert dsp.lws_pad_lr(n, fsize, fshift) == jdsp.lws_pad_lr(n, fsize, fshift)
            assert dsp.librosa_pad_lr(n, fsize, fshift) == jdsp.librosa_pad_lr(n, fsize, fshift)
            assert dsp.num_stft_frames(n, fsize, fshift) == jdsp.num_stft_frames(n, fsize, fshift)
            # the padded signal fills its frames exactly
            l, r = dsp.lws_pad_lr(n, fsize, fshift)
            assert n + l + r == (dsp.lws_num_frames(n, fsize, fshift) - 1) * fshift + fsize


@pytest.mark.parametrize("case", ["speech", "silent", "short", "loud_edges"])
def test_trim_silence_matches_jax(case):
    rng = np.random.default_rng(0)
    sr = 16000
    if case == "speech":
        t = np.arange(sr) / sr
        voiced = 0.5 * np.sin(2 * np.pi * 220 * t)
        wav = np.concatenate([1e-4 * rng.standard_normal(4000), voiced,
                              1e-4 * rng.standard_normal(3000)])
    elif case == "silent":
        wav = np.zeros(5000)
    elif case == "short":
        wav = rng.standard_normal(300)
    else:
        wav = rng.uniform(-1, 1, 7000)
    wav = wav.astype(np.float32)
    cfg, jcfg = AudioConfig(), JaxAudioConfig()
    got = dsp.trim_silence(wav, cfg)
    want = jdsp.trim_silence(wav, jcfg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if case == "speech":
        assert 0 < len(got) < len(wav)


@pytest.mark.parametrize("midpoint,threshold", [(127, 2), (128, 0), (32767, 2)])
def test_start_and_end_indices_match_jax(midpoint, threshold):
    rng = np.random.default_rng(midpoint)
    for q in (rng.integers(0, 256, 500), np.full(40, midpoint),
              np.r_[np.full(30, midpoint), midpoint + 9, np.full(20, midpoint)],
              rng.integers(0, 65536, 300)):
        got = dsp.start_and_end_indices(torch.from_numpy(q.astype(np.int32)), threshold, midpoint)
        want = jdsp.start_and_end_indices(jnp.asarray(q, jnp.int32), threshold, midpoint)
        assert [int(v) for v in got] == [int(v) for v in want]


@pytest.mark.parametrize("n,frames", [(2560, 10), (2600, 10), (256, 1)])
def test_adjust_time_resolution_matches_jax(n, frames):
    rng = np.random.default_rng(n)
    q = rng.integers(0, 256, n).astype(np.int32)
    q[:37] = 127
    mel = rng.standard_normal((frames, 80)).astype(np.float32)
    got = dsp.adjust_time_resolution(torch.from_numpy(q), torch.from_numpy(mel))
    want = jdsp.adjust_time_resolution(jnp.asarray(q), jnp.asarray(mel))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert (int(got[2]), int(got[3])) == (int(want[2]), int(want[3]))
    with pytest.raises(ValueError):
        dsp.adjust_time_resolution(torch.from_numpy(mel), torch.from_numpy(mel))


# ---------------------------------------------------------------- corpora


def _wav(rng, seconds, sr, f0):
    """A chirp with a little noise between leading and trailing digital
    silence (zeros: at 65536 levels one int16 step is already loud)."""
    n = int(sr * seconds)
    t = np.arange(n) / sr
    f = f0 + 900.0 * t / max(seconds, 1e-3)
    voiced = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr) + 0.01 * rng.standard_normal(n)
    return np.concatenate([np.zeros(sr // 10), voiced, np.zeros(sr // 8)]).astype(np.float32)


def _make_wav_corpus(root, n=4, sr=22050, extra_files=()):
    """Synthetic LJSpeech-layout corpus (tests/test_data.py's layout)."""
    rng = np.random.default_rng(0)
    wav_dir = root / "wavs"
    wav_dir.mkdir(parents=True)
    lines = []
    for i in range(n):
        dsp.save_wav(_wav(rng, 0.3 + 0.15 * i, sr, 200 + 50 * i),
                     str(wav_dir / f"LJ-{i:04d}.wav"), sr)
        lines.append(f"LJ-{i:04d}|raw text {i}|normalized text {i}")
    for name, data in extra_files:
        (wav_dir / f"{name}.wav").write_bytes(data)
        lines.append(f"{name}|raw|broken {name}")
    (root / "metadata.csv").write_text("\n".join(lines), encoding="utf-8")
    return root


def _make_cmu_corpus(root, sr=16000):
    rng = np.random.default_rng(1)
    for s, spk in enumerate(("awb", "slt")):
        wav_dir = root / f"cmu_us_{spk}_arctic" / "wav"
        wav_dir.mkdir(parents=True)
        for i in range(2):
            dsp.save_wav(_wav(rng, 0.4 + 0.2 * i + 0.1 * s, sr, 150 + 80 * i),
                         str(wav_dir / f"arctic_a{i + 1:04d}.wav"), sr)
    return root


def _make_jsut_corpus(root, with_lab, sr=24000):
    rng = np.random.default_rng(2)
    subset = root / "basic5000"
    (subset / "wav").mkdir(parents=True)
    lines = []
    for i in range(3):
        utt = f"BASIC5000_{i + 1:04d}"
        dsp.save_wav(_wav(rng, 0.35 + 0.2 * i, sr, 180 + 40 * i),
                     str(subset / "wav" / f"{utt}.wav"), sr)
        lines.append(f"{utt}:テキスト{i}")
        if with_lab and i < 2:  # the third utterance falls back to the energy trim
            (subset / "lab").mkdir(exist_ok=True)
            (subset / "lab" / f"{utt}.lab").write_text(
                "0 1000000 silB\n1000000 2500000 a\n2500000 4000000 i\n"
                f"4000000 {5000000 + 1000000 * i} silE\n", encoding="utf-8")
    (subset / "transcript_utf8.txt").write_text("\n".join(lines), encoding="utf-8")
    return root


def _make_librivox_corpus(root, sr=16000):
    rng = np.random.default_rng(3)
    (root / "book").mkdir(parents=True)
    dsp.save_wav(_wav(rng, 17.0, sr, 120), str(root / "book" / "chapter01.wav"), sr)
    dsp.save_wav(_wav(rng, 0.6, sr, 300), str(root / "book" / "chapter02.wav"), sr)
    return root


MULAW_REL = 2.0**-21


class _Recorder:
    """Wraps an engine's ``_batch_transform`` and keeps every call's
    waveform batch and encoded batch as numpy arrays."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        real = module._batch_transform

        def recording(wavs, prepped, cfg):
            mels, outs = real(wavs, prepped, cfg)
            self.calls.append((np.array(wavs), np.array(outs)))
            return mels, outs

        monkeypatch.setattr(module, "_batch_transform", recording)


def _mulaw_exact(x: np.ndarray, mu: int) -> np.ndarray:
    x = x.astype(np.float64)
    return np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)


def check_encoded_batches(jcalls, tcalls, input_type: str, q: int) -> int:
    """The device batches' encodings agree as the module docstring says;
    returns how many integers differ (each at a truncation boundary)."""
    assert len(jcalls) == len(tcalls)
    flips = 0
    for (jw, jo), (tw, to) in zip(jcalls, tcalls):
        np.testing.assert_array_equal(tw, jw)  # the same inputs
        assert to.shape == jo.shape
        if input_type == "raw":
            np.testing.assert_array_equal(to, jo)
        elif input_type == "mulaw":
            np.testing.assert_allclose(to, jo, rtol=MULAW_REL, atol=0)
        else:
            differ = to != jo
            f = (_mulaw_exact(jw[differ], q) + 1) / 2 * q
            assert np.all(np.abs(f - np.round(f)) <= q * MULAW_REL), f
            assert np.all(np.abs(to[differ].astype(np.int64) - jo[differ]) == 1)
            flips += int(differ.sum())
    return flips


def _compare_dirs(jdir, tdir, flips: int = 0, raw: bool = True):
    jmanifest = (jdir / "train.txt").read_text(encoding="utf-8")
    assert (tdir / "train.txt").read_text(encoding="utf-8") == jmanifest
    lines = jmanifest.splitlines()
    assert lines
    shard_flips = 0
    for line in lines:
        audio, mel = line.split("|")[:2]
        ja, ta = np.load(jdir / audio), np.load(tdir / audio)
        assert ta.dtype == ja.dtype and ta.shape == ja.shape, audio
        if np.issubdtype(ja.dtype, np.integer):
            differ = ta != ja
            assert np.all(np.abs(ta[differ].astype(np.int64) - ja[differ]) == 1), audio
            shard_flips += int(differ.sum())
        elif raw:
            np.testing.assert_array_equal(ta, ja, err_msg=audio)
        else:
            np.testing.assert_allclose(ta, ja, rtol=MULAW_REL, atol=0, err_msg=audio)
        jm, tm = np.load(jdir / mel), np.load(tdir / mel)
        assert tm.dtype == jm.dtype == np.float32 and tm.shape == jm.shape, mel
        np.testing.assert_allclose(tm, jm, atol=MEL_ATOL, err_msg=mel)
    assert shard_flips <= flips
    return lines


def _summary(text):
    """The CLI's summary lines, the timing cut off."""
    out = []
    for line in text.splitlines():
        if line.startswith("Preprocessed "):
            out.append(line.split(" in ")[0])
        elif line.startswith(("Wrote ", "Max/min timesteps")):
            out.append(line)
    return out


def _run_both(capsys, monkeypatch, name, in_dir, out_root, *flags):
    """Both CLIs on one corpus; returns (manifest lines, the port's output
    directory, integer flips at truncation boundaries)."""
    jdir, tdir = out_root / "jax", out_root / "torch"
    jrec, trec = _Recorder(monkeypatch, jengine), _Recorder(monkeypatch, engine)
    jlibrivox._DECODE_CACHE.clear()
    jpre.main([name, str(in_dir), str(jdir), "--num_workers", "2", *flags])
    jtext = capsys.readouterr().out
    librivox._DECODE_CACHE.clear()
    entries = tpre.main([name, str(in_dir), str(tdir), "--num_workers", "2",
                         "--device", "cpu", *flags])
    ttext = capsys.readouterr().out
    assert _summary(ttext) == _summary(jtext) and len(_summary(ttext)) == 3
    assert "frames/sec" in ttext
    cfg = tpre.Config().parse(",".join(
        v for f, v in zip(flags, flags[1:]) if f == "--hparams"))
    flips = check_encoded_batches(jrec.calls, trec.calls, cfg.audio.input_type,
                                  cfg.audio.quantize_channels)
    lines = _compare_dirs(jdir, tdir, flips, raw=cfg.audio.input_type == "raw")
    assert len(entries) == len(lines)
    return lines, tdir, flips


@pytest.mark.parametrize("hparams,dtype", [
    ("", np.float32),
    ("input_type=mulaw,quantize_channels=256", np.float32),
    ("input_type=mulaw-quantize,quantize_channels=256", np.int16),
    ("input_type=mulaw-quantize,quantize_channels=65536", np.int32),
])
def test_ljspeech_cli_matches_jax(tmp_path, capsys, monkeypatch, hparams, dtype):
    in_dir = _make_wav_corpus(tmp_path / "in")
    flags = ["--hparams", hparams] if hparams else []
    lines, tdir, flips = _run_both(capsys, monkeypatch, "ljspeech", in_dir,
                                   tmp_path / "out", *flags)
    assert len(lines) == 4
    for line in lines:
        audio, mel, steps = line.split("|")[:3]
        a, m = np.load(tdir / audio), np.load(tdir / mel)
        assert a.dtype == dtype and len(a) == m.shape[0] * 256 == int(steps)
    if "mulaw-quantize" in hparams:
        q = int(hparams.rsplit("=", 1)[1])
        a = np.load(tdir / lines[0].split("|")[0])
        assert a.min() >= 0 and a.max() < q
        if q == 65536:
            assert a.max() > 32768  # int16 would have wrapped
        # the mu-law trim cut the silence: 0.3 s of chirp in 0.525 s of file
        assert int(lines[0].split("|")[2]) < int(0.45 * 22050)
        # one ulp of mulaw(x) is 0.002 levels at Q = 65536 (some 0.1% of
        # samples flip), 1e-5 at 256 (none here)
        n = sum(int(line.split("|")[2]) for line in lines)
        assert flips <= (1e-2 * n if q == 65536 else 0), flips


def test_cmu_arctic_cli_matches_jax_under_lws(tmp_path, capsys, monkeypatch):
    in_dir = _make_cmu_corpus(tmp_path / "in")
    lines, tdir, _ = _run_both(capsys, monkeypatch, "cmu_arctic", in_dir, tmp_path / "out",
                            "--hparams", "input_type=mulaw-quantize,quantize_channels=256",
                            "--sample_rate", "16000")
    assert [line.split("|")[4] for line in lines] == ["0", "0", "6", "6"]
    for line in lines:
        audio, mel, steps = line.split("|")[:3]
        m = np.load(tdir / mel)
        # the LWS framing (use_lws forced by the corpus)
        assert m.shape[0] * 256 == int(steps)


@pytest.mark.parametrize("with_lab", [False, True])
def test_jsut_cli_matches_jax(tmp_path, capsys, monkeypatch, with_lab):
    in_dir = _make_jsut_corpus(tmp_path / "in", with_lab)
    lines, _, _ = _run_both(capsys, monkeypatch, "jsut", in_dir, tmp_path / "out")
    assert [line.split("|")[3] for line in lines] == [f"テキスト{i}" for i in range(3)]
    if with_lab:  # the lab's voiced span: 0.1 s to 0.4 s
        lab = str(in_dir / "basic5000" / "lab" / "BASIC5000_0001.lab")
        assert tjsut._lab_trim(lab, 22050) == (2205, 8820)


def test_librivox_cli_matches_jax(tmp_path, capsys, monkeypatch):
    in_dir = _make_librivox_corpus(tmp_path / "in")
    lines, _, _ = _run_both(capsys, monkeypatch, "librivox", in_dir, tmp_path / "out",
                         "--sample_rate", "16000")
    # 17.3 s -> two 8 s chunks (the tail dropped); 0.8 s -> one short chunk
    assert [line.split("|")[3] for line in lines] == [
        "chapter01 chunk 0", "chapter01 chunk 1", "chapter02 chunk 0"]
    assert len(librivox._DECODE_CACHE) <= librivox._DECODE_CAPACITY


def test_skip_errors_matches_jax(tmp_path, capsys, monkeypatch):
    short = _riff(np.zeros(100, np.int16), 22050)
    in_dir = _make_wav_corpus(tmp_path / "in", n=3,
                              extra_files=[("corrupt", b"not a wav"), ("short", short)])
    lines, _, _ = _run_both(capsys, monkeypatch, "ljspeech", in_dir, tmp_path / "out",
                            "--skip-errors")
    assert len(lines) == 3
    with pytest.raises(ValueError):
        tpre.main(["ljspeech", str(in_dir), str(tmp_path / "o2"), "--device", "cpu"])


def _riff(pcm: np.ndarray, sr: int) -> bytes:
    data = pcm.tobytes()
    return (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sr, 2 * sr, 2, 16)
            + b"data" + struct.pack("<I", len(data)) + data)


def test_chunked_numbering_matches_jax(tmp_path):
    """chunk_size below the corpus size: chunks of 2, numbered on."""
    in_dir = _make_wav_corpus(tmp_path / "in", n=5)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jent = jengine.preprocess_utterances(jljspeech.collect(str(in_dir)), str(jdir),
                                         JaxAudioConfig(), name="lj", chunk_size=2)
    tent = engine.preprocess_utterances(ljspeech.collect(str(in_dir)), str(tdir),
                                        AudioConfig(), name="lj", chunk_size=2, device="cpu")
    assert tent == [type(tent[0])(**vars(e)) for e in jent]
    assert [e.audio_path for e in tent] == [f"lj-audio-{i:05d}.npy" for i in range(1, 6)]
    from neural_sound_generation_tpu_torch.data.manifest import write_manifest

    write_manifest(str(tdir), tent)
    jpre.write_metadata(jent, str(jdir), jpre.Config())
    _compare_dirs(jdir, tdir)


def test_engine_buckets_and_device_batch(tmp_path):
    """Utterances in two length buckets and batches of 2 give the same
    shards as one batch each."""
    in_dir = _make_wav_corpus(tmp_path / "in", n=4)
    specs = ljspeech.collect(str(in_dir))
    one = engine.preprocess_utterances(specs, str(tmp_path / "a"), AudioConfig(),
                                       device_batch=16, length_quantum=65536, device="cpu")
    two = engine.preprocess_utterances(specs, str(tmp_path / "b"), AudioConfig(),
                                       device_batch=2, length_quantum=8192, device="cpu")
    assert one == two
    for e in one:
        np.testing.assert_array_equal(np.load(tmp_path / "a" / e.audio_path),
                                      np.load(tmp_path / "b" / e.audio_path))
        np.testing.assert_allclose(np.load(tmp_path / "a" / e.mel_path),
                                   np.load(tmp_path / "b" / e.mel_path), atol=1e-5)


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    args = tpre.parse_args(["ljspeech", "in", "out"])
    assert args.device == "cuda" and args.device_batch == 16
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    in_dir = _make_wav_corpus(tmp_path / "in", n=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpre.main(["ljspeech", str(in_dir), str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")

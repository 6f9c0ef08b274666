"""Inference server: HTTP endpoints over a mel VQ-VAE, in PyTorch.

Counterpart of ``neural_sound_generation_tpu/cli/serve.py`` for the flat
mel VQ-VAE and (``--model hiervqvae``) the two-level one. Stdlib-only HTTP
server:

  POST /encode       wav bytes (RIFF) -> {"codes": [[...]], "shape": [...]};
                     --model hiervqvae: {"codes_top", "shape_top",
                     "codes_bottom", "shape_bottom"}, the bottom grid
                     exactly twice the top's width
  POST /reconstruct  wav bytes -> reconstructed wav bytes
  POST /decode       {"codes": [[...]]} JSON -> wav bytes; --model
                     hiervqvae: {"codes_top": ..., "codes_bottom": ...}
  POST /sample       {"n": 1, "label": 0, "seed": 0} -> wav bytes: the prior
                     (--prior-ckpt) samples n code grids of (num_mels/4,
                     frames/4), decoded and concatenated in time; --model
                     hiervqvae: the top prior a (num_mels/8, frames/8)
                     grid, the bottom prior (--bottom-ckpt) twice it
  POST /reconstruct_stream  wav bytes -> chunked raw s16le PCM as the
                     WaveNet vocoder emits it (--vocoder wavenet)
  POST /sample_stream  the /sample payload -> chunked raw s16le PCM, the n
                     utterances back to back (--vocoder wavenet)
  GET  /health       -> {"status": "ok", "backend": "cuda" | "cpu"}
  GET  /metrics      -> per-endpoint request/error counts and latency
                        percentiles, and the stream mux's occupancy

Synthesis runs through Griffin-Lim, or with ``--vocoder wavenet
--vocoder-ckpt`` through a WaveNet vocoder artifact (``cli.vocoder``): the
scan sampler in chunks of 4096 samples with bf16 products, each chunk
sent as soon as it is computed, or with ``--stream-slots N`` through a stream multiplexer
that steps up to N concurrent sessions as one batch (``serving/mux.py``;
``--stream-max-pending`` bounds its queue, and an overloaded mux answers
503). The streaming endpoints scale samples by a fixed 32767, since a
stream cannot know its future peak; a failure after the first piece drops
the connection rather than write a status line into the chunked body.

Long inputs are tiled over serving windows of ``--frames`` mel frames (84
for the flat model, 80 for the hierarchy, whose windows must be a multiple
of 8) and stitched. With ``--batch-window-ms`` concurrent /reconstruct
requests are coalesced into one batch per length bucket; each result
equals the unbatched one. ``--ckpt-dir`` serves a checkpoint written by ``cli.main``
(its live parameters, or with ``--ema`` its averaged model); without one
the server serves weights initialized from seed 0, as the JAX server does.
``--prior-ckpt`` serves a ``cli.prior`` checkpoint over ``/sample`` and
``/sample_stream``: a PixelCNN (``--prior-arch pixelcnn``, the default) or
a transformer, routed with ``--prior-moe-experts N`` (every transformer
level); its recorded family, widths, ``prior_heads`` and ``n_experts``
must match the flags. Under ``--model hiervqvae`` it is the top prior and
``--bottom-ckpt`` the spatially conditioned bottom one, built from
``--bottom-prior-*`` (each defaulting to the top's flag). Speaker-conditioned
presets under ``--model hiervqvae`` refuse.

Run: ``python -m neural_sound_generation_tpu_torch.cli.serve [--device cuda]``
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import itertools
import json
import logging
import queue
import threading
import time
import types
import uuid
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from neural_sound_generation_tpu_torch.cli import vocoder as cli_vocoder
from neural_sound_generation_tpu_torch.config import Config, load_preset
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.inference import sample_hier_mels, sample_prior_mels
from neural_sound_generation_tpu_torch.models import VQVAE, HierVQVAE
from neural_sound_generation_tpu_torch.models.wavenet import make_chunked_generate_fn
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.serving import MuxOverloaded, WaveNetStreamMux
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import create_train_state

#: Griffin-Lim's initial phase is drawn from a generator seeded with this
#: for every request, as the JAX server uses PRNGKey(0): a request's audio
#: does not depend on what else was in its batch.
GL_SEED = 0


class _MicroBatcher:
    """Cross-request dynamic batching (--batch-window-ms).

    Handler threads ``submit()`` and block; one worker thread collects
    requests for up to ``window_ms`` after the first arrival (or until
    ``max_batch``), runs them through ``run_batch`` as one batch, and wakes
    each caller with its own result."""

    def __init__(self, run_batch, window_ms: float, max_batch: int = 8):
        self._run_batch = run_batch
        self._window = max(0.0, float(window_ms)) / 1000.0
        self._max = max(1, int(max_batch))
        self._q: queue.Queue = queue.Queue()
        threading.Thread(
            target=self._worker, daemon=True, name="nsg-microbatch"
        ).start()

    def submit(self, request):
        done = threading.Event()
        box = [done, None]  # [event, result-or-exception]
        self._q.put((request, box))
        done.wait()
        if isinstance(box[1], Exception):
            raise box[1]
        return box[1]

    def _worker(self):
        while True:
            batch = [self._q.get()]
            deadline = time.monotonic() + self._window
            while len(batch) < self._max:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
            try:
                results = self._run_batch([req for req, _ in batch])
            except Exception as e:  # noqa: BLE001 — wake every caller
                results = [e] * len(batch)
            for (_, box), result in zip(batch, results):
                box[1] = result
                box[0].set()


class _Metrics:
    """Thread-safe per-endpoint request counters + latency reservoirs
    (last ``window`` observations) for GET /metrics."""

    def __init__(self, window: int = 512):
        self._lock = threading.Lock()
        self._lat: dict = {}
        self._count: dict = {}
        self._errors: dict = {}
        self._window = window
        self._t0 = time.time()

    def observe(self, path: str, seconds: float, ok: bool):
        with self._lock:
            d = self._lat.setdefault(path, deque(maxlen=self._window))
            d.append(seconds)
            self._count[path] = self._count.get(path, 0) + 1
            if not ok:
                self._errors[path] = self._errors.get(path, 0) + 1

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "uptime_s": round(time.time() - self._t0, 1),
                "endpoints": {},
            }
            for path, d in self._lat.items():
                lat = sorted(d)
                n = len(lat)
                out["endpoints"][path] = {
                    "requests": self._count.get(path, 0),
                    "errors": self._errors.get(path, 0),
                    "latency_ms": {
                        "p50": round(1e3 * lat[n // 2], 1),
                        "p99": round(1e3 * lat[min(n - 1, int(n * 0.99))], 1),
                        "mean": round(1e3 * sum(lat) / n, 1),
                    },
                }
            return out


class InferenceService:
    """Holds the model on its device and runs the serving chains.

    Thread-safe: requests share the model read-only under
    ``torch.inference_mode``. ``device=None`` means the CUDA card and
    raises without one."""

    #: encoder time-axis downsampling (two stride-2 convs); the hierarchy's
    #: top grid has twice this stride
    STRIDE = 4
    #: samples per chunk of the WaveNet streaming sampler and the mux
    STREAM_CHUNK = 4096

    def __init__(self, cfg: Config, model: VQVAE | HierVQVAE, frames: int = 84,
                 device=None, default_speaker=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.hier = isinstance(model, HierVQVAE)
        if self.hier and frames % 8:
            raise ValueError(
                f"hiervqvae serving window must be a multiple of 8, got frames={frames}")
        self.model = model.to(self.device).eval()
        self.speakered = getattr(model, "speakered", False)
        n_spk = model.n_speakers if self.speakered else 0
        if n_spk > 0 and (
            default_speaker is None or not 0 <= int(default_speaker) < n_spk
        ):
            raise ValueError(
                f"speaker-conditioned model ({n_spk} speakers) needs "
                f"default_speaker in [0, {n_spk}), got {default_speaker}"
            )
        self.default_speaker = default_speaker
        self.frames = frames
        self.metrics = _Metrics()
        self.batcher = None  # set by enable_batching
        self.prior = None  # set by attach_prior (serving /sample)
        self.bottom_prior = None  # the hierarchy's conditional bottom prior
        self.vocoder = None  # set by attach_vocoder (--vocoder wavenet)
        self._stream = None  # the vocoder's chunked sampler, set by attach_vocoder
        self._stream_mux = None  # set by enable_stream_mux (--stream-slots)

    # -- model calls ------------------------------------------------------

    def _g(self, n: int):
        """Per-window speaker ids for a speaker-conditioned decoder."""
        if not self.speakered:
            return None
        return torch.full((n,), int(self.default_speaker), device=self.device)

    def _reconstruct(self, windows: torch.Tensor) -> torch.Tensor:
        """(n, n_mels, frames, 1) -> the VQ-VAE's reconstruction, same shape."""
        if self.hier:
            return self.model(windows)[0]
        x_tilde, _, _ = self.model(windows, g=self._g(windows.shape[0]))
        return x_tilde

    def _gl_angles(self, n_frames: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(GL_SEED)
        shape = (n_frames, self.cfg.audio.fft_size // 2 + 1)
        return dsp.random_angles(shape, gen, self.device)

    def _vocode(self, mel: torch.Tensor) -> torch.Tensor:
        """(..., n_mels, T) normalized mels -> waveforms via Griffin-Lim."""
        angles = self._gl_angles(mel.shape[-1])
        return dsp.inv_mel_spectrogram(mel, self.cfg.audio, init_angles=angles)

    def _post_np(self, chunk: np.ndarray) -> np.ndarray:
        """The vocoder's memoryless post-processing (inverse mu-law) on a
        host-side chunk."""
        return cli_vocoder.postprocess(torch.from_numpy(chunk), self.cfg.audio).float().numpy()

    def _vocode_stream(self, mel: torch.Tensor, seed: int = 0):
        """(n_mels, T') normalized mel -> generator of float32 waveform
        chunks from the WaveNet's streaming sampler: chunks of STREAM_CHUNK
        samples, bf16 products, the MoL head and the sampling in float32.
        With the stream mux the session takes one slot of its batched loop;
        otherwise each chunk is copied to the host as soon as it is
        computed. The inverse mu-law is memoryless, so it applies per
        chunk."""
        if self._stream_mux is not None:
            for chunk in self._stream_mux.open(mel.T, seed):
                yield self._post_np(chunk)
            return
        generator = torch.Generator(device=self.device).manual_seed(seed)
        for blk in self._stream(mel.T[None], None, generator):
            yield cli_vocoder.postprocess(blk[0], self.cfg.audio).float().cpu().numpy()

    def _synthesize(self, mel: torch.Tensor, seed: int = 0) -> np.ndarray:
        """(n_mels, T') normalized mel -> waveform through the configured
        vocoder: the WaveNet (T' x hop samples), or Griffin-Lim."""
        if self.vocoder is None:
            return self._vocode(mel).cpu().numpy()
        return np.concatenate(list(self._vocode_stream(mel, seed)))

    def _reconstruct_wav(self, samples: torch.Tensor) -> torch.Tensor:
        """(B, L) padded requests of one length bucket -> (B, samples).

        The whole /reconstruct chain in one call: mel analysis -> windows
        -> VQ-VAE -> stitch -> Griffin-Lim. Requests fold into the model's
        window batch (B requests x n windows -> one (B*n, ...) batch),
        which is correct because eval-mode BatchNorm uses running
        statistics and every window is independent."""
        a = self.cfg.audio
        n_mels, win = a.num_mels, self.frames
        mels = dsp.melspectrogram(samples, a)  # (B, n_mels, T')
        b = samples.shape[0]
        n_win = mels.shape[-1] // win
        windows = (
            mels[..., : n_win * win]
            .reshape(b, n_mels, n_win, win)
            .permute(0, 2, 1, 3)
            .reshape(b * n_win, n_mels, win, 1)
        )
        out = self._reconstruct(windows)[..., 0].reshape(b, n_win, n_mels, win)
        full = out.permute(0, 2, 1, 3).reshape(b, n_mels, n_win * win)
        return self._vocode(full)

    # -- host-side framing ------------------------------------------------

    def _decode_wav_bytes(self, wav_bytes: bytes) -> np.ndarray:
        return dsp.load_wav_bytes(wav_bytes, self.cfg.audio.sample_rate)

    def _encode_wav_bytes(self, wav_np: np.ndarray) -> bytes:
        from scipy.io import wavfile

        buf = io.BytesIO()
        wav_np = wav_np * (32767 / max(0.01, float(np.abs(wav_np).max())))
        wavfile.write(buf, self.cfg.audio.sample_rate, wav_np.astype(np.int16))
        return buf.getvalue()

    def _wav_to_mel(self, wav_bytes: bytes):
        """Window the full utterance into (n, n_mels, frames, 1) batches.

        Returns (windows, t, n_win): t is the true mel frame count, n_win
        the number of windows that hold it; the window batch is padded to
        the next power of two, as in the JAX server, so both servers see
        the same shapes. The samples are zero-padded to the window grid
        before analysis, so the last frames see zeros instead of the
        reflect tail."""
        data = self._decode_wav_bytes(wav_bytes)
        a = self.cfg.audio
        hop = a.effective_hop_size
        t = dsp.num_stft_frames(len(data), a.fft_size, hop)
        n_win = max(1, -(-t // self.frames))
        n_pad = 1 << (n_win - 1).bit_length()
        total = n_pad * self.frames * hop
        buf = np.zeros(total, np.float32)
        buf[: min(len(data), total)] = data[:total]
        mel = dsp.melspectrogram(torch.from_numpy(buf).to(self.device), a)
        windows = (
            mel[:, : n_pad * self.frames]
            .reshape(mel.shape[0], n_pad, self.frames)
            .permute(1, 0, 2)[..., None]
        )
        return windows, t, n_win

    def _pad_for_reconstruct(self, wav_bytes: bytes):
        """Decode + zero-pad input samples to the power-of-two serving
        window grid (the length bucket). Returns (padded, n_data)."""
        data = self._decode_wav_bytes(wav_bytes)
        hop = self.cfg.audio.effective_hop_size
        t_est = len(data) // hop + 1
        n_win = max(1, -(-t_est // self.frames))
        n_pad = 1 << (n_win - 1).bit_length()
        total = n_pad * self.frames * hop + self.cfg.audio.fft_size
        padded = np.zeros(total, np.float32)
        padded[: min(len(data), total)] = data[:total]
        return padded, len(data)

    @staticmethod
    def _stitch(codes, t, stride):
        """(n, H', W') window code grids -> one (H', cols) grid trimmed to
        the true mel length t."""
        valid = max(1, -(-t // stride))
        return np.concatenate(list(codes), axis=-1)[:, :valid]

    @staticmethod
    def _check_codes(arr: np.ndarray, limit: int, name: str):
        # out-of-range indices must not reach the device gather
        if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= limit):
            raise ValueError(f"{name} entries must be in [0, {limit})")

    # -- endpoints --------------------------------------------------------

    @torch.inference_mode()
    def encode(self, wav_bytes: bytes) -> dict:
        windows, t, n_win = self._wav_to_mel(wav_bytes)
        if self.hier:
            idx_t, idx_b = self.model.encode(windows)
            top = self._stitch(idx_t[:n_win].cpu().numpy(), t, 2 * self.STRIDE)
            # the bottom trims to exactly twice the top's width (ceil(t / 4)
            # can be a column short): /decode requires the alignment
            bottom = np.concatenate(list(idx_b[:n_win].cpu().numpy()), axis=-1)
            bottom = bottom[:, : 2 * top.shape[-1]]
            return {"codes_top": top.tolist(), "shape_top": list(top.shape),
                    "codes_bottom": bottom.tolist(), "shape_bottom": list(bottom.shape)}
        codes = self.model.encode(windows)[:n_win].cpu().numpy()  # (n, H', W')
        stitched = self._stitch(codes, t, self.STRIDE)
        return {"codes": stitched.tolist(), "shape": list(stitched.shape)}

    @torch.inference_mode()
    def reconstruct(self, wav_bytes: bytes) -> bytes:
        """The input is zero-padded to the serving-window grid on the host,
        the analysis -> VQ -> synthesis chain runs on the device, and the
        waveform is trimmed to the input length. With a WaveNet vocoder the
        sampler runs over the stitched reconstructed mel instead."""
        if self.vocoder is not None:
            return self._encode_wav_bytes(self._synthesize(self._reconstruct_full_mel(wav_bytes)))
        if self.batcher is not None:
            return self.batcher.submit(wav_bytes)
        padded, n_data = self._pad_for_reconstruct(wav_bytes)
        samples = torch.from_numpy(padded).to(self.device)[None]
        wav = self._reconstruct_wav(samples)[0].cpu().numpy()
        return self._encode_wav_bytes(wav[: min(n_data, len(wav))])

    def _reconstruct_full_mel(self, wav_bytes: bytes) -> torch.Tensor:
        """Window -> reconstruct -> stitch along time -> trim to the true
        frame count: the (n_mels, t) mel every vocoder-backed endpoint
        synthesizes from."""
        windows, t, n_win = self._wav_to_mel(wav_bytes)
        mels = self._reconstruct(windows)[:n_win, ..., 0]  # (n_win, n_mels, frames)
        return torch.cat(list(mels), dim=-1)[:, :t]

    @torch.inference_mode()
    def reconstruct_batched(self, requests: list) -> list:
        """One batch for many /reconstruct requests: group the padded inputs
        by length bucket, run each group (zero-padded to a power-of-two
        batch), and trim each request's waveform.

        Returns one ``bytes`` result or ``Exception`` per request, index
        aligned: a malformed upload fails alone, never its batchmates."""
        slots: list = [None] * len(requests)
        groups: dict = {}
        for i, wb in enumerate(requests):
            try:
                padded, n_data = self._pad_for_reconstruct(wb)
                groups.setdefault(len(padded), []).append((i, padded, n_data))
            except Exception as e:  # noqa: BLE001 — isolate per request
                slots[i] = e
        for total, items in groups.items():
            b_pad = 1 << (len(items) - 1).bit_length()
            stacked = np.zeros((b_pad, total), np.float32)
            for j, (_, padded, _) in enumerate(items):
                stacked[j] = padded
            try:
                samples = torch.from_numpy(stacked).to(self.device)
                wavs = self._reconstruct_wav(samples).cpu().numpy()
                for j, (i, _, n_data) in enumerate(items):
                    wav = wavs[j][: min(n_data, wavs.shape[1])]
                    slots[i] = self._encode_wav_bytes(wav)
            except Exception as e:  # noqa: BLE001
                for i, _, _ in items:
                    slots[i] = e
        return slots

    def attach_prior(self, prior, bottom=None) -> None:
        """Enable POST /sample with a trained prior over this model's code
        grids (moved to the service's device, eval mode); the hierarchy
        needs its spatially conditioned ``bottom`` prior too."""
        if self.hier and bottom is None:
            raise ValueError("hiervqvae sampling needs top AND bottom priors")
        self.prior = prior.to(self.device).eval()
        self.bottom_prior = None if bottom is None else bottom.to(self.device).eval()

    def _sample_mels(self, payload: dict):
        """Validate a /sample payload, run the prior and decode the code
        grids: (mels (n, n_mels, frames), the generator that drew them,
        which goes on to draw Griffin-Lim's phase)."""
        if self.prior is None:
            raise ValueError("no prior loaded on this server (start with --prior-ckpt)")
        if not isinstance(payload, dict):
            raise ValueError("payload must be a JSON object")
        n = int(payload.get("n", 1))
        if not 1 <= n <= 16:
            raise ValueError(f"n must be in [1, 16], got {n}")
        label = int(payload.get("label", 0))
        n_classes = int(self.prior.n_classes)
        if not 0 <= label < n_classes:
            raise ValueError(f"label must be in [0, {n_classes}), got {label}")
        n_speakers = self.model.n_speakers if self.speakered else 0
        if n_speakers > 0 and label >= n_speakers:
            # a multispeaker decoder takes the label as the speaker id
            raise ValueError(
                f"label is the speaker id for this multispeaker model: must be in "
                f"[0, {n_speakers}), got {label}")
        seed = int(payload.get("seed", 0))
        generator = torch.Generator(device=self.device).manual_seed(seed)
        labels = torch.full((n,), label, dtype=torch.int32, device=self.device)
        if self.hier:
            top = 2 * self.STRIDE
            _, _, mels = sample_hier_mels(
                self.model, self.prior, self.bottom_prior, labels,
                (self.cfg.audio.num_mels // top, self.frames // top), generator)
            return mels, generator
        code_shape = (self.cfg.audio.num_mels // self.STRIDE, self.frames // self.STRIDE)
        _, mels = sample_prior_mels(
            self.model, self.prior, labels, code_shape, generator,
            g=labels if n_speakers > 0 else None)
        return mels, generator

    @torch.inference_mode()
    def sample(self, payload: dict) -> bytes:
        """Ancestral sampling as a service: prior -> decoder -> Griffin-Lim
        or the WaveNet (utterance i from seed + i) -> one wav of the n
        samples concatenated in time."""
        mels, generator = self._sample_mels(payload)
        if self.vocoder is None:
            wavs = dsp.inv_mel_spectrogram_batch(mels, self.cfg.audio, generator)
            return self._encode_wav_bytes(wavs.reshape(-1).cpu().numpy())
        seed = int(payload.get("seed", 0))
        if self._stream_mux is not None:
            opens = self._mux_open_all(mels, seed)
            try:
                wavs = [np.concatenate([self._post_np(c) for c in g]) for g in opens]
            finally:
                for g in opens:
                    g.close()  # cancels any session left running
        else:
            wavs = [self._synthesize(m, seed + i) for i, m in enumerate(mels)]
        return self._encode_wav_bytes(np.concatenate(wavs))

    def enable_batching(self, window_ms: float, max_batch: int = 8):
        """Attach a request micro-batcher to /reconstruct."""
        self.batcher = _MicroBatcher(self.reconstruct_batched, window_ms, max_batch)

    def attach_vocoder(self, vocoder) -> None:
        """Synthesize /reconstruct, /decode and /sample through a WaveNet
        vocoder (moved to the service's device, eval mode) and enable the
        streaming endpoints."""
        self.vocoder = vocoder.to(self.device).eval()
        _, _, self._stream = make_chunked_generate_fn(
            self.vocoder, self.STREAM_CHUNK, dtype=torch.bfloat16)

    def enable_stream_mux(self, slots: int, max_seconds: float = 30.0, max_pending=None):
        """Route WaveNet synthesis through a stream multiplexer: up to
        ``slots`` concurrent sessions generate as one batch
        (--stream-slots). ``max_pending`` bounds the admission queue; an
        overloaded mux raises MuxOverloaded, answered with 503."""
        if self.vocoder is None:
            raise ValueError("--stream-slots requires --vocoder wavenet")
        self._stream_mux = WaveNetStreamMux(
            self.vocoder, chunk=self.STREAM_CHUNK, slots=slots, dtype=torch.bfloat16,
            max_seconds=max_seconds, sample_rate=self.cfg.audio.sample_rate,
            max_pending=max_pending)

    @staticmethod
    def _pcm_s16le(chunk: np.ndarray) -> bytes:
        """The fixed-scaling s16le conversion of both streaming endpoints
        (x in [-1, 1] -> x * 32767: a stream cannot know its future peak)."""
        return (np.clip(chunk, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()

    def _mux_open_all(self, mels: torch.Tensor, seed: int) -> list:
        """One mux session per mel (seed + i), opened up front so that the
        n utterances synthesize concurrently. If a later open fails
        (MuxOverloaded), the sessions already admitted are closed."""
        opens: list = []
        try:
            for i, m in enumerate(mels):
                opens.append(self._stream_mux.open(m.T, seed + i))
            return opens
        except BaseException:
            for g in opens:
                g.close()
            raise

    @torch.inference_mode()
    def reconstruct_stream(self, wav_bytes: bytes):
        """Streaming /reconstruct: raw s16le PCM pieces as the WaveNet
        emits them, one chunk at a time."""
        if self.vocoder is None:
            raise ValueError("streaming reconstruct requires --vocoder wavenet")
        for chunk in self._vocode_stream(self._reconstruct_full_mel(wav_bytes)):
            yield self._pcm_s16le(chunk)

    @torch.inference_mode()
    def sample_stream(self, payload: dict):
        """Streaming /sample: the prior -> decoder -> WaveNet chain as raw
        s16le PCM pieces, the n utterances back to back in order; the first
        piece comes after the prior, the decoder and one vocoder chunk."""
        if self.vocoder is None:
            raise ValueError("streaming sample requires --vocoder wavenet")
        mels, _ = self._sample_mels(payload)
        seed = int(payload.get("seed", 0))
        if self._stream_mux is not None:
            opens = self._mux_open_all(mels, seed)
            try:
                for g in opens:  # in order, so the client hears sample 0 first
                    for chunk in g:
                        yield self._pcm_s16le(self._post_np(chunk))
            finally:
                # a client gone mid-stream leaves no session synthesizing
                for g in opens:
                    g.close()
        else:
            for i, m in enumerate(mels):
                for chunk in self._vocode_stream(m, seed + i):
                    yield self._pcm_s16le(chunk)

    def _code_grid(self, payload: dict, key: str, stride: int, limit: int) -> torch.Tensor:
        """A (num_mels / stride, cols) grid of codes in [0, limit) from the
        payload, as a (1, H', cols) tensor on the device."""
        idx_np = np.asarray(payload[key], np.int64)
        height = self.cfg.audio.num_mels // stride
        if idx_np.ndim != 2 or idx_np.shape[0] != height or idx_np.shape[1] < 1:
            raise ValueError(
                f"{key} must be a ({height}, cols) grid, got shape {idx_np.shape}"
            )
        self._check_codes(idx_np, limit, key)
        return torch.from_numpy(idx_np).to(self.device)[None]

    @torch.inference_mode()
    def decode(self, payload: dict) -> bytes:
        if self.hier:
            idx_t = self._code_grid(payload, "codes_top", 2 * self.STRIDE, self.model.k_top)
            idx_b = self._code_grid(payload, "codes_bottom", self.STRIDE, self.model.z_dim)
            if 2 * idx_t.shape[-1] != idx_b.shape[-1]:
                raise ValueError(
                    "codes_bottom must be exactly twice as wide as codes_top, got "
                    f"{idx_b.shape[-1]} vs {idx_t.shape[-1]}")
            mel = self.model.decode(idx_t, idx_b)[0, :, :, 0]
        else:
            idx = self._code_grid(payload, "codes", self.STRIDE, self.model.z_dim)
            mel = self.model.decode(idx, g=self._g(1))[0, :, :, 0]
        return self._encode_wav_bytes(self._synthesize(mel))


def make_handler(service: InferenceService):
    backend = service.device.type

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _observe(self, ok: bool) -> None:
            """Count a POST in /metrics once, before its response can reach
            the client, so a client that reads /metrics next sees it."""
            if getattr(self, "_t0", None) is not None:
                service.metrics.observe(self.path, time.perf_counter() - self._t0, ok)
                self._t0 = None

        def _send(self, code, body: bytes, ctype="application/json", headers=()):
            self._observe(200 <= code < 300)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_pcm_stream(self, gen):
            """The chunked raw-PCM response of both streaming endpoints. The
            first piece is pulled before any header goes out, so a
            validation error still gets a clean 400; after the headers a
            failure can only drop the connection (``_streaming_started``)."""
            try:
                first = next(gen, b"")
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Sample-Rate", str(service.cfg.audio.sample_rate))
                self.send_header("X-PCM-Format", "s16le")
                self.end_headers()
                self._streaming_started = True
                for piece in itertools.chain([first], gen):
                    if piece:
                        self.wfile.write(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            finally:
                gen.close()  # releases an abandoned upstream (mux sessions)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, json.dumps(
                    {"status": "ok", "backend": backend}
                ).encode())
            elif self.path == "/metrics":
                snap = service.metrics.snapshot()
                snap["backend"] = backend
                mux = service._stream_mux
                if mux is not None:
                    snap["stream_mux"] = {"slots": mux.slots, "active": mux.active,
                                          "pending": mux.pending,
                                          "max_pending": mux.max_pending}
                self._send(200, json.dumps(snap).encode())
            else:
                self._send(404, b'{"error": "not found"}')

        # malformed input from the client: safe to describe in the response
        _CLIENT_ERRORS = (ValueError, KeyError, TypeError, OverflowError)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            self._streaming_started = False
            self._t0 = time.perf_counter()
            ok = False
            try:
                ok = self._dispatch(body)
            finally:
                # streamed responses (and dropped connections) count here
                self._observe(ok)

        def _dispatch(self, body) -> bool:
            """Route one POST; True when the request was served (2xx)."""
            try:
                if self.path == "/encode":
                    self._send(200, json.dumps(service.encode(body)).encode())
                elif self.path == "/reconstruct":
                    self._send(200, service.reconstruct(body), "audio/wav")
                elif self.path == "/decode":
                    self._send(200, service.decode(json.loads(body)), "audio/wav")
                elif self.path == "/sample":
                    payload = json.loads(body) if body else {}
                    self._send(200, service.sample(payload), "audio/wav")
                elif self.path == "/reconstruct_stream":
                    self._send_pcm_stream(service.reconstruct_stream(body))
                elif self.path == "/sample_stream":
                    payload = json.loads(body) if body else {}
                    self._send_pcm_stream(service.sample_stream(payload))
                else:
                    self._send(404, b'{"error": "not found"}')
                    return False
                return True
            except MuxOverloaded:
                if self._streaming_started:
                    self.close_connection = True
                    return False
                # retryable, not a client error: 503 tells the client to back off
                self._send(503, json.dumps(
                    {"error": "stream slots exhausted; retry later"}).encode(),
                    headers=(("Retry-After", "1"),))
                return False
            except self._CLIENT_ERRORS as e:
                if self._streaming_started:
                    # the chunked headers are out: a status line would land
                    # inside the body, so the only signal is a dropped
                    # connection (a truncated, unterminated stream)
                    logging.getLogger("nsg.serve").warning(
                        "mid-stream client error on %s: %s", self.path, e)
                    self.close_connection = True
                    return False
                self._send(400, json.dumps(
                    {"error": f"bad request: {type(e).__name__}: {e}"}
                ).encode())
                return False
            except Exception:
                # log the traceback under an opaque id; never echo internals
                err_id = uuid.uuid4().hex[:12]
                logging.getLogger("nsg.serve").exception(
                    "internal error %s on %s", err_id, self.path
                )
                if self._streaming_started:
                    self.close_connection = True
                    return False
                self._send(500, json.dumps(
                    {"error": "internal error", "id": err_id}
                ).encode())
                return False

    return Handler


def build_service(args) -> InferenceService:
    cfg = load_preset(args.preset, Config()) if args.preset else Config()
    # serving defaults: fast Griffin-Lim (momentum 0.99 at 30 iterations)
    # when no preset is given; explicit flags win; a preset's settings are
    # kept when the flags are not passed
    gl_iters, gl_momentum = args.gl_iters, args.gl_momentum
    if not args.preset:
        gl_iters = 30 if gl_iters is None else gl_iters
        gl_momentum = 0.99 if gl_momentum is None else gl_momentum
    audio = {}
    if gl_iters is not None:
        audio["griffin_lim_iters"] = gl_iters
    if gl_momentum is not None:
        audio["griffin_lim_momentum"] = gl_momentum
    cfg = dataclasses.replace(cfg, audio=dataclasses.replace(cfg.audio, **audio))

    gin = cfg.arch.gin_channels
    frames = resolve_frames(args)
    if getattr(args, "model", "vqvae") == "hiervqvae":
        model = hier_model(args, cfg, frames)
        n_speakers, sid = 0, None
    else:
        # a multispeaker preset (gin_channels > 0) serves the
        # speaker-conditioned model, with --speaker-id as the voice of
        # /reconstruct and /decode
        n_speakers = cfg.arch.n_speakers if gin > 0 else 0
        sid = args.speaker_id
        model = VQVAE(
            input_dim=1, dim=args.dim, z_dim=args.z_dim, n_speakers=n_speakers,
            gin_channels=gin if n_speakers else -1,
            generator=torch.Generator().manual_seed(0),
        )
    if n_speakers and sid is None:
        raise SystemExit(
            f"this preset serves a speaker-conditioned model (gin_channels "
            f"{gin}): pass --speaker-id 0..{n_speakers - 1}"
        )
    if n_speakers and not 0 <= int(sid) < n_speakers:
        raise SystemExit(
            f"--speaker-id {sid} out of range: this model has {n_speakers} "
            f"speakers (0..{n_speakers - 1})"
        )
    ckpt_dir, ema = getattr(args, "ckpt_dir", None), getattr(args, "ema", False)
    if ckpt_dir:
        restore_weights(model, cfg, ckpt_dir, ema)
    elif ema:
        raise SystemExit("--ema needs --ckpt-dir")
    service = InferenceService(
        cfg, model, frames, device=args.device, default_speaker=sid
    )
    bottom = [f"--{flag.replace('_', '-')}" for flag in BOTTOM_FLAGS
              if getattr(args, flag, None) is not None]
    if bottom and (getattr(args, "model", "vqvae") != "hiervqvae" or not args.prior_ckpt):
        raise SystemExit(f"{' '.join(bottom)}: the bottom prior serves --model hiervqvae "
                         f"/sample beside its top prior (--prior-ckpt)")
    if getattr(args, "prior_ckpt", None):
        service.attach_prior(*load_serving_priors(args, service.device))
    if getattr(args, "vocoder", "griffin-lim") == "wavenet":
        service.attach_vocoder(load_serving_vocoder(args, cfg, service.device))
    if args.batch_window_ms > 0:
        service.enable_batching(args.batch_window_ms, args.batch_max)
    if getattr(args, "stream_slots", 0) > 0:
        try:
            service.enable_stream_mux(args.stream_slots, args.stream_max_seconds,
                                      max_pending=args.stream_max_pending)
        except ValueError as e:
            raise SystemExit(str(e)) from e
    return service


def resolve_frames(args) -> int:
    """``--frames``, or its default: 80 for the hierarchy, 84 otherwise."""
    if getattr(args, "frames", None) is not None:
        return args.frames
    return 80 if getattr(args, "model", "vqvae") == "hiervqvae" else 84


def hier_model(args, cfg: Config, frames: int) -> HierVQVAE:
    """The ``--model hiervqvae`` template (seeded weights): refuses a window
    that is not a multiple of 8 and a speaker-conditioned preset (the
    hierarchy has no speaker embedding)."""
    if frames % 8:
        raise SystemExit(
            f"--frames must be a multiple of 8 for hiervqvae (got {frames}); "
            f"try {frames - frames % 8}")
    if cfg.arch.gin_channels > 0:
        raise SystemExit(
            "--model hiervqvae does not support speaker-conditioned presets "
            f"(gin_channels {cfg.arch.gin_channels}): serve the multispeaker checkpoint "
            "with the flat model, or drop the preset's gin_channels")
    return HierVQVAE(input_dim=1, dim=args.dim, z_dim=args.z_dim,
                     generator=torch.Generator().manual_seed(0))


#: the hierarchy's bottom-prior flags
BOTTOM_FLAGS = ("bottom_ckpt", "bottom_prior_arch", "bottom_prior_dim", "bottom_prior_layers",
                "bottom_prior_heads")


def load_serving_priors(args, device):
    """(top or flat prior, the hierarchy's bottom prior or None) from
    ``--prior-ckpt`` and ``--bottom-ckpt``, each refused unless its recorded
    family, widths and conditioning match the flags: ``--prior-*`` for the
    first, ``--bottom-prior-*`` (each defaulting to its ``--prior-*``) for
    the bottom, conditioned on the hierarchy's ``--dim``-wide codebook;
    ``--prior-moe-experts`` routes every transformer level, as in JAX."""
    from neural_sound_generation_tpu_torch.cli.prior import PriorSpec, load_prior

    def spec(arch, dim, layers, heads, cond_dim=0):
        return PriorSpec.create(arch, args.z_dim, dim, layers, heads, args.n_classes, cond_dim,
                                args.prior_moe_experts)

    hier = args.model == "hiervqvae"
    if hier and not args.bottom_ckpt:
        raise SystemExit("--model hiervqvae /sample needs --bottom-ckpt too")
    top = load_prior(args.prior_ckpt, spec(args.prior_arch, args.prior_dim, args.prior_layers,
                                           args.prior_heads), device)
    if not hier:
        return top, None
    bottom = load_prior(args.bottom_ckpt, spec(
        args.bottom_prior_arch or args.prior_arch, args.bottom_prior_dim or args.prior_dim,
        args.bottom_prior_layers or args.prior_layers,
        args.bottom_prior_heads or args.prior_heads, cond_dim=args.dim), device)
    return top, bottom


def load_serving_vocoder(args, cfg: Config, device):
    """The ``--vocoder-ckpt`` WaveNet at ``--vocoder-*`` widths over the
    preset's arch, in eval mode on ``device``. Serve synthesizes from mels,
    so a checkpoint recorded with another conditioning chain is refused."""
    if not args.vocoder_ckpt:
        raise SystemExit("--vocoder wavenet requires --vocoder-ckpt")
    meta = checkpoint.read_extra(args.vocoder_ckpt) or {}
    if meta.get("condition", "mel") != "mel":
        raise SystemExit(
            f"--vocoder-ckpt was trained with --condition {meta['condition']}; serve "
            f"synthesizes from mels — use a mel-conditioned vocoder checkpoint")
    model = cli_vocoder.build_model(cfg, types.SimpleNamespace(
        residual_channels=args.vocoder_residual_channels, layers=args.vocoder_layers,
        stacks=args.vocoder_stacks))
    return cli_vocoder.load_vocoder(args.vocoder_ckpt, model, device)


def restore_weights(model: VQVAE | HierVQVAE, cfg: Config, ckpt_dir: str, ema: bool) -> None:
    """Load a ``cli.main`` checkpoint into ``model`` (on the CPU, before
    the service moves it): the live parameters, or the EMA shadow with
    ``ema``, and the BatchNorm running statistics. Refuses a checkpoint of
    another architecture or shape, and ``ema`` on one without a shadow."""
    try:
        arch = "hiervqvae" if isinstance(model, HierVQVAE) else "vqvae"
        checkpoint.check_extra(ckpt_dir, arch=arch, num_quantizers=1)
        state, _ = checkpoint.restore(ckpt_dir, create_train_state(model, cfg.train))
    except ValueError as e:
        raise SystemExit(str(e)) from e
    if ema:
        if state.ema_params is None:
            raise SystemExit(
                "--ema: checkpoint has no EMA shadow (trained with "
                "exponential_moving_average=false); drop --ema or retrain with EMA on"
            )
        state.flat.flat.copy_(state.ema_params)
    model.zero_grad(set_to_none=True)  # serving keeps no gradient buffer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="VQ-VAE inference HTTP server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--ckpt-dir", default=None,
                   help="serve this cli.main checkpoint directory (latest step)")
    p.add_argument("--ema", action="store_true",
                   help="serve the averaged (EMA) weights of --ckpt-dir instead "
                        "of the live parameters")
    p.add_argument("--preset", default=None)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--z-dim", type=int, default=512)
    p.add_argument("--frames", type=int, default=None,
                   help="serving mel window in frames (default 84 flat, 80 hier)")
    p.add_argument("--model", default="vqvae", choices=["vqvae", "hiervqvae"])
    p.add_argument("--gl-iters", type=int, default=None,
                   help="Griffin-Lim iterations (default: the --preset "
                        "value, or 30 with momentum when no preset is "
                        "given; reference setting: 60 with momentum 0)")
    p.add_argument("--gl-momentum", type=float, default=None,
                   help="fast Griffin-Lim momentum; 0 = plain reference "
                        "GL (default: preset value, or 0.99 w/o preset)")
    p.add_argument("--batch-window-ms", type=float, default=0.0,
                   help="coalesce concurrent /reconstruct requests arriving "
                        "within this window into one batch (0 = off)")
    p.add_argument("--batch-max", type=int, default=8,
                   help="max requests per coalesced batch")
    p.add_argument("--speaker-id", type=int, default=None,
                   help="default speaker for /reconstruct and /decode when "
                        "serving a speaker-conditioned (multispeaker-preset) "
                        "model")
    p.add_argument("--prior-ckpt", default=None,
                   help="cli.prior checkpoint directory: enables POST /sample")
    p.add_argument("--prior-arch", choices=["pixelcnn", "transformer"], default="pixelcnn",
                   help="prior family the --prior-ckpt was trained with (cli.prior --arch)")
    p.add_argument("--prior-dim", type=int, default=64)
    p.add_argument("--prior-layers", type=int, default=15)
    p.add_argument("--prior-heads", type=int, default=8)
    p.add_argument("--prior-moe-experts", type=int, default=0,
                   help="transformer prior trained with --moe-experts N (0 = dense); "
                        "applies to the bottom level too")
    p.add_argument("--n-classes", type=int, default=10)
    p.add_argument("--bottom-ckpt", default=None,
                   help="spatially conditioned bottom prior checkpoint (hiervqvae /sample; "
                        "cli.prior train --hier --hier-level bottom)")
    p.add_argument("--bottom-prior-arch", choices=["pixelcnn", "transformer"], default=None)
    p.add_argument("--bottom-prior-dim", type=int, default=None)
    p.add_argument("--bottom-prior-layers", type=int, default=None)
    p.add_argument("--bottom-prior-heads", type=int, default=None)
    p.add_argument("--vocoder", choices=["griffin-lim", "wavenet"], default="griffin-lim",
                   help="synthesis backend for /reconstruct, /decode and /sample: "
                        "Griffin-Lim, or a WaveNet vocoder artifact (--vocoder-ckpt) "
                        "through the scan sampler in chunks of 4096 samples")
    p.add_argument("--vocoder-ckpt", default=None,
                   help="WaveNet vocoder checkpoint directory (a cli.vocoder artifact)")
    p.add_argument("--vocoder-layers", type=int, default=None)
    p.add_argument("--vocoder-stacks", type=int, default=None)
    p.add_argument("--vocoder-residual-channels", type=int, default=None)
    p.add_argument("--stream-slots", type=int, default=0,
                   help="multiplex WaveNet synthesis: up to N concurrent streams step "
                        "as one batch (0 = one sampler per request); needs "
                        "--vocoder wavenet")
    p.add_argument("--stream-max-seconds", type=float, default=30.0,
                   help="per-utterance cap of the stream multiplexer (slot capacity)")
    p.add_argument("--stream-max-pending", type=int, default=None,
                   help="admission control: answer 503 to new streams once this many "
                        "sessions wait for a slot (default: unbounded)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    args.frames = resolve_frames(args)
    return args


def main(argv=None):
    args = parse_args(argv)
    service = build_service(args)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"serving on http://{args.host}:{args.port} (device={service.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()

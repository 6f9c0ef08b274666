"""Batched corpus preprocessing: host threads decode, the device transforms.

Counterpart of ``neural_sound_generation_tpu/data/corpora/engine.py``. Host
threads decode WAVs; the host rescales, trims and pads each ragged
utterance; the shift-invariant rest of the chain (the input-type encoding,
STFT, mel, dB, normalization) runs as one batched torch call per length
bucket on ``device``, with utterances zero-filled to a few quantized
lengths.

Per-utterance outputs follow the reference artifact contract
(src/ljspeech.py:61-102): ``<name>-audio-%05d.npy`` (waveform, aligned and
truncated to n_frames*hop), ``<name>-mel-%05d.npy`` (time-major float32
mel), and a train.txt manifest entry. Everything on the host is the JAX
engine's numpy arithmetic, so the shards match it bit for bit where the
device arithmetic does.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from neural_sound_generation_tpu_torch.config import AudioConfig
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.ops.lws import lws_stft_prepadded


def convention(cfg: AudioConfig) -> AudioConfig:
    """The wavenet-variant DSP convention for cmu_arctic/jsut/librivox.

    The reference binds these corpora to ``src/audio.py`` unconditionally:
    LWS-mode STFT (audio.py:112-127) and NO preemphasis stage —
    audio.py's ``melspectrogram`` (94-101) transforms the raw signal, and
    the wavenet ``hparams.py`` defines no preemphasis key at all. (Only
    the tacotron variant used by ljspeech preemphasizes,
    audio_tacotron.py:70-72.) Applied over any caller/preset config so
    the convention is corpus-bound exactly as in the reference."""
    return dataclasses.replace(cfg, use_lws=True, preemphasize=False)


@dataclasses.dataclass
class UtteranceSpec:
    """One utterance to preprocess. ``wav_path`` is loaded lazily on a host
    IO thread; ``loader`` may override for non-file sources (e.g. chunked
    long-form audio)."""

    utt_id: str
    text: str
    wav_path: Optional[str] = None
    speaker_id: Optional[int] = None
    loader: Optional[Callable[[], np.ndarray]] = None
    trim_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None

    def load(self, sample_rate: int) -> np.ndarray:
        if self.loader is not None:
            wav = self.loader()
        else:
            wav = dsp.load_wav(self.wav_path, sample_rate)
        if self.trim_fn is not None:
            wav = self.trim_fn(wav)
        return wav


def _batch_transform(wavs: torch.Tensor, prepped: torch.Tensor, cfg: AudioConfig):
    """Device half of the chain, over a whole bucket at once.

    ``wavs``: (B, L) rescaled waveforms, zero-filled to the bucket length;
    feeds the (position-independent) input-type encoding.
    ``prepped``: (B, L + extra) waveforms already rescaled, preemphasized
    and padded for the convention on the host (those steps are
    shift-variant: zero-fill before them would corrupt the boundary
    frames); feeds the framed STFT with no padding of its own.
    Returns (mels (B, n_frames, num_mels), outs (B, L)).
    """
    if cfg.is_mulaw_quantize:
        outs = dsp.mulaw_quantize(wavs, cfg.quantize_channels)
    elif cfg.is_mulaw:
        outs = dsp.mulaw(wavs, cfg.quantize_channels)
    else:
        outs = wavs
    hop = cfg.effective_hop_size
    if cfg.use_lws:
        D = lws_stft_prepadded(prepped, cfg.fft_size, hop)
    else:
        D = dsp.stft(prepped, cfg.fft_size, hop, cfg.effective_win_size, center=False)
    basis, _ = dsp._mels(cfg, prepped.device)
    S = dsp.amp_to_db(torch.abs(D) @ basis.T, cfg.min_level_db) - cfg.ref_level_db
    if cfg.signal_normalization:
        S = dsp.normalize_spectrogram(S, cfg)
    return S, outs


def _quantize_length(n: int, quantum: int) -> int:
    return ((n + quantum - 1) // quantum) * quantum


def preprocess_utterances(
    specs: Sequence[UtteranceSpec],
    out_dir: str,
    cfg: AudioConfig,
    name: str = "corpus",
    num_workers: int = 8,
    device_batch: int = 16,
    length_quantum: int = 32768,
    skip_errors: bool = False,
    chunk_size: int = 1024,
    tqdm=lambda x, **kw: x,
    device: str | torch.device | None = None,
) -> List[ManifestEntry]:
    """Run the full preprocessing pipeline; returns manifest entries in the
    original ``specs`` order (index numbering starts at 1, matching the
    reference's %05d scheme, src/ljspeech.py:92-93).

    ``skip_errors``: drop utterances whose decode fails (corrupt/short
    files) with a warning instead of aborting the whole run.

    Corpora are processed in chunks of ``chunk_size`` utterances so host
    memory stays bounded (full LJSpeech would otherwise hold ~8 GB of
    decoded audio at once). ``device``: where the batch transform runs
    (``None``: the CUDA card, see ``device.resolve_device``).
    """
    device = resolve_device(device)
    if len(specs) > chunk_size:
        entries: List[ManifestEntry] = []
        for start in range(0, len(specs), chunk_size):
            entries.extend(
                _preprocess_chunk(
                    specs[start : start + chunk_size], out_dir, cfg, name,
                    num_workers, device_batch, length_quantum, skip_errors,
                    tqdm, index_offset=start, device=device,
                )
            )
        return entries
    return _preprocess_chunk(
        specs, out_dir, cfg, name, num_workers, device_batch,
        length_quantum, skip_errors, tqdm, index_offset=0, device=device,
    )


def _preprocess_chunk(
    specs,
    out_dir: str,
    cfg: AudioConfig,
    name: str,
    num_workers: int,
    device_batch: int,
    length_quantum: int,
    skip_errors: bool,
    tqdm,
    index_offset: int,
    device: torch.device,
) -> List[ManifestEntry]:
    os.makedirs(out_dir, exist_ok=True)
    sr = cfg.sample_rate
    hop = cfg.effective_hop_size

    # 1. host-parallel decode
    def safe_load(s):
        try:
            wav = s.load(sr)
            if len(wav) < hop:
                raise ValueError(f"too short ({len(wav)} samples)")
            return wav
        except Exception as e:
            if not skip_errors:
                raise
            print(f"[preprocess] skipping {s.utt_id}: {e}")
            return None

    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        wavs = list(tqdm(pool.map(safe_load, specs), total=len(specs)))
    if skip_errors:
        keep = [i for i, w in enumerate(wavs) if w is not None]
        specs = [specs[i] for i in keep]
        wavs = [wavs[i] for i in keep]

    # 2. rescale to peak (reference order: rescale happens before the
    #    mulaw-quantize silence trim, src/ljspeech.py:34-47)
    if cfg.rescaling:
        wavs = [
            (w / max(np.abs(w).max(), 1e-8) * cfg.rescaling_max).astype(np.float32)
            for w in wavs
        ]

    #    silence handling for mulaw-quantize inputs (ljspeech.py:40-49):
    #    quantize first, trim against the mu-law midpoint, derived as
    #    (Q-1)//2 (the reference's hard-coded 127 at Q=256) so that the
    #    65536-channel configuration trims too. The quantization runs on the
    #    host CPU, whatever ``device`` is: the cut decides every shard's
    #    length, and a one-ulp difference of the card's log1p at a loud
    #    sample's edge would shift it.
    if cfg.is_mulaw_quantize:
        midpoint = (cfg.quantize_channels - 1) // 2
        trimmed = []
        for wav in wavs:
            q = dsp.mulaw_quantize(torch.from_numpy(wav), cfg.quantize_channels).numpy()
            loud = np.abs(q.astype(np.int64) - midpoint) > cfg.silence_threshold
            nz = np.flatnonzero(loud)
            if len(nz):
                wav = wav[nz[0] : nz[-1] + 1]
            trimmed.append(wav)
        wavs = trimmed

    # 3. host-side shift-variant prep: preemphasis, then the convention's
    # analysis padding — librosa center (reflect fft//2) by default, or
    # the exact per-utterance LWS zero pads (audio.py:130-140) when
    # cfg.use_lws. prep_extra sizes the device batch so every prepped
    # utterance fits (LWS right pad < fft_size).
    half = cfg.fft_size // 2
    prep_extra = 2 * half if not cfg.use_lws else 2 * cfg.fft_size - hop

    def prep(w: np.ndarray) -> np.ndarray:
        if cfg.preemphasize:
            w = np.concatenate([w[:1], w[1:] - cfg.preemphasis * w[:-1]])
        if cfg.use_lws:
            l, r = dsp.lws_pad_lr(len(w), cfg.fft_size, hop)
            return np.pad(w, (l, r)).astype(np.float32)
        return np.pad(w, (half, half), mode="reflect").astype(np.float32)

    prepped = [prep(w) for w in wavs]

    # the pad value of the aligned waveform (the input encoding of 0) and
    # its dtype, which must hold [0, quantize_channels): int16 wraps at
    # 32768 with the default 65536-channel configuration
    zero = torch.zeros(())
    if cfg.is_mulaw_quantize:
        pad_value = int(dsp.mulaw_quantize(zero, cfg.quantize_channels))
        out_dtype = np.int16 if cfg.quantize_channels <= 32768 else np.int32
    else:
        pad_value = float(dsp.mulaw(zero, cfg.quantize_channels)) if cfg.is_mulaw else 0.0
        out_dtype = np.float32

    # 4. bucket by quantized length, run the device batch transform
    order = np.argsort([len(w) for w in wavs], kind="stable")
    results: List[Optional[ManifestEntry]] = [None] * len(specs)

    def flush(batch_ids: List[int], pad_len: int):
        batch = np.zeros((len(batch_ids), pad_len), np.float32)
        batch_p = np.zeros((len(batch_ids), pad_len + prep_extra), np.float32)
        for row, i in enumerate(batch_ids):
            batch[row, : len(wavs[i])] = wavs[i]
            batch_p[row, : len(prepped[i])] = prepped[i]
        with torch.inference_mode():
            mels, outs = _batch_transform(
                torch.from_numpy(batch).to(device), torch.from_numpy(batch_p).to(device), cfg)
            mels, outs = mels.cpu().numpy(), outs.cpu().numpy()
        for row, i in enumerate(batch_ids):
            true_len = len(wavs[i])
            # frame count + audio/mel alignment pads under the configured
            # convention (ljspeech.py:66-82; lws math audio.py:119-140)
            if cfg.use_lws:
                n_frames = dsp.lws_num_frames(true_len, cfg.fft_size, hop)
                l, r = dsp.lws_pad_lr(true_len, cfg.fft_size, hop)
            else:
                n_frames = dsp.num_stft_frames(true_len, cfg.fft_size, hop)
                l, r = dsp.librosa_pad_lr(true_len, cfg.fft_size, hop)
            mel = mels[row, :n_frames].astype(np.float32)
            out = np.pad(
                outs[row, :true_len],
                (l, r),
                mode="constant",
                constant_values=pad_value,
            )
            if len(out) < n_frames * hop:
                raise RuntimeError(
                    f"{specs[i].utt_id}: {len(out)} aligned samples for {n_frames} frames")
            out = out[: n_frames * hop]

            idx1 = index_offset + i + 1
            audio_filename = f"{name}-audio-{idx1:05d}.npy"
            mel_filename = f"{name}-mel-{idx1:05d}.npy"
            np.save(
                os.path.join(out_dir, audio_filename),
                out.astype(out_dtype),
                allow_pickle=False,
            )
            np.save(os.path.join(out_dir, mel_filename), mel, allow_pickle=False)
            results[i] = ManifestEntry(
                audio_path=audio_filename,
                mel_path=mel_filename,
                timesteps=len(out),
                text=specs[i].text,
                speaker_id=specs[i].speaker_id,
            )

    pending: List[int] = []
    pending_len = 0
    for i in order.tolist():
        q = _quantize_length(max(len(wavs[i]), hop * 4), length_quantum)
        if pending and (q != pending_len or len(pending) == device_batch):
            flush(pending, pending_len)
            pending = []
        pending.append(i)
        pending_len = q
    if pending:
        flush(pending, pending_len)

    return results

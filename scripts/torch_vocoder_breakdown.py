#!/usr/bin/env python3
"""Where the time of one full-width /reconstruct_stream goes in the PyTorch
port, on a CUDA card.

Serves the mel VQ-VAE (dim 256, 512 codes, seed-0 weights, 16-frame
windows) with the CLI's default WaveNet vocoder (24 layers, R = G = 512,
S = 256, seed-0 weights) attached, and for a 0.1 s chirp (9 mel frames,
2304 samples, one 4096-step chunk):

  * times the stages of the request with the host clock around
    synchronized work: wav to stitched reconstructed mel, the upsampler,
    the noise draw, one whole chunk of the streaming sampler (bf16
    products), and the whole ``reconstruct_stream`` call;
  * times the scan sampler per step in bf16 and in float32 over
    TIMED_STEPS steps, and the host's enqueue of those steps alone;
  * traces PROFILED_STEPS steps with ``torch.profiler`` and prints the
    launches per step, the device's busy share of their wall time and the
    kernels that take the most device time.

Run from the repository root: ``python3 scripts/torch_vocoder_breakdown.py``.
Prints one JSON line per measurement; fails without a CUDA device.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TIMED_STEPS = 256
PROFILED_STEPS = 32
CHIRP_SECONDS = 0.1


def chirp_wav_bytes(seconds: float, sr: int) -> bytes:
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    f = 110.0 + (2000.0 - 110.0) * t / seconds
    buf = io.BytesIO()
    wavfile.write(buf, sr, (0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr) * 32767).astype(np.int16))
    return buf.getvalue()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from neural_sound_generation_tpu_torch.cli import serve
    from neural_sound_generation_tpu_torch.cli import vocoder as cli_vocoder
    from neural_sound_generation_tpu_torch.models import wavenet as wn

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    service = serve.build_service(serve.parse_args(["--device", "cuda", "--frames", "16"]))
    model = cli_vocoder.build_model(
        service.cfg, types.SimpleNamespace(residual_channels=None, layers=None, stacks=None),
        generator=torch.Generator().manual_seed(0))
    service.attach_vocoder(model)
    model = service.vocoder
    wav_bytes = chirp_wav_bytes(CHIRP_SECONDS, service.cfg.audio.sample_rate)
    chunk = service.STREAM_CHUNK

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    # warm-up: cuDNN algorithms, FFT plans, the allocator
    with torch.inference_mode():
        service._reconstruct_full_mel(wav_bytes)
    init_state, step_chunk, _ = wn.make_chunked_generate_fn(model, chunk, dtype=torch.bfloat16)
    with torch.inference_mode():
        mel, mel_ms = timed(lambda: service._reconstruct_full_mel(wav_bytes))
        c_up, up_ms = timed(lambda: wn._upsample_cond(model, mel.T[None]))
        gen = torch.Generator(device="cuda").manual_seed(0)
        (gum, unif), noise_ms = timed(lambda: wn.draw_noise(model, gen, chunk, 1))
        c_chunk = torch.nn.functional.pad(c_up, (0, 0, 0, chunk - c_up.shape[1]))
        _, chunk_ms = timed(lambda: step_chunk(init_state(1), c_chunk, gum, unif, None))
    pcm, request_ms = timed(lambda: b"".join(service.reconstruct_stream(wav_bytes)))
    print(json.dumps({
        "card": card, "request": "/reconstruct_stream", "seconds_audio": CHIRP_SECONDS,
        "mel_frames": int(mel.shape[-1]), "samples": len(pcm) // 2, "chunk_steps": chunk,
        "stage_ms": {"wav_to_reconstructed_mel": mel_ms, "upsampler": up_ms,
                     "noise_draw": noise_ms, "one_chunk": chunk_ms},
        "request_ms": request_ms, "ms_per_step_in_chunk": chunk_ms / chunk,
    }), flush=True)

    def dev_us(e):
        return getattr(e, "device_time_total", None) or e.cuda_time_total

    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        init_n, step_n, _ = wn.make_chunked_generate_fn(model, TIMED_STEPS, dtype=dtype)
        _, step_p, _ = wn.make_chunked_generate_fn(model, PROFILED_STEPS, dtype=dtype)
        state = init_n(1)
        args = (c_chunk[:, :TIMED_STEPS], gum[:TIMED_STEPS], unif[:TIMED_STEPS], None)
        step_n(state, *args)
        _, device_ms = timed(lambda: step_n(state, *args))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_n(state, *args)
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.synchronize()
        pargs = (c_chunk[:, :PROFILED_STEPS], gum[:PROFILED_STEPS], unif[:PROFILED_STEPS], None)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step_p(state, *pargs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        device_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(dev_us(e) for e in device_events) / 1e3
        top = sorted(device_events, key=dev_us, reverse=True)[:10]
        print(json.dumps({
            "card": card, "scan": name, "timed_steps": TIMED_STEPS,
            "ms_per_step": device_ms / TIMED_STEPS,
            "host_enqueue_ms_per_step": enqueue_ms / TIMED_STEPS,
            "profile": f"{PROFILED_STEPS} steps", "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "launches_per_step": sum(e.count for e in device_events) / PROFILED_STEPS,
            "top_device_us_per_step": {e.key[:80]: dev_us(e) / PROFILED_STEPS for e in top},
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

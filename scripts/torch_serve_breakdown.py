#!/usr/bin/env python3
"""Where the time of one /reconstruct goes in the PyTorch port, on a CUDA card.

Builds the port's mel VQ-VAE service at full width (dim 256, 512 codes,
84-frame windows, Griffin-Lim 30 iterations at momentum 0.99) with seeded
weights and, for chirps of 1 s, 3 s and 8 s:

  * times each stage of the /reconstruct chain with CUDA events (median of
    REPEATS after a warm-up): mel analysis, the VQ-VAE over the windows,
    the nearest-code kernel alone on the encoder's output, Griffin-Lim, the
    inverse preemphasis, and the whole chain;
  * times ``InferenceService.reconstruct`` (bytes in, bytes out) on the
    host clock, called on the same thread each time and on a new thread
    each time (the HTTP server gives every request a thread of its own);
  * traces one 8 s request with ``torch.profiler`` and prints the kernels
    that take the most device time and the device's busy share of the
    request's wall time.

Run from the repository root: ``python3 scripts/torch_serve_breakdown.py``.
Prints one JSON line per measurement; fails without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPEATS = 5
SECONDS = (1.0, 3.0, 8.0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import chirp_wav_bytes
    from neural_sound_generation_tpu_torch.cli import serve
    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card, flush=True)
    svc = serve.build_service(serve.parse_args(["--device", "cuda"]))
    a = svc.cfg.audio

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        out = fn()  # warm-up
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times)), out

    def host_ms(fn, arg, new_thread=False):
        """Median host time of fn(arg), each call on the calling thread or
        on a thread of its own (as the HTTP server runs every request)."""
        times = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            if new_thread:
                t = threading.Thread(target=fn, args=(arg,))
                t.start()
                t.join()
            else:
                fn(arg)
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    with torch.inference_mode():
        for seconds in SECONDS:
            wav_bytes, _ = chirp_wav_bytes(seconds, a.sample_rate)
            padded, _ = svc._pad_for_reconstruct(wav_bytes)
            samples = torch.from_numpy(padded).cuda()[None]
            win = svc.frames
            stages = {}
            stages["analysis"], mels = timed(lambda: dsp.melspectrogram(samples, a))
            n_win = mels.shape[-1] // win
            windows = (mels[..., : n_win * win].reshape(1, a.num_mels, n_win, win)
                       .permute(0, 2, 1, 3).reshape(n_win, a.num_mels, win, 1))
            stages["vqvae"], out = timed(lambda: svc._reconstruct(windows))
            z_e = svc.model._encode_latents(windows).reshape(-1, svc.model.dim).contiguous()
            stages["vq_kernel"], _ = timed(
                lambda: vq_kernel.nearest_codebook_indices(z_e, svc.model.codebook))
            full = out[..., 0].permute(1, 0, 2).reshape(1, a.num_mels, n_win * win)
            angles = svc._gl_angles(full.shape[-1])
            amp = dsp.db_to_amp(dsp.denormalize_spectrogram(full, a) + a.ref_level_db)
            _, inv_basis = dsp._mels(a, full.device)
            S = (torch.clamp(inv_basis @ amp, min=1e-10) ** a.power).transpose(-1, -2)
            stages["griffin_lim"], y = timed(lambda: dsp.griffin_lim(
                S, a, momentum=a.griffin_lim_momentum, init_angles=angles))
            stages["inv_preemphasis"], _ = timed(
                lambda: dsp.inv_preemphasis(y, a.preemphasis, a.preemphasize))
            stages["whole_chain"], _ = timed(lambda: svc._reconstruct_wav(samples))
            print(json.dumps({
                "seconds": seconds, "windows": n_win, "vq_rows": z_e.shape[0],
                "gl_frames": full.shape[-1], "device_ms": stages,
                "service_reconstruct_host_ms": host_ms(svc.reconstruct, wav_bytes),
                "service_reconstruct_new_thread_ms": host_ms(
                    svc.reconstruct, wav_bytes, new_thread=True),
            }), flush=True)

        wav_bytes, _ = chirp_wav_bytes(SECONDS[-1], a.sample_rate)
        svc.reconstruct(wav_bytes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.reconstruct(wav_bytes)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    # device kernels only: an aten op also reports its kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "device_time_total", None) or e.cuda_time_total

    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    print(json.dumps({
        "profile": f"/reconstruct {SECONDS[-1]:g} s", "wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "top_device_ms": {e.key[:80]: dev_us(e) / 1e3 for e in top},
        "top_counts": {e.key[:80]: e.count for e in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

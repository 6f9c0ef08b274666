#!/usr/bin/env python3
"""Drives the PyTorch port's serving path on one CUDA card and checks it.

Run from the root of the repository: ``python3 chip_smoke.py``. Phases:

1. device: requires CUDA and prints the card's name and power limit;
2. build: compiles every CUDA kernel of the port from ``csrc/``;
3. kernels: holds each kernel against its plain PyTorch version at the
   shapes the serving path and the flagship training step give it, and
   times kernel, plain version, one PyTorch library expression and the
   card's bound;
4. serving: builds the mel VQ-VAE service at full width (dim 256, 512
   codes, 84-frame windows) on the card with seeded weights, serves it over
   HTTP, checks every response of /health, /encode, /reconstruct and
   /decode for 1 s, 3 s and 8 s chirps (TIMED_REPEATS timed requests per
   endpoint and length after a warm-up, reported as p50 and p90) and
   bursts of concurrent batched /reconstruct requests, reads each kernel's
   launch count over the HTTP requests alone and checks it against the
   count they must launch, then checks the float waveforms are finite and
   holds the card's codes and mels against the same model on the CPU;
5. summary: one JSON line per kernel, then the result line.

Exits non-zero, printing no result, when CUDA is unavailable, when the
port is not beside this script, or when any check fails.
"""

from __future__ import annotations

import concurrent.futures
import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# Peak rates of one H100 SXM (NVIDIA data sheet): f32 outside the tensor
# cores and HBM bandwidth. The kernels below do f32 FMA on the CUDA cores.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SEED = 0
VQ_D = 256
# (N, K): serving at 1 s (2 windows x 420 latents), serving at 8 s (16
# windows), the flagship training step (vq_kernel.py:32-34), K past one
# 512-code tile, and quantize_channels scale.
VQ_SHAPES = [(840, 512), (6720, 512), (26880, 512), (1500, 1536), (8192, 65536)]
VQ_MAIN_SHAPE = (6720, 512)  # what an 8 s request gives the kernel
NEAR_TIE_REL = 1e-5
CHIRP_SECONDS = (1.0, 3.0, 8.0)
TIMED_REPEATS = 40  # timed requests per endpoint and length
BURST = 4
BURST_ROUNDS = 10


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def vq_bound_ms(n: int, k: int, d: int) -> tuple[float, str]:
    """Least time for (N, D) x (K, D) -> (N,) int32: inputs read once, the
    output written once, and the 2*N*K*D f32 FMA operations."""
    bytes_ms = 1e3 * 4 * (n * d + k * d + n) / PEAK_HBM_BYTES
    ops_ms = 1e3 * 2 * n * k * d / PEAK_F32_FLOPS
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def compare_vq(torch, vq_kernel, x, cb) -> dict:
    """Kernel vs plain version on the same inputs. A mismatch counts as a
    near-tie when the two codes' float64 distances differ by at most
    NEAR_TIE_REL of the smaller one: f32 sums in another order may pick
    either."""
    n, d = x.shape
    k = cb.shape[0]
    before = vq_kernel.launch_count()
    got = vq_kernel.nearest_codebook_indices(x, cb).long()
    want = vq_kernel.nearest_codebook_indices_plain(x, cb).long()
    torch.cuda.synchronize()
    rows = torch.nonzero(got != want).flatten()
    near, err = 0, 0.0
    if rows.numel():
        x64 = x[rows].double()
        d_got = ((x64 - cb[got[rows]].double()) ** 2).sum(1)
        d_want = ((x64 - cb[want[rows]].double()) ** 2).sum(1)
        gap = (d_got - d_want).abs()
        near = int((gap <= NEAR_TIE_REL * torch.minimum(d_got, d_want)).sum())
        err = float(gap.max())
    iters = 10 if k * n > 1e8 else 50
    kernel_ms = time_ms(torch, lambda: vq_kernel.nearest_codebook_indices(x, cb), iters)
    plain_ms = time_ms(torch, lambda: vq_kernel.nearest_codebook_indices_plain(x, cb), iters)
    library_ms = time_ms(torch, lambda: torch.cdist(x, cb).argmin(dim=1), iters)
    bound_ms, bound_by = vq_bound_ms(n, k, d)
    return {
        "phase": "kernel", "name": "vq_nearest", "n": n, "k": k, "d": d,
        "mismatches": int(rows.numel()), "near_ties": near, "max_abs_err": err,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "launches": vq_kernel.launch_count() - before,
    }


def vq_tie_case(torch, vq_kernel, gen) -> dict:
    """Duplicated codes at 7, 23 (another lane of the same tile), 71 (the
    same thread as 7, second half of the tile) and 400 (another codebook
    split): the earliest index, 7, must win every row."""
    cb = torch.randn(512, VQ_D, generator=gen, device="cuda")
    for j in (23, 71, 400):
        cb[j] = cb[7]
    x = cb[7][None].repeat(300, 1) + 1e-3 * torch.randn(
        300, VQ_D, generator=gen, device="cuda"
    )
    got = vq_kernel.nearest_codebook_indices(x, cb)
    winners = sorted(set(got.tolist()))
    check(winners == [7], f"tie case: kernel picked {winners}, expected [7]")
    return {"phase": "kernel_tie", "name": "vq_nearest", "winners": winners}


# ---------------------------------------------------------------------------
# Phase 4: serving
# ---------------------------------------------------------------------------


def chirp_wav_bytes(seconds: float, sr: int) -> tuple[bytes, int]:
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    f = 110.0 + (2000.0 - 110.0) * t / seconds
    wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr) * 32767).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, sr, wav)
    return buf.getvalue(), len(wav)


def request(url: str, data: bytes | None = None) -> tuple[int, bytes, float]:
    req = urllib.request.Request(url, data=data)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            body, status = r.read(), r.status
    except urllib.error.HTTPError as e:
        body, status = e.read(), e.code
    return status, body, time.perf_counter() - t0


def read_wav(body: bytes, sr: int) -> np.ndarray:
    from scipy.io import wavfile

    check(body[:4] == b"RIFF" and body[8:12] == b"WAVE", "response is not RIFF/WAVE")
    rate, wav = wavfile.read(io.BytesIO(body))
    check(rate == sr, f"sample rate {rate}, expected {sr}")
    check(wav.dtype == np.int16 and wav.ndim == 1, f"wav {wav.dtype} {wav.shape}")
    # the server peak-normalizes into [-32767, 32767]; a NaN cast to int16
    # lands outside it (finiteness itself is checked on the device output)
    peak = int(np.abs(wav.astype(np.int32)).max())
    check(0 < peak <= 32767, f"waveform peak {peak}")
    return wav


def check_finite_outputs(torch, service, wav_bytes: bytes, codes: np.ndarray) -> None:
    """The float waveforms behind /reconstruct and /decode are finite."""
    with torch.inference_mode():
        padded, _ = service._pad_for_reconstruct(wav_bytes)
        wav = service._reconstruct_wav(torch.from_numpy(padded).cuda()[None])
        idx = torch.from_numpy(codes).cuda()[None]
        dec = service._vocode(service.model.decode(idx)[0, :, :, 0])
        check(bool(torch.isfinite(wav).all()), "non-finite /reconstruct waveform")
        check(bool(torch.isfinite(dec).all()), "non-finite /decode waveform")


def serve_phase(torch, serve, dsp, vq_kernel, VQVAE) -> dict:
    args = serve.parse_args(["--device", "cuda"])
    check((args.dim, args.z_dim, args.frames) == (256, 512, 84),
          "serving defaults are not the flagship width")
    t0 = time.perf_counter()
    service = serve.build_service(args)
    build_s = time.perf_counter() - t0
    cfg = service.cfg.audio
    sr, hop = cfg.sample_rate, cfg.effective_hop_size
    chirps = {seconds: chirp_wav_bytes(seconds, sr) for seconds in CHIRP_SECONDS}
    httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    lat: dict = {}
    # every count is read over the HTTP requests alone
    vq_kernel.reset_launch_count()
    try:
        status, body, _ = request(base + "/health")
        check(status == 200 and json.loads(body) == {"status": "ok", "backend": "cuda"},
              f"/health: {status} {body[:200]!r}")

        def run_all(record: bool) -> dict:
            outs = {}
            for seconds, (wav_bytes, n) in chirps.items():
                t = dsp.num_stft_frames(n, cfg.fft_size, hop)
                status, body, dt = request(base + "/encode", wav_bytes)
                check(status == 200, f"/encode {seconds}s: {status} {body[:200]!r}")
                enc = json.loads(body)
                codes = np.asarray(enc["codes"])
                want = [cfg.num_mels // 4, -(-t // 4)]
                check(enc["shape"] == want and list(codes.shape) == want,
                      f"/encode {seconds}s shape {enc['shape']}, expected {want}")
                check(codes.min() >= 0 and codes.max() < args.z_dim, "codes out of range")
                if record:
                    lat.setdefault(("/encode", seconds), []).append(dt)
                status, body, dt = request(base + "/reconstruct", wav_bytes)
                check(status == 200, f"/reconstruct {seconds}s: {status} {body[:200]!r}")
                rec = read_wav(body, sr)
                check(len(rec) == n, f"/reconstruct {seconds}s: {len(rec)} samples, expected {n}")
                if record:
                    lat.setdefault(("/reconstruct", seconds), []).append(dt)
                payload = json.dumps({"codes": enc["codes"]}).encode()
                status, body, dt = request(base + "/decode", payload)
                check(status == 200, f"/decode {seconds}s: {status} {body[:200]!r}")
                dec = read_wav(body, sr)
                want_len = hop * (4 * codes.shape[1] - 1)
                check(len(dec) == want_len, f"/decode {seconds}s: {len(dec)} samples, expected {want_len}")
                if record:
                    lat.setdefault(("/decode", seconds), []).append(dt)
                outs[seconds] = (wav_bytes, codes, rec)
            return outs

        # warm-up (cuDNN algorithm choice, FFT plans), then the timed rounds
        run_all(record=False)
        for _ in range(TIMED_REPEATS):
            outs = run_all(record=True)

        # bursts of concurrent /reconstruct requests through the batcher
        sizes: list = []
        run_batch = service.reconstruct_batched
        service.enable_batching(10.0, 8)
        service.batcher._run_batch = lambda reqs: (sizes.append(len(reqs)), run_batch(reqs))[1]
        wav_bytes, _, rec_seq = outs[3.0]
        burst = []
        with concurrent.futures.ThreadPoolExecutor(BURST) as pool:
            for _ in range(BURST_ROUNDS):
                futures = [pool.submit(request, base + "/reconstruct", wav_bytes)
                           for _ in range(BURST)]
                burst += [f.result() for f in futures]
        for status, body, _ in burst:
            check(status == 200, f"batched /reconstruct: {status} {body[:200]!r}")
            check(len(read_wav(body, sr)) == len(rec_seq), "batched length differs")
        burst_diff = max(
            int(np.abs(read_wav(b, sr).astype(np.int32) - rec_seq).max()) for _, b, _ in burst
        )
        burst_ms = [1e3 * dt for _, _, dt in burst]

        status, body, _ = request(base + "/metrics")
        check(status == 200, f"/metrics: {status}")
        metrics = json.loads(body)
        check(all(metrics["endpoints"][p]["errors"] == 0
                  for p in ("/encode", "/reconstruct", "/decode")), "endpoint errors")
    finally:
        httpd.shutdown()
        httpd.server_close()
    launches = vq_kernel.launch_count()
    # one launch per /encode and per unbatched /reconstruct (all windows of
    # a request in one call), one per micro-batch of equal-length requests,
    # none for /decode
    want_launches = 2 * len(CHIRP_SECONDS) * (1 + TIMED_REPEATS) + len(sizes)
    check(launches == want_launches,
          f"the HTTP requests launched vq_nearest {launches} times, expected {want_launches}")

    for wav_bytes, codes, _ in outs.values():
        check_finite_outputs(torch, service, wav_bytes, codes)

    # the same model on the CPU (plain nearest-code search) is the reference
    ref_model = VQVAE(1, args.dim, args.z_dim)
    ref_model.load_state_dict({k: v.cpu() for k, v in service.model.state_dict().items()})
    ref_model.eval()
    wav_bytes, codes_gpu, _ = outs[1.0]
    with torch.inference_mode():
        windows, t, n_win = service._wav_to_mel(wav_bytes)
        mel_gpu = service._reconstruct(windows).cpu()
        mel_cpu = ref_model(windows.cpu())[0]
        codes_cpu = service._stitch(ref_model.encode(windows.cpu())[:n_win].numpy(), t, 4)
    code_mismatch = float(np.mean(codes_cpu != codes_gpu))
    mel_err = float((mel_gpu - mel_cpu).abs().max())
    check(code_mismatch <= 0.005, f"card vs CPU codes differ at {code_mismatch:.4%} of positions")
    check(mel_err <= 1e-3, f"card vs CPU reconstructed mel differs by {mel_err}")

    latency = {}
    for (path, seconds), values in sorted(lat.items()):
        ms = 1e3 * np.asarray(values)
        latency[f"{path}@{seconds:g}s"] = {
            "n": len(values), "p50": float(np.percentile(ms, 50)),
            "p90": float(np.percentile(ms, 90)),
        }
    return {
        "phase": "serving", "dim": args.dim, "z_dim": args.z_dim, "frames": args.frames,
        "gl_iters": cfg.griffin_lim_iters, "gl_momentum": cfg.griffin_lim_momentum,
        "build_service_s": build_s, "latency_ms": latency,
        "burst": BURST, "burst_rounds": BURST_ROUNDS, "burst_batch_sizes": sizes,
        "burst_ms": {"n": len(burst_ms), "p50": float(np.percentile(burst_ms, 50)),
                     "p90": float(np.percentile(burst_ms, 90))},
        "burst_max_int16_diff_vs_unbatched": burst_diff,
        "cpu_reference": {"code_mismatch_frac": code_mismatch, "mel_max_abs_err": mel_err},
        "vq_launches": launches,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        from neural_sound_generation_tpu_torch.cli import serve
        from neural_sound_generation_tpu_torch.device import set_full_float32
        from neural_sound_generation_tpu_torch.models import VQVAE
        from neural_sound_generation_tpu_torch.ops import dsp
        from neural_sound_generation_tpu_torch.ops.cuda import build, vq_kernel
    except ImportError as e:
        print(f"FAIL: the port is not beside this script: {e}", file=sys.stderr)
        return 1
    set_full_float32()
    try:
        # phase 1: device and card
        print(card_line(), flush=True)
        emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})

        # phase 2: build
        t0 = time.perf_counter()
        vq_kernel.load(rebuild=True)
        info = build.build_info["vq_nearest"]
        check("sm_90a" in info["log"], "ptxas did not compile for sm_90a")
        emit({"phase": "build", "kernel": "vq_nearest", "seconds": time.perf_counter() - t0,
              "nvcc_seconds": info["seconds"], "library": info["path"],
              "ptxas": [ln.strip() for ln in info["log"].splitlines() if "Used" in ln or "spill" in ln]})

        # phase 3: kernels against their plain versions
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        rows = {}
        for n, k in VQ_SHAPES:
            x = torch.randn(n, VQ_D, generator=gen, device="cuda")
            cb = torch.randn(k, VQ_D, generator=gen, device="cuda")
            row = compare_vq(torch, vq_kernel, x, cb)
            emit(row)
            check(row["mismatches"] == row["near_ties"],
                  f"vq_nearest N={n} K={k}: {row['mismatches'] - row['near_ties']} "
                  f"mismatches that are not near-ties")
            rows[(n, k)] = row
            del x, cb
        emit(vq_tie_case(torch, vq_kernel, gen))
        torch.cuda.empty_cache()

        # phase 4: the serving path, with launch counts from its HTTP requests
        serving = serve_phase(torch, serve, dsp, vq_kernel, VQVAE)
        emit(serving)
    except (SmokeFailure, RuntimeError, ValueError, OSError, KeyError) as e:
        print(f"FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    # phase 5: summary and result
    main_row = rows[VQ_MAIN_SHAPE]
    emit({"kernels": [{
        "name": "vq_nearest", "route": "cuda",
        "source": "neural_sound_generation_tpu_torch/csrc/vq_nearest.cu",
        "replaces": "neural_sound_generation_tpu/ops/pallas/vq_kernel.py:49",
        "status": "ported", "shape": {"n": VQ_MAIN_SHAPE[0], "k": VQ_MAIN_SHAPE[1], "d": VQ_D},
        "launches": serving["vq_launches"], "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

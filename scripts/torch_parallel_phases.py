#!/usr/bin/env python3
"""Phases 19 to 22 of ``chip_smoke.py`` alone, with every check recorded.

Writes phase 5's chirp corpus and seeded checkpoints at the widths of
phases 5 and 11 (the flat VQ-VAE, the HierVQVAE and the WaveVQVAE: dim 256,
512 codes), then runs the parallel phases as ``chip_smoke.main`` does
(phase 18, which reads phase 17's records, left out): the one-rank jobs of
phases 19 and 20, phase 21 with phases 19's, 20's and 22's two- and
four-rank jobs riding its ``torchrun`` launches, then the checks of 19, 20
and 22. With ``--pipe-alone`` it runs the W 1 jobs phase 22 reads and phase
22 alone, launching its own jobs. A failed check is recorded, not fatal;
the exit code is 4 when any failed. ``--out FILE`` writes every phase's
record there as JSON. Phase 23's halo-convolution jobs ride the launches
too, as in the smoke; each launch's record has its ``launch_wall``: the
ranks' start-up, jobs, loader waits and replay. ``--python-collate`` runs
every loader, in this process and on the ranks, on the Python collate in
place of the native loader (the default), for an A/B of the launches.

``--cpu`` rehearses on the CPU at small widths (dim 16, 32 codes, a
4-layer 16-wide vocoder in 4 stacks): the kernel comparisons are stubbed,
and the launch counts and kernel 4's BH checks (0 there) are not recorded.

Run from the repository root: ``python3 scripts/torch_parallel_phases.py
[--pipe-alone] [--cpu] [--tag NAME] [--out FILE]`` (some 5-8 minutes on
one H100).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the checks a CPU rehearsal cannot meet (no kernel launches, no card timing)
CPU_ONLY_MISSES = ("launched", "kernel 4 at BH", "steps/s", "did not fall")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pipe-alone", action="store_true",
                   help="the W 1 jobs phase 22 reads, then phase 22 launching its own jobs")
    p.add_argument("--cpu", action="store_true", help="a rehearsal on the CPU at small widths")
    p.add_argument("--tag", default="parallel_phases",
                   help="the name of the working directory under build/")
    p.add_argument("--out", help="a file to write the phases' records to as JSON")
    p.add_argument("--python-collate", action="store_true",
                   help="every loader on the Python collate instead of the native loader")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from neural_sound_generation_tpu_torch.cli import prior as cli_prior
    from neural_sound_generation_tpu_torch.cli import vocoder as cli_vocoder
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.models import VQVAE, HierVQVAE, WaveVQVAE
    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
    from neural_sound_generation_tpu_torch.ops.cuda import fused_adam, vq_kernel
    from neural_sound_generation_tpu_torch.training import checkpoint
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    fails = []

    def check(cond, msg):
        if not cond and not (args.cpu and any(k in msg for k in CPU_ONLY_MISSES)):
            fails.append(msg)
            print("CHECK FAILED:", msg[:2000], flush=True)

    cs.check = check
    t0 = time.time()
    if args.python_collate:
        cs.PYTHON_COLLATE = True
        cs.loader_wait_meter(python_collate=True)
    if args.cpu:
        cs.DEVICE = "cpu"
        cs.TRAIN_DIM, cs.TRAIN_CODES = 16, 32
        cs.VT_LAYERS, cs.VT_STACKS, cs.VT_RESIDUAL = 4, 4, 16
        cs.CORPUS_UTTERANCES = 176

        def stub(*a, **k):
            return {"mismatches": 0, "near_ties": 0, "run_to_run_identical": True, "n": 0,
                    "k": 0, "rel_err": {"x": 0.0}, "plan": {}, "max_abs_err": 0.0,
                    "kernel_ms": 0.0, "kernel_device_ms": 0.0, "plain_ms": 0.0,
                    "bound_ms": 0.0, "library_ms": 0.0, "bound_by": "",
                    "tensor_core_bound_ms": 0.0, "library_device_ms": 0.0, "ctas": 0}

        cs.compare_attention = cs.compare_fused_adam = cs.compare_vq = stub
        card, gen = "cpu", None
    else:
        if not torch.cuda.is_available():
            print("FAIL: a CUDA device is required (or --cpu)", file=sys.stderr)
            return 1
        card = cs.card_line()
        print(card, flush=True)
        set_full_float32()
        threads = [threading.Thread(target=m.load) for m in (vq_kernel, fused_adam, fa)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    root = os.path.join(ROOT, "build", f"smoke_{args.tag}")
    shutil.rmtree(root, ignore_errors=True)
    corpus = os.path.join(root, "corpus")
    cs.write_corpus(torch, dsp, Config().audio, corpus)
    cfg = Config()
    dim, codes = cs.TRAIN_DIM, cs.TRAIN_CODES
    vq = os.path.join(root, "vq")
    hier = os.path.join(root, "hier", "models", "hiervqvae", f"checkpoint_ljspeech_{dim}_{codes}")
    units = os.path.join(root, "wave", "models", "wavevqvae",
                         f"checkpoint_ljspeech_{dim}_{codes}")
    for model, path, extra in (
            (VQVAE(1, dim, codes), vq, {"arch": "vqvae", "num_quantizers": 1}),
            (HierVQVAE(1, dim, codes), hier, {"arch": "hiervqvae", "num_quantizers": 1}),
            (WaveVQVAE(dim, codes, cs.WAVE_DOWNSAMPLE), units,
             {"arch": "wavevqvae", "num_quantizers": 1, "num_downsample": cs.WAVE_DOWNSAMPLE})):
        checkpoint.save(path, create_train_state(model, cfg.train), step=1, extra=extra)
    checkpoint.wait_for_pending()
    out = {"card": card}
    tpp_w1 = cs.p19_runs(torch, root, corpus, vq)
    if args.pipe_alone:
        base = os.path.join(root, "tp_gated")
        os.makedirs(base, exist_ok=True)
        data = cs.p21_data(torch, dsp, base, {"corpus": corpus, "vq": vq, "hier": hier,
                                              "units": units})
        jobs = [j for j in cs.p21_jobs(root, data, 1)
                if j["name"] in ("mel", "mel_bf16", "mulaw", "units")]
        tpp_rows = {"w1": tpp_w1["ranks"][0]}
        tpg_rows = {"w1": cs.launch_tp(torch, root, jobs, 1, "tp_gated")["ranks"][0],
                    "w1_argv": {j["name"]: j["argv"] for j in jobs}, "data": data}
        out["p22"], _ = cs.pipeline_parallel_phase(
            torch, cli_prior, cli_vocoder, root, corpus, vq, hier, card, tpp_rows, tpg_rows,
            fa, vq_kernel, fused_adam, gen)
    else:
        ae_data = cs.p20_data(torch, dsp, root, corpus)
        tpa_w1 = cs.launch_tp(torch, root, cs.p20_jobs(root, ae_data, 1), 1, "tp_ae")

        def riders(data, world):
            return ({"tp_prior": cs.p19_jobs(root, corpus, vq, world),
                     "tp_ae": cs.p20_jobs(root, ae_data, world),
                     "pp": cs.p22_jobs(root, cs.p22_w1_argv(root, corpus, vq, hier, data),
                                       world),
                     # full width only: no CPU rehearsal of phase 23
                     **({} if args.cpu else {"seq": cs.seq_jobs()})},
                    {"tp_prior": ("dense", cs.TP_COLLECTIVE_ITERS),
                     "tp_ae": ("wave_raw", cs.P20_COLLECTIVE_ITERS)})

        out["p21"], tpg_rows = cs.gated_tensor_parallel_phase(
            torch, dsp, cli_vocoder, cli_prior, root,
            {"corpus": corpus, "vq": vq, "hier": hier, "units": units}, card, vq_kernel,
            fused_adam, gen, riders)
        rode = tpg_rows["riders"]
        out["p19"], tpp_rows = cs.prior_tensor_parallel_phase(
            torch, cli_prior, root, corpus, vq, card, fa, fused_adam, gen,
            {1: tpp_w1, **{w: rode[w]["tp_prior"] for w in cs.P19_WORLDS[1:]}})
        out["p20"], _ = cs.autoencoder_tensor_parallel_phase(
            torch, dsp, root, corpus, card, vq_kernel, fused_adam, gen, ae_data,
            {1: tpa_w1, **{w: rode[w]["tp_ae"] for w in cs.P20_WORLDS[1:]}})
        out["p22"], _ = cs.pipeline_parallel_phase(
            torch, cli_prior, cli_vocoder, root, corpus, vq, hier, card, tpp_rows, tpg_rows,
            fa, vq_kernel, fused_adam, gen, {w: rode[w]["pp"] for w in (2, 4)})
    out["fails"] = fails
    out["total_seconds"] = time.time() - t0
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, default=str, indent=1)
    shutil.rmtree(root, ignore_errors=True)
    print("FAILS", len(fails), "seconds", out["total_seconds"],
          {k: out[k]["seconds"] for k in ("p21", "p19", "p20", "p22") if k in out}, flush=True)
    if "p21" in out:
        for w in (2, 4):
            print(f"W {w} launch", json.dumps(out["p21"]["jobs"][f"launch_wall_w{w}"]),
                  flush=True)
    return 4 if fails else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Card-vs-CPU gradient of the HierVQVAE train step, over several trainings.

Each trial trains ``chip_smoke.py``'s hierarchical model on one CUDA card
(``chip_smoke.other_argv("hiervqvae")`` with ``--codebook-init data``: dim
256, 512 codes, batch 64 of 80 x 24 crops, ``OTHER_EPOCHS`` epochs on the
smoke's chirp corpus) from its own ``--seed``, then runs one float32 train
step from the checkpoint, as ``chip_smoke.hier_card_vs_cpu`` does, under
each of ``VARIANTS``: the card, the card without cuDNN (PyTorch's own CUDA
convolutions), the CPU on one thread, the CPU with the output of the
first convolution (``FIRST_CONV``, whose output channels feed the first
BatchNorm) replaced by the card's values (its gradient flowing as through
its own), and the CPU at its default thread count; with the largest gap
between the card's and the CPU's first-convolution outputs in units of
the float32 rounding bound of their sums (u * (sum |w| |x| + |b|)). Each step also recomputes, in float64 on its device, every
convolution's weight and bias gradient from the float32 input and output
gradient that convolution saw in the step (``exact_conv_grads``): its
"reference" gradient differs from its float32 one only in the rounding of
those last reductions over batch and positions. One JSON line a trial
gives, for each variant against the default CPU: the code flips of each
level (train mode, statistics discarded), the relative error of the step's
``grad_norm`` and of the whole flat gradient, and the ``--top`` parameter
tensors whose squared norm moved most; for each variant, ``grad_norm``
against its own reference's norm and against the default CPU's reference;
and for every BatchNorm the least batch variance over its channels and the
largest |mean| / std (the CPU's forward of the step). With ``--out`` the
lines also go to that file.

``--rule`` sets the constant of ``chip_smoke.hier_card_vs_cpu``'s no-flip
``grad_norm`` limit, max(1e-5, c * s): it runs the card, the CPU on one
thread and the CPU alone, without the float64 references, and each line
gives the card's gap (its ``grad_norm`` from the CPU's, relative), the
state's own order spread s (the one-thread CPU's, relative) and their
ratio. Phase 11 of ``chip_smoke.py`` trains with ``--seed 1``.

Run from the repository root: ``python3 scripts/torch_hier_grad_probe.py
[--seeds 1 2 3 4 5 6] [--top 5] [--rule] [--out FILE]``; fails without a
CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (device, cuDNN flags or None, CPU threads or None, the card's
# first convolution output put in); "card" runs first, "cpu" last
VARIANTS = {
    "card": ("card", None, None, False),
    "card_no_cudnn": ("card", {"enabled": False}, None, False),
    "cpu_one_thread": ("cpu", None, 1, False),
    "cpu_card_conv0": ("cpu", None, None, True),
    "cpu": ("cpu", None, None, False),
}
RULE_VARIANTS = ("card", "cpu_one_thread", "cpu")
FIRST_CONV = "enc_bottom.Conv_0"
UNIT_ROUNDOFF = 2.0**-24


@contextlib.contextmanager
def variant(torch, flags: dict | None, threads: int | None):
    """cuDNN's flags and the CPU's thread count for one step."""
    saved = torch.get_num_threads()
    if threads:
        torch.set_num_threads(threads)
    try:
        with torch.backends.cudnn.flags(**{"enabled": True, "benchmark": False,
                                           "deterministic": False, "allow_tf32": False,
                                           **(flags or {})}):
            yield
    finally:
        torch.set_num_threads(saved)


def batch_norm_stats(torch, model) -> tuple[dict, list]:
    """Forward hooks on every BatchNorm: the least channel variance and the
    largest |mean| / std of the batch each normalizes. Returns (the record,
    the hooks)."""
    from neural_sound_generation_tpu_torch.models.layers import BatchNorm

    record, hooks = {}, []
    for name, module in model.named_modules():
        if not isinstance(module, BatchNorm):
            continue

        def hook(_, inputs, __, name=name):
            x = inputs[0].detach().double()
            dims = (0, *range(2, x.dim()))
            var = x.var(dim=dims, unbiased=False)
            ratio = x.mean(dim=dims).abs() / var.clamp(min=1e-30).sqrt()
            record[name] = {"min_var": float(var.min()), "max_mean_over_std": float(ratio.max())}

        hooks.append(module.register_forward_hook(hook))
    return record, hooks


@contextlib.contextmanager
def exact_conv_grads(torch, model, out: dict):
    """Record each convolution's input and output gradient during a step;
    on exit put into ``out`` its weight and bias gradients recomputed in
    float64 from them (name -> tensor, on the module's device)."""
    import torch.nn.functional as F

    seen, hooks = {}, []
    convs = {name: m for name, m in model.named_modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))}
    for name, m in convs.items():
        def hook(_, inputs, y, name=name):
            entry = {"x": inputs[0].detach()}
            seen.setdefault(name, []).append(entry)
            y.register_hook(lambda g: entry.__setitem__("dy", g.detach()))
        hooks.append(m.register_forward_hook(hook))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
    for name, calls in seen.items():
        m = convs[name]
        w64 = m.weight.detach().double().requires_grad_(True)
        gw = torch.zeros_like(w64)
        gb = None if m.bias is None else torch.zeros_like(m.bias, dtype=torch.float64)
        for c in calls:
            x64, dy64 = c["x"].double(), c["dy"].double()
            if isinstance(m, torch.nn.ConvTranspose2d):
                y = F.conv_transpose2d(x64, w64, None, m.stride, m.padding, m.output_padding,
                                       m.groups, m.dilation)
            else:
                y = F.conv2d(x64, w64, None, m.stride, m.padding, m.dilation, m.groups)
            gw += torch.autograd.grad(y, w64, dy64)[0]
            if gb is not None:
                gb += dy64.sum(dim=(0, 2, 3))
        out[f"{name}.weight"] = gw
        if gb is not None:
            out[f"{name}.bias"] = gb


def reference(torch, flat, g, exact: dict):
    """The float64 flat gradient ``g`` with the recomputed entries put in."""
    ref = g.clone()
    for (name, view) in zip(flat.names, flat.split(ref)):
        if name in exact:
            view.copy_(exact[name].cpu())
    return ref


def trial(torch, cs, cli_main, checkpoint, cfg, ckpt: str, batch, top_n: int,
          variants=tuple(VARIANTS), with_reference: bool = True) -> dict:
    from neural_sound_generation_tpu_torch.models.layers import batch_stats_discarded
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state
    from neural_sound_generation_tpu_torch.training.trainer import make_train_step

    grads, metrics, levels, bn, refs = {}, {}, {}, {}, {}
    first = {}
    for tag in variants:
        where, flags, threads, inject = VARIANTS[tag]
        device = cs.DEVICE if where == "card" else "cpu"
        model = cli_main.make_model(cfg).to(device)
        conv0 = model.get_submodule(FIRST_CONV)
        if inject:
            hook0 = conv0.register_forward_hook(
                lambda _, __, y: y + (first["card"].to(y) - y).detach())
        else:
            hook0 = conv0.register_forward_hook(
                lambda _, inputs, y, tag=tag: first.update(
                    {tag: y.detach().cpu(), f"{tag}_x": inputs[0].detach().cpu()}))
        state = create_train_state(model, cfg.train)
        checkpoint.restore(ckpt, state)
        x = torch.from_numpy(batch["x"]).to(device)
        with variant(torch, flags, threads), torch.no_grad(), batch_stats_discarded(model):
            model.train()
            top, bottom = model.levels(x)
            levels[tag] = [t.cpu() for t in (top[1], top[3], bottom[1], bottom[3])]
            books = (model.codebook_top.detach().cpu().clone(),
                     model.codebook_bottom.detach().cpu().clone())
        record, hooks = batch_norm_stats(torch, model) if tag == "cpu" else ({}, [])
        exact = {}
        with variant(torch, flags, threads), (exact_conv_grads(torch, model, exact)
                                              if with_reference else contextlib.nullcontext()):
            _, m = make_train_step(model, cfg)(state, {"x": x})
        for h in hooks:
            h.remove()
        hook0.remove()
        bn.update(record)
        metrics[tag] = {k: float(v) for k, v in m.items()}
        grads[tag] = state.flat.grad.detach().cpu().double().clone()
        flat = state.flat
        refs[tag] = reference(torch, flat, grads[tag], exact)
    zt, it, zb, ib = levels["cpu"]
    g_cpu = grads["cpu"]
    if not with_reference:
        row = {"grad_norm": metrics["cpu"]["grad_norm"]}
        return _compare(torch, cs, row, variants, levels, books, grads, metrics, flat, top_n)
    ref_cpu = float(refs["cpu"].norm())
    w, b = conv0.weight.detach().double().abs(), conv0.bias.detach().double().abs()
    bound = UNIT_ROUNDOFF * (torch.nn.functional.conv2d(
        first["cpu_x"].double().abs(), w, None, conv0.stride, conv0.padding) + b[:, None, None])
    gap = (first["card"].double() - first["cpu"].double()).abs()
    row = {"grad_norm": metrics["cpu"]["grad_norm"], "batch_norm": bn,
           "first_conv_gap_over_rounding_bound": float((gap / bound).max()),
           "against_reference": {tag: {
               "grad_norm_vs_own_reference": abs(metrics[tag]["grad_norm"]
                                                 - float(refs[tag].norm())) / ref_cpu,
               "grad_norm_vs_cpu_reference": abs(metrics[tag]["grad_norm"] - ref_cpu) / ref_cpu,
               "reference_vs_cpu_reference": abs(float(refs[tag].norm()) - ref_cpu) / ref_cpu,
               "grad_vs_own_reference": float((grads[tag] - refs[tag]).norm()) / ref_cpu,
               "reference_grad_vs_cpu_reference": float((refs[tag] - refs["cpu"]).norm())
               / ref_cpu} for tag in VARIANTS}}
    return _compare(torch, cs, row, variants, levels, books, grads, metrics, flat, top_n)


def _compare(torch, cs, row, variants, levels, books, grads, metrics, flat, top_n) -> dict:
    """Each variant against the default CPU: flips, grad_norm, the whole
    gradient, the loss terms and the tensors that moved most."""
    zt, it, zb, ib = levels["cpu"]
    g_cpu = grads["cpu"]
    for tag in list(variants)[:-1]:
        zt_a, it_a, zb_a, ib_a = levels[tag]
        top = cs.level_flips(torch, zt, zt_a, books[0], it, it_a)
        bot = cs.level_flips(torch, zb, zb_a, books[1], ib, ib_a,
                             cs.bottom_cascade(torch, it != it_a, None))
        g = grads[tag]
        per = []
        for name, a, b in zip(flat.names, flat.split(g), flat.split(g_cpu)):
            per.append({"name": name, "numel": a.numel(), "cpu_norm": float(b.norm()),
                        "diff_norm": float((a - b).norm()),
                        "sq_norm_moved": float(a.norm() ** 2 - b.norm() ** 2)})
        per.sort(key=lambda r: -abs(r["sq_norm_moved"]))
        row[tag] = {
            "top_flips": top["flips"], "bottom_flips": bot["flips"],
            "flips_not_near_ties": top["flips_not_near_ties"] + bot["flips_not_near_ties"],
            "grad_norm_rel": abs(metrics[tag]["grad_norm"] - metrics["cpu"]["grad_norm"])
            / metrics["cpu"]["grad_norm"],
            "grad_rel": float((g - g_cpu).norm() / g_cpu.norm()),
            "loss_rel": {k: abs(metrics[tag][k] - v) / abs(v)
                         for k, v in metrics["cpu"].items() if v},
            "z_e_top_max_abs_err": float((zt_a - zt).abs().max()),
            "z_e_bottom_max_abs_err": float((zb_a - zb).abs().max()),
            "moved_most": per[:top_n]}
    return row


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4, 5, 6])
    p.add_argument("--top", type=int, default=5)
    p.add_argument("--out", help="a file to write the JSON lines to as well")
    p.add_argument("--rule", action="store_true",
                   help="the card, the one-thread CPU and the CPU only, no references: "
                        "each seed's gap, spread and their ratio")
    args = p.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from neural_sound_generation_tpu_torch.cli import main as cli_main
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.device import set_full_float32
    from neural_sound_generation_tpu_torch.ops import dsp
    from neural_sound_generation_tpu_torch.training import checkpoint

    if cs.DEVICE == "cuda" and not torch.cuda.is_available():
        print("FAIL: a CUDA device is required", file=sys.stderr)
        return 1
    set_full_float32()
    if cs.DEVICE == "cuda":
        print(cs.card_line(), flush=True)
    root = os.path.join(ROOT, "build", "hier_grad_probe")
    shutil.rmtree(root, ignore_errors=True)
    corpus = os.path.join(root, "corpus")
    cs.write_corpus(torch, dsp, Config().audio, corpus)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        open(args.out, "w").close()
    try:
        for seed in args.seeds:
            out = os.path.join(root, f"seed{seed}")
            argv = cs.other_argv("hiervqvae", out, corpus) + ["--codebook-init", "data"]
            with contextlib.redirect_stdout(io.StringIO()):
                cli_main.main(argv + ["--epochs", str(cs.OTHER_EPOCHS), "--seed", str(seed)])
            parsed = cli_main.parse_args(argv + ["--epochs", "1"])
            cfg = cli_main.build_config(parsed)
            batch = next(iter(cli_main.audio_loaders(parsed, cfg)[0]))
            ckpt = os.path.join(out, "models", "hiervqvae",
                                f"checkpoint_ljspeech_{cs.TRAIN_DIM}_{cs.TRAIN_CODES}")
            if args.rule:
                row = trial(torch, cs, cli_main, checkpoint, cfg, ckpt, batch, args.top,
                            RULE_VARIANTS, with_reference=False)
                gap = row["card"]["grad_norm_rel"]
                spread = row["cpu_one_thread"]["grad_norm_rel"]
                row["rule"] = {"gap": gap, "spread": spread,
                               "ratio": gap / spread if spread > 0 else float("inf"),
                               "top_flips": row["card"]["top_flips"],
                               "bottom_flips": row["card"]["bottom_flips"]}
                line = json.dumps({"seed": seed, **row})
                print(json.dumps({"seed": seed, **row["rule"]}) if args.out else line,
                      flush=True)
            else:
                row = trial(torch, cs, cli_main, checkpoint, cfg, ckpt, batch, args.top)
                line = json.dumps({"seed": seed, **row})
                print(json.dumps({"seed": seed, **{tag: {k: row[tag][k] for k in (
                    "grad_norm_rel", "top_flips", "bottom_flips")}
                    for tag in list(VARIANTS)[:-1]}, **{
                        f"{tag}_ref": {k: "%.3g" % v for k, v in r.items()}
                        for tag, r in row["against_reference"].items()}})
                      if args.out else line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

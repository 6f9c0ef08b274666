"""Standalone evaluation of a saved checkpoint against the test split.

Counterpart of ``neural_sound_generation_tpu/cli/evaluate.py`` for the four
families of ``cli.main`` (``--model vae|vqvae|hiervqvae|wavevqvae``) over
an audio corpus or, beyond the JAX command, MNIST/CIFAR10: per-batch metric
accumulation, the averaged summary as one JSON line, and the last
reconstruction batch as ``.npy`` (``--dump-npy``). The
EMA shadow is evaluated when the checkpoint carries one, unless
``--no-ema``. The checkpoint's recorded metadata (``arch``,
``num_quantizers``, ``num_downsample``) must match the flags;
``--num-quantizers`` builds the residual-VQ model and ``--bf16`` evaluates
in bfloat16 compute (checkpoints are float32 and restore unchanged).
Under ``torchrun`` with ``--mesh-data N`` the sweep runs over N ranks, each
on its rows of every test batch (``cli.main``'s policy): the summary is the
global batches' and is printed by rank 0, which also writes ``--dump-npy``
from the gathered reconstruction. ``--mesh-model M`` (every ``--model``)
evaluates over a (W / M, M) mesh with the codebooks' rows and the
convolutions' output channels sharded as ``cli.main`` trains them: the
restore keeps each rank's slices of the whole checkpoint, whatever M
trained it.

Run: ``python -m neural_sound_generation_tpu_torch.cli.evaluate --datadir
<corpus> --ckpt-dir <dir> [--device cuda]``
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from neural_sound_generation_tpu_torch.cli.main import (
    AUDIO_DATASETS,
    audio_loaders,
    build_config,
    checkpoint_metadata,
    image_loaders,
    make_model,
    refuse_later_slices,
)
from neural_sound_generation_tpu_torch.device import resolve_device
from neural_sound_generation_tpu_torch.ops.cuda import vq_kernel
from neural_sound_generation_tpu_torch.parallel import mesh_from_args, process_group, shard_batch
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.sharding import shard_train_state
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a saved checkpoint")
    p.add_argument("--model", default="vqvae",
                   choices=["vae", "vqvae", "wavevqvae", "hiervqvae"])
    p.add_argument("--dataset", default="ljspeech")
    p.add_argument("--datadir", required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--preset", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--z-dim", type=int, default=512)
    p.add_argument("--norm", choices=["batch", "group"], default="batch")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--dump-npy", default=None,
                   help="write the last reconstruction batch here")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute for the eval sweep (checkpoints are "
                        "float32 and restore unchanged)")
    p.add_argument("--no-ema", action="store_true",
                   help="evaluate the live training parameters instead of the "
                        "averaged (EMA) model")
    p.add_argument("--num-quantizers", type=int, default=1,
                   help="residual-VQ stages the checkpoint was trained with")
    p.add_argument("--num-downsample", type=int, default=6)
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    # fields build_config expects that evaluation does not use
    args.lr_rate, args.beta, args.seed, args.epochs, args.log_interval = 1e-3, 1.0, 0, 1, 10
    args.speaker_id = None
    refuse_later_slices(args)
    with process_group(args.device):
        return evaluate(args)


def evaluate(args) -> dict:
    """The sweep of ``main`` inside its process group: the means."""
    mesh = mesh_from_args(args.mesh_data, args.mesh_model, args.batch_size)
    device = resolve_device(args.device)
    primary = mesh is None or mesh.is_primary
    if mesh is not None:
        mesh.build_first(device, vq_kernel)
    cfg = build_config(args)
    try:
        checkpoint.check_extra(args.ckpt_dir, **checkpoint_metadata(cfg))
    except ValueError as e:
        raise SystemExit(str(e)) from e

    if args.dataset in AUDIO_DATASETS:
        _, test_loader = audio_loaders(args, cfg, test_shuffle=False)
        n_speakers = cfg.arch.n_speakers if "g" in next(iter(test_loader)) else 0
        test_batches = iter(test_loader)
    else:
        test_batches = image_loaders(args)[1]()
        n_speakers = 0
    model = make_model(cfg, n_speakers, norm=args.norm,
                       generator=torch.Generator().manual_seed(0),
                       dtype=torch.bfloat16 if args.bf16 else torch.float32).to(device)
    state = create_train_state(model, cfg.train)
    if mesh is not None and mesh.tensor_parallel:
        state = shard_train_state(state, mesh)
    try:
        state, extra = checkpoint.restore(args.ckpt_dir, state)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    if args.no_ema:
        # without the shadow, eval_params() resolves to the live parameters
        state.ema_params = None
    if mesh is not None:
        mesh.replicate(state)
    if primary:
        print(f"loaded checkpoint step={int(state.step)} extra={extra}")

    trainer = Trainer(model, cfg, state, log_fn=print, mesh=mesh)
    batches = test_batches
    if args.max_batches:
        batches = itertools.islice(batches, args.max_batches)
    means, recon = trainer.eval_epoch(shard_batch(b, mesh) for b in batches)
    if not primary:
        return means
    print(json.dumps({k: round(v, 6) for k, v in means.items()}))
    if args.dump_npy and recon is not None:
        np.save(args.dump_npy, recon.detach().cpu().numpy())
        print(f"wrote {args.dump_npy}")
    return means


if __name__ == "__main__":
    main(sys.argv[1:])

#!/usr/bin/env python3
"""Import a checkpoint of the JAX package (Orbax) into the port's format.

Orbax imports JAX, so this importer lives outside the port's package and
needs the JAX package's requirements (JAX, flax, optax, Orbax); the port
then reads what it writes without any of them. Two kinds:

  * ``cli.main`` training state (the four families: the mel VQ-VAE,
    HierVQVAE, WaveVQVAE, VAE): give the JAX run's ``--ckpt-dir`` root as
    ``--jax-ckpt-dir`` and, after ``--``, the ``cli.main`` arguments of the
    run (the flags both CLIs take), with the port's checkpoint root as
    their ``--ckpt-dir``. The importer builds the JAX state as JAX's
    ``cli.main`` does (the model initialized on a batch of the corpus,
    ``create_train_state`` with the run's EMA-codebook flag), restores the
    step through JAX's ``training.checkpoint.restore`` and writes the
    port's state for the same arguments: the parameters and BatchNorm
    statistics, the optimizer's count and moments (the flat fused
    optimizer's vectors or the per-leaf optimizer's trees), the parameter
    EMA, the EMA-codebook statistics, the step and the metadata. The
    port's ``cli.main <arguments> --resume`` then continues the JAX run.
  * a parameters artifact of ``cli.prior`` or ``cli.vocoder`` (a prior's
    sampling artifact or ``_ema`` sibling, a vocoder checkpoint):
    ``--params SRC DST`` writes the step's parameters as the port's
    ``save_params`` artifact with the JAX metadata (read through JAX's
    ``read_extra``), for the port's ``restore_params``.

The trees are mapped by ``neural_sound_generation_tpu_torch/convert.py``
(``flax_to_state_dict``, ``unravel_flax`` for a flat vector,
``codebook_ema_to_port``): every value is copied exactly.

Run from the repository root:

    python3 scripts/torch_import_orbax.py --jax-ckpt-dir JAX_MODELS -- \\
        --model vqvae --dataset ljspeech --datadir DATA --dim 256 --z-dim 512 \\
        --ckpt-dir PORT_MODELS
    python3 scripts/torch_import_orbax.py --params JAX_ARTIFACT PORT_ARTIFACT

``--step N`` imports that step instead of the latest.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(jax.device_get(a)), tree)


def _named(tree, model) -> dict:
    """A params-shaped flax tree -> {port parameter name: tensor}."""
    from neural_sound_generation_tpu_torch import convert

    sd = convert.flax_to_state_dict({"params": tree}, model)
    return {name: sd[name] for name, _ in model.named_parameters()}


def _adam(opt_state):
    """(count, mu tree, nu tree) of a per-leaf optax chain."""
    import jax

    for node in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "mu") and hasattr(n, "nu")):
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node.count, node.mu, node.nu
    raise ValueError("no Adam moments in the JAX optimizer state")


def port_tensors(jstate, model) -> dict:
    """A restored JAX ``TrainState`` as the port's named tree
    (``training.checkpoint.state_tensors``' names) for ``model``."""
    import torch

    from neural_sound_generation_tpu.training.train_state import FusedOptState
    from neural_sound_generation_tpu_torch import convert

    params = _np_tree(jstate.params)
    sd = convert.flax_to_state_dict(
        {"params": params, "batch_stats": _np_tree(jstate.batch_stats or {})}, model)
    out = {f"params/{name}": sd[name] for name, _ in model.named_parameters()}
    out.update({f"batch_stats/{name}": sd[name] for name, _ in model.named_buffers()
                if name.endswith(("running_mean", "running_var"))})

    def tree_of(x):  # a flat fused vector or a params-shaped tree
        return convert.unravel_flax(np.asarray(x), params) if np.ndim(x) == 1 else _np_tree(x)

    opt = jstate.opt_state
    if isinstance(opt, FusedOptState):
        count, m, v = opt.count, opt.m, opt.v
    else:
        count, m, v = _adam(opt)
    out["opt_state/count"] = torch.tensor(int(np.asarray(count)), dtype=torch.int32)
    for key, moment in (("m", m), ("v", v)):
        out.update({f"opt_state/{key}/{n}": t for n, t in _named(tree_of(moment), model).items()})
    if jstate.ema_params is not None:
        out.update({f"ema_params/{n}": t
                    for n, t in _named(tree_of(jstate.ema_params), model).items()})
    if jstate.codebook_ema is not None:
        out.update({f"codebook_ema/{k}": t for k, t in convert.codebook_ema_to_port(
            _np_tree(jstate.codebook_ema)).items()})
    out["step"] = torch.tensor(int(np.asarray(jstate.step)), dtype=torch.int32)
    return out


def import_train(jax_root: str, argv: list, step: Optional[int] = None) -> str:
    """``cli.main``'s state of the JAX run under ``jax_root`` -> the port's
    checkpoint for ``argv``; returns the port's step directory."""
    import jax
    import jax.numpy as jnp

    from neural_sound_generation_tpu.cli import main as jax_cli
    from neural_sound_generation_tpu.training import checkpoint as jax_checkpoint
    from neural_sound_generation_tpu.training.train_state import (
        create_train_state as jax_train_state,
    )
    from neural_sound_generation_tpu_torch.cli import main as cli
    from neural_sound_generation_tpu_torch.training import checkpoint
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    jargs = jax_cli.parse_args([*argv, "--ckpt-dir", jax_root])
    jcfg = jax_cli.build_config(jargs)
    if jargs.dataset in ("MNIST", "CIFAR10"):
        sample = next(jax_cli._image_loaders(jargs)[1]())
    else:
        sample = next(iter(jax_cli._audio_loaders(jargs, jcfg)[1]))
    n_speakers = jcfg.arch.n_speakers if "g" in sample else 0
    jmodel = jax_cli.make_model(jcfg, n_speakers, norm=jargs.norm,
                                dtype=jnp.bfloat16 if jargs.bf16 else jnp.float32)
    init_kwargs = ({"g": sample["g"]} if "g" in sample and jargs.model != "hiervqvae" else {})
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(sample["x"]), train=False,
                            **init_kwargs)
    template = jax_train_state(variables, jcfg.train, ema_codebook=jcfg.model.ema_codebook,
                               fused=False if jargs.mesh_model > 1 else None)
    jstate, extra = jax_checkpoint.restore(jax_cli._checkpoint_dir(jargs), template, step)

    args = cli.parse_args(argv)
    cfg = cli.build_config(args)
    model = cli.make_model(cfg, n_speakers, norm=args.norm)
    state = create_train_state(model, cfg.train, ema_codebook=cfg.model.ema_codebook)
    checkpoint.load_state_tensors(state, port_tensors(jstate, model), jax_root)
    meta = {**cli.checkpoint_metadata(cfg), **(extra or {})}
    return checkpoint.save(cli.checkpoint_dir(args), state, step=int(state.step), extra=meta)


def import_params(src: str, dst: str, step: Optional[int] = None) -> str:
    """A JAX parameters artifact (``{"params": ...}``) -> the port's
    ``save_params`` artifact, with the JAX metadata."""
    import orbax.checkpoint as ocp

    from neural_sound_generation_tpu.training import checkpoint as jax_checkpoint
    from neural_sound_generation_tpu_torch import convert
    from neural_sound_generation_tpu_torch.training import checkpoint

    at = step if step is not None else jax_checkpoint.latest_step(src)
    if at is None:
        raise FileNotFoundError(f"no checkpoints under {src}")
    extra = jax_checkpoint.read_extra(src, at)
    with ocp.PyTreeCheckpointer() as reader:
        payload = reader.restore(os.path.join(os.path.abspath(src), f"step_{at}"))
    tree = payload["state"]
    if "params" not in tree:
        raise ValueError(f"{src} step {at} holds no parameters tree")
    sd = convert.flax_to_state_dict({"params": _np_tree(tree["params"])})
    return checkpoint.save_named_params(dst, sd, at, extra)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    rest = []
    if "--" in argv:
        at = argv.index("--")
        argv, rest = argv[:at], argv[at + 1:]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--jax-ckpt-dir", help="the JAX cli.main run's --ckpt-dir root")
    p.add_argument("--params", nargs=2, metavar=("SRC", "DST"),
                   help="a JAX parameters artifact and the port's to write")
    p.add_argument("--step", type=int, help="the step to import (default: the latest)")
    args = p.parse_args(argv)
    if (args.params is None) == (args.jax_ckpt_dir is None):
        p.error("give --jax-ckpt-dir with the cli.main arguments after --, or --params")
    sys.path.insert(0, ROOT)
    if args.params:
        path = import_params(*args.params, step=args.step)
    else:
        if not rest:
            p.error("--jax-ckpt-dir needs the run's cli.main arguments after --")
        path = import_train(args.jax_ckpt_dir, rest, args.step)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

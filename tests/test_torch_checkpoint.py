"""The port's checkpoints: the step-directory layout, a save/restore round
trip of every part of the train state (exact), async saves that snapshot
the state when called, the metadata sidecar, the EMA sibling, and the
refusals (metadata or shape mismatch)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.training import checkpoint, train_state, trainer

torch.set_num_threads(1)

DIM, Z_DIM = 16, 32


def _cfg(**train):
    cfg = Config()
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train),
                               model=dataclasses.replace(cfg.model, dim=DIM, z_dim=Z_DIM))


def _state(seed=0, ema_codebook=True, **train):
    model = VQVAE(1, DIM, Z_DIM, generator=torch.Generator().manual_seed(seed))
    return train_state.create_train_state(model, _cfg(**train).train, ema_codebook=ema_codebook)


def _trained(seed=0, steps=2, **train):
    """A state whose every part differs from a fresh one."""
    state = _state(seed, **train)
    cfg = _cfg(**train)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ema_codebook=True))
    step = trainer.make_train_step(state.model, cfg)
    x = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (2, 80, 8, 1)).astype(np.float32))
    for _ in range(steps):
        step(state, {"x": x})
    return state


def _assert_equal_states(a, b):
    ta, tb = checkpoint.state_tensors(a), checkpoint.state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


def test_round_trip_restores_every_tensor(tmp_path):
    state = _trained()
    path = checkpoint.save(str(tmp_path), state, step=int(state.step), extra={"epoch": 1})
    assert path.endswith("step_2") and sorted(os.listdir(path)) == ["_extra.json", "state.pt"]
    fresh = _state(seed=1)
    restored, extra = checkpoint.restore(str(tmp_path), fresh)
    assert restored is fresh and extra == {"epoch": 1}
    _assert_equal_states(fresh, state)
    # the restored parameters are still views of the flat buffer
    assert fresh.model.codebook.data_ptr() == fresh.flat.view("codebook").data_ptr()


def test_async_save_snapshots_the_state_when_called(tmp_path):
    state = _trained()
    want = {k: t.clone() for k, t in checkpoint.state_tensors(state).items()}
    checkpoint.save(str(tmp_path), state, step=5, extra={"epoch": 2}, block=False)
    with torch.no_grad():
        state.flat.flat.add_(1.0)  # the next steps change the buffers
    assert checkpoint.latest_step(str(tmp_path)) == 5  # waits for the write
    fresh = _state(seed=1)
    checkpoint.restore(str(tmp_path), fresh)
    for k, t in checkpoint.state_tensors(fresh).items():
        assert torch.equal(t, want[k]), k


def test_latest_step_and_read_extra(tmp_path):
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    assert checkpoint.read_extra(str(tmp_path / "none")) is None
    state = _state()
    for step, epoch in ((3, 1), (12, 2), (7, 9)):
        checkpoint.save(str(tmp_path), state, step=step, extra={"epoch": epoch, "arch": "vqvae"},
                        block=False)
    os.makedirs(tmp_path / "step_x")  # not a step directory
    assert checkpoint.latest_step(str(tmp_path)) == 12
    assert checkpoint.read_extra(str(tmp_path)) == {"epoch": 2, "arch": "vqvae"}
    assert checkpoint.read_extra(str(tmp_path), step=7)["epoch"] == 9
    with open(tmp_path / "step_12" / "_extra.json") as f:
        assert json.load(f)["arch"] == "vqvae"
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), state)


def test_metadata_mismatch_refuses(tmp_path):
    state = _state()
    meta = {"arch": "vqvae", "num_quantizers": 1, "num_downsample": 6}
    checkpoint.save(str(tmp_path), state, step=1, extra={"epoch": 1, **meta})
    assert checkpoint.check_extra(str(tmp_path), **meta)["epoch"] == 1
    for key, value in (("arch", "hiervqvae"), ("num_quantizers", 2), ("num_downsample", 4)):
        with pytest.raises(ValueError, match=key):
            checkpoint.check_extra(str(tmp_path), **{**meta, key: value})


def test_shape_mismatch_refuses(tmp_path):
    checkpoint.save(str(tmp_path), _state(), step=1)
    other = train_state.create_train_state(VQVAE(1, DIM, 2 * Z_DIM), _cfg().train)
    with pytest.raises(ValueError, match="codebook"):
        checkpoint.restore(str(tmp_path), other)


def test_restore_casts_moments_and_drops_a_missing_ema(tmp_path):
    state = _trained(exponential_moving_average=False)
    assert state.ema_params is None
    checkpoint.save(str(tmp_path), state, step=2)
    fresh = _state(seed=1, bf16_moments=True)
    checkpoint.restore(str(tmp_path), fresh)
    assert fresh.opt_state.m.dtype == torch.bfloat16
    assert torch.equal(fresh.opt_state.m, state.opt_state.m.to(torch.bfloat16))
    assert fresh.ema_params is None


def test_ema_sibling_round_trip(tmp_path):
    state = _trained()
    with torch.no_grad():
        state.ema_params.mul_(0.5)
    ckpt = str(tmp_path / "ckpt")
    path = checkpoint.save_ema_sibling(ckpt, state, step=2, extra={"epoch": 1})
    assert path == os.path.join(str(tmp_path), "ckpt_ema", "step_2")
    assert checkpoint.read_extra(ckpt + "_ema") == {"epoch": 1, "averaged": True}
    fresh = _state(seed=1)
    checkpoint.restore_ema_sibling(ckpt, fresh)
    assert torch.equal(fresh.ema_params, state.ema_params)
    no_ema = _state(exponential_moving_average=False)
    assert checkpoint.save_ema_sibling(ckpt, no_ema, step=3) is None
    assert checkpoint.restore_ema_sibling(str(tmp_path / "other"), fresh) is fresh

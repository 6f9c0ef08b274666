"""The training loop's spans (``train.feed``, ``train.step``,
``train.forward``, ``train.backward``, ``train.optimizer``, ``train.pull``)
on a tiny VQ-VAE and a tiny WaveNet vocoder: one of each step span a step
(once per inner step under ``multi_steps``), one feed a fetched batch, one
pull a logged step and one at the epoch's end; the same losses and flat
state bit for bit with the tracer on and off; off, no CUDA event and no
profiler range."""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu_torch.cli import vocoder as vocoder_cli
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from neural_sound_generation_tpu_torch.training.trainer import Trainer
from neural_sound_generation_tpu_torch.utils import profiling

STEP_SPANS = ("train.step", "train.forward", "train.backward", "train.optimizer")
LOG_INTERVAL = 2


@pytest.fixture(autouse=True)
def _cleared_tracer():
    profiling.drain()
    yield
    profiling.drain()


def _cfg(cfg: Config) -> Config:
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                              log_interval=LOG_INTERVAL))


def _vqvae(multi_steps=1):
    model = VQVAE(input_dim=1, dim=8, z_dim=16, generator=torch.Generator().manual_seed(3))
    cfg = _cfg(Config())
    state = create_train_state(model, cfg.train)
    return Trainer(model, cfg, state, log_fn=None, multi_steps=multi_steps)


def _vqvae_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"x": rng.uniform(0, 1, (2, 80, 8, 1)).astype(np.float32)} for _ in range(n)]


def _wavenet(multi_steps=1):
    args = vocoder_cli.parse_args(["train", "--datadir", ".", "--batch-size", "2", "--layers", "2",
                                   "--stacks", "1", "--residual-channels", "8", "--device",
                                   "cpu"])
    cfg = _cfg(Config())
    model = vocoder_cli.build_model(cfg, args, generator=torch.Generator().manual_seed(4))
    state = create_train_state(model, cfg.train)
    return Trainer(model, cfg, state, log_fn=None, multi_steps=multi_steps)


def _wavenet_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"y": rng.uniform(-0.9, 0.9, (2, 512, 1)).astype(np.float32),
             "c": rng.uniform(0, 1, (2, 2, 80)).astype(np.float32),
             "input_lengths": np.full((2,), 512, np.int64)} for _ in range(n)]


FAMILIES = {"vqvae": (_vqvae, _vqvae_batches), "wavenet": (_wavenet, _wavenet_batches)}


def _counts(trainer, batches):
    profiling.enable()
    trainer.train_epoch(batches, torch.Generator().manual_seed(0))
    spans = profiling.drain()["spans"]
    return Counter(s.name for s in spans), spans


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_of_each_span_a_step(family):
    make, batches = FAMILIES[family]
    n = 5
    counts, spans = _counts(make(), batches(n))
    assert {name: counts[name] for name in STEP_SPANS} == {name: n for name in STEP_SPANS}
    assert counts["train.feed"] == n
    # steps 0, 2 and 4 log, and the epoch's mean is one pull more
    assert counts["train.pull"] == len(range(0, n, LOG_INTERVAL)) + 1
    assert set(counts) == {*STEP_SPANS, "train.feed", "train.pull"}
    # the phases lie inside their step, and the step after its feed
    steps = [s for s in spans if s.name == "train.step"]
    feeds = [s for s in spans if s.name == "train.feed"]
    for k, step in enumerate(steps):
        assert feeds[k].end_ns <= step.start_ns
        phases = [s for s in spans if s.name in STEP_SPANS[1:]
                  and step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns]
        assert [s.name for s in phases] == list(STEP_SPANS[1:])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_inner_spans_once_per_inner_step(family):
    make, batches = FAMILIES[family]
    counts, _ = _counts(make(multi_steps=2), batches(4))
    assert {name: counts[name] for name in STEP_SPANS} == {name: 4 for name in STEP_SPANS}
    assert counts["train.feed"] == 2  # one stacked super-batch a fetch
    assert counts["train.pull"] == 2  # the first super-batch logs, then the epoch's mean


def _state(trainer):
    state = trainer.state
    out = [state.flat.flat, state.opt_state.m, state.opt_state.v]
    if state.ema_params is not None:
        out.append(state.ema_params)
    return [t.detach().clone() for t in out]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_tracer_changes_no_bit(family):
    make, batches = FAMILIES[family]
    results = []
    for on in (False, True):
        trainer = make()
        if on:
            profiling.enable()
        means = [trainer.train_epoch(batches(3, seed=e), torch.Generator().manual_seed(0),
                                     epoch=e) for e in range(2)]
        recorded = profiling.drain()["spans"]
        assert bool(recorded) == on
        results.append((means, _state(trainer)))
    (means_off, state_off), (means_on, state_on) = results
    assert means_on == means_off
    assert all(torch.equal(a, b) for a, b in zip(state_on, state_off))


def _refuse(*args, **kwargs):
    raise AssertionError("the tracer is off: no CUDA event and no profiler range")


def test_off_the_trainer_takes_no_event_and_no_range(monkeypatch):
    trainer = _vqvae()
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _refuse)
    means = trainer.train_epoch(_vqvae_batches(3), torch.Generator().manual_seed(0))
    assert np.isfinite(means["loss"])
    assert profiling.drain()["spans"] == []

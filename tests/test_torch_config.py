"""The port's ``TacotronArchConfig`` against the JAX package's, field for
field: the same names, in the same order, with the same defaults and
annotations, exported from ``config`` as JAX exports it. Tolerance: none."""

import dataclasses

import pytest

from neural_sound_generation_tpu.config import TacotronArchConfig as JaxTacotron
from neural_sound_generation_tpu_torch.config import TacotronArchConfig

JAX_FIELDS = dataclasses.fields(JaxTacotron)


def test_the_same_fields_in_the_same_order():
    assert [f.name for f in dataclasses.fields(TacotronArchConfig)] == [
        f.name for f in JAX_FIELDS]


@pytest.mark.parametrize("field", JAX_FIELDS, ids=lambda f: f.name)
def test_each_field_has_jax_default_and_annotation(field):
    ours = {f.name: f for f in dataclasses.fields(TacotronArchConfig)}[field.name]
    assert ours.default == field.default
    assert type(ours.default) is type(field.default)
    assert str(ours.type) == str(field.type)


def test_frozen_and_equal_under_replace():
    cfg = TacotronArchConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.embedding_dim = 1
    changed = dataclasses.replace(cfg, decoder_lstm_units=512, attention_kernel=(15,))
    want = dataclasses.replace(JaxTacotron(), decoder_lstm_units=512, attention_kernel=(15,))
    assert dataclasses.asdict(changed) == dataclasses.asdict(want)

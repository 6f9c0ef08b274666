"""The weight bridge (neural_sound_generation_tpu_torch.convert): flax
variables -> the port's state_dict -> flax variables is bit-exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.models import VQVAE

torch.set_num_threads(1)


def _jax_variables(norm, n_speakers, gin):
    kw = {"g": jnp.zeros((1,), jnp.int32)} if n_speakers else {}
    m = JaxVQVAE(input_dim=1, dim=16, z_dim=32, n_speakers=n_speakers,
                 gin_channels=gin, norm=norm)
    v = m.init(jax.random.PRNGKey(3), jnp.zeros((1, 80, 16, 1)), train=False, **kw)
    rng = np.random.default_rng(0)
    # distinct values everywhere, so a swapped or transposed leaf shows
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), v)


@pytest.mark.parametrize("norm,n_speakers,gin", [
    ("batch", 0, -1), ("batch", 4, 8), ("group", 0, -1),
])
def test_round_trip_is_bit_exact(norm, n_speakers, gin):
    v = _jax_variables(norm, n_speakers, gin)
    sd = convert.flax_to_state_dict(v)
    model = VQVAE(1, 16, 32, n_speakers, gin, norm=norm)
    assert set(sd) == set(model.state_dict())  # strict: nothing missing or extra
    model.load_state_dict(sd)
    back = convert.module_to_flax(model)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for (path, a), (_, b) in zip(
        jax.tree_util.tree_leaves_with_path(v), jax.tree_util.tree_leaves_with_path(back)
    ):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


def test_layouts():
    v = _jax_variables("batch", 4, 8)
    sd = convert.flax_to_state_dict(v)
    p = v["params"]
    k = p["encoder"]["Conv_0"]["kernel"]  # (4, 4, 1, 16) HWIO
    np.testing.assert_array_equal(sd["encoder.Conv_0.weight"].numpy(), k.transpose(3, 2, 0, 1))
    kt = p["decoder"]["ConvTranspose_0"]["kernel"]
    w = sd["decoder.ConvTranspose_0.weight"].numpy()  # (in, out, kh, kw), flipped
    assert w.shape == (16, 16, 4, 4)
    np.testing.assert_array_equal(w[2, 5, 0, 3], kt[3, 0, 2, 5])
    np.testing.assert_array_equal(sd["speaker_proj.weight"].numpy(), p["speaker_proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["encoder.BatchNorm_0.running_var"].numpy(),
        v["batch_stats"]["encoder"]["BatchNorm_0"]["var"])


def test_unknown_leaf_raises():
    with pytest.raises(ValueError, match="no port counterpart"):
        convert.flax_to_state_dict({"params": {"Dense_0": {"weird": np.zeros(3)}}})

"""The port's VAE and DefaultVAE held against the JAX package on the CPU, with
the JAX weights carried over by the bridge (convert.py): the VALID transpose
convs alone, eval and train forwards (the train-mode noise is the JAX
module's own draw, injected), the BatchNorm running averages after a train
forward, the ELBOs, one train step and one eval step, the bridge's round
trip, and ``cli.main --model vae`` on MNIST and CIFAR-10 end to end.

Tolerances: ATOL 1e-4 for forwards (float32 convolutions summed in another
order); one train step as ``tests/test_torch_training.py``.
"""

import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.models import VAE as JaxVAE
from neural_sound_generation_tpu.models import DefaultVAE as JaxDefaultVAE
from neural_sound_generation_tpu.training import losses as jlosses
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import evaluate, main
from neural_sound_generation_tpu_torch.models import VAE, DefaultVAE
from neural_sound_generation_tpu_torch.training import (
    checkpoint,
    losses,
    train_state,
    trainer,
)
from torch_parity import (
    ATOL,
    TrainPair,
    assert_metrics,
    assert_round_trip,
    cfgs,
    np_tree,
    perturb_params,
    perturb_stats,
)

torch.set_num_threads(1)

DIM, Z = 16, 4


def _vae_noise(key, shape):
    """The JAX VAE's eps: make_rng("sample") at the top scope, then a
    normal draw at mu's (NHWC) shape."""
    jm = JaxVAE(input_dim=1, dim=DIM, z_dim=Z)
    rng = jm.apply({}, method=lambda m: m.make_rng("sample"), rngs={"sample": key})
    return np.asarray(jax.random.normal(rng, shape, jnp.float32))


def _pair(input_dim=1, hw=28, seed=0):
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.standard_normal((4, hw, hw, input_dim))).astype(np.float32)
    jm = JaxVAE(input_dim=input_dim, dim=DIM, z_dim=Z)
    v = np_tree(jm.init({"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1)},
                        jnp.asarray(x[:1]), train=False))
    v = perturb_params(perturb_stats(v, seed + 1), seed + 2, scale=0.05)
    tm = VAE(input_dim, DIM, Z)
    tm.load_state_dict(convert.flax_to_state_dict(v, tm))
    return jm, v, tm, x


def _inject(tm, eps_nhwc):
    """Replace the port's draw by the JAX eps (NHWC -> the port's NCHW)."""
    eps = torch.from_numpy(np.array(eps_nhwc))
    eps = eps.permute(0, 3, 1, 2) if eps.dim() == 4 else eps

    def noise(shape, generator, device):
        assert tuple(shape) == tuple(eps.shape)
        return eps.to(device)

    tm.sample_noise = noise


@pytest.mark.parametrize("k", [3, 5])
def test_valid_transpose_conv_matches_flax(k):
    """flax's VALID ConvTranspose (stride 1, no kernel flip) is
    ConvTranspose2d(k) with the kernel flipped and its in/out axes swapped."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 3, 4, 6)).astype(np.float32)
    fmod = fnn.ConvTranspose(5, (k, k), padding="VALID")
    v = np_tree(fmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["bias"] = rng.standard_normal(5).astype(np.float32)
    want = np.asarray(fmod.apply(v, jnp.asarray(x)))
    holder = torch.nn.Module()
    holder.ConvTranspose_0 = torch.nn.ConvTranspose2d(6, 5, k)
    holder.load_state_dict(convert.flax_to_state_dict({"params": {"ConvTranspose_0": v["params"]}},
                                                      holder))
    with torch.no_grad():
        got = holder.ConvTranspose_0(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 3 + k - 1, 4 + k - 1, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("input_dim,hw", [(1, 28), (3, 32)])
def test_vae_eval_forward_matches_jax(input_dim, hw):
    """Eval mode: running statistics, eps = 0 (the JAX train=False)."""
    jm, v, tm, x = _pair(input_dim, hw)
    xt, kl = jm.apply(v, jnp.asarray(x), train=False)
    tm.eval()
    with torch.no_grad():
        txt, tkl = tm(torch.from_numpy(x))
    assert txt.shape == x.shape
    np.testing.assert_allclose(txt.numpy(), np.asarray(xt), atol=ATOL)
    np.testing.assert_allclose(float(tkl), float(kl), rtol=1e-5)
    assert float(np.std(np.asarray(xt))) > 0.01


@pytest.mark.parametrize("input_dim,hw", [(1, 28), (3, 32)])
def test_vae_train_forward_and_running_averages_match_jax(input_dim, hw):
    """Train mode with the JAX module's own noise injected: outputs, KL and
    the BatchNorm running averages after the pass."""
    jm, v, tm, x = _pair(input_dim, hw, seed=3)
    key = jax.random.PRNGKey(11)
    (xt, kl), mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"],
                             rngs={"sample": key})
    side = 1 if hw == 28 else 2
    _inject(tm, _vae_noise(key, (x.shape[0], side, side, Z)))
    tm.train()
    with torch.no_grad():
        txt, tkl = tm(torch.from_numpy(x))
    np.testing.assert_allclose(txt.numpy(), np.asarray(xt), atol=ATOL)
    np.testing.assert_allclose(float(tkl), float(kl), rtol=1e-5)
    stats = convert.module_to_flax(tm)["batch_stats"]
    want = np_tree(mut["batch_stats"])
    for name in want:
        for k in ("mean", "var"):
            np.testing.assert_allclose(stats[name][k], want[name][k], atol=1e-5,
                                       err_msg=f"{name}/{k}")


def test_vae_train_mode_needs_a_generator_and_draws_from_it():
    tm = VAE(1, DIM, Z, generator=torch.Generator().manual_seed(0))
    tm.train()
    x = torch.zeros(2, 28, 28, 1)
    with pytest.raises(ValueError, match="Generator"):
        tm(x)
    a = tm(x, generator=torch.Generator().manual_seed(5))[0]
    b = tm(x, generator=torch.Generator().manual_seed(5))[0]
    c = tm(x, generator=torch.Generator().manual_seed(6))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_elbos_match_jax():
    rng = np.random.default_rng(2)
    recon = rng.uniform(0.01, 0.99, (4, 784)).astype(np.float32)
    x = rng.uniform(0, 1, (4, 28, 28, 1)).astype(np.float32)
    mu, logvar = (rng.standard_normal((4, 20)).astype(np.float32) for _ in range(2))
    want = jlosses.elbo_bce(jnp.asarray(recon), jnp.asarray(x), jnp.asarray(mu),
                            jnp.asarray(logvar))
    got = losses.elbo_bce(*(torch.from_numpy(a) for a in (recon, x, mu, logvar)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    xt = rng.standard_normal((4, 28, 28, 1)).astype(np.float32)
    want = jlosses.elbo_mse(jnp.asarray(xt), jnp.asarray(x), jnp.float32(0.7))
    got = losses.elbo_mse(torch.from_numpy(xt), torch.from_numpy(x), torch.tensor(0.7))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_default_vae_matches_jax_in_eval_and_train_mode():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (3, 28, 28, 1)).astype(np.float32)
    jm = JaxDefaultVAE()
    v = perturb_params(np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)), 5,
                       scale=0.01)
    tm = DefaultVAE()
    tm.load_state_dict(convert.flax_to_state_dict(v, tm))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(got, jm.apply(v, jnp.asarray(x), train=False)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    key = jax.random.PRNGKey(3)
    want = jm.apply(v, jnp.asarray(x), train=True, rngs={"sample": key})
    sub = jm.apply(v, method=lambda m: m.make_rng("sample"), rngs={"sample": key})
    _inject(tm, jax.random.normal(sub, (3, 20), jnp.float32))
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    loss = losses.elbo_bce(*got[:1], torch.from_numpy(x), *got[1:])
    np.testing.assert_allclose(float(loss), float(jlosses.elbo_bce(want[0], jnp.asarray(x),
                                                                    want[1], want[2])), rtol=1e-5)
    # the port's own init: flax's LeCun normal, truncated at 2 sigma, seeded
    a = DefaultVAE(generator=torch.Generator().manual_seed(0))
    b = DefaultVAE(generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.Dense_0.weight, b.Dense_0.weight)
    w = a.Dense_0.weight.detach()
    assert float(w.abs().max()) <= 2 * (1 / 784) ** 0.5 / 0.87962566 + 1e-6
    assert abs(float(w.std()) - (1 / 784) ** 0.5) < 0.05 * (1 / 784) ** 0.5


def test_flat_views_start_on_16_byte_boundaries_and_the_gaps_stay_zero():
    """The VAE registers its (1,) output bias ahead of its BatchNorms: every
    parameter view still starts on a 16-byte boundary (cuDNN's train-mode
    batch norm on channels-last input faults on a scale 4 bytes off one),
    and a step leaves the gaps between views at zero in every flat vector."""
    tm = VAE(1, DIM, Z, generator=torch.Generator().manual_seed(0))
    _, tcfg = cfgs(dim=DIM, z_dim=Z, model="vae")
    state = train_state.create_train_state(tm, tcfg.train)
    flat = state.flat
    assert all(p.data_ptr() % 16 == 0 for p in tm.parameters())
    assert [o % 4 for o in flat.offsets] == [0] * len(flat.offsets)
    gaps = torch.ones(flat.numel, dtype=torch.bool)
    for o, shape in zip(flat.offsets, flat.shapes):
        gaps[o:o + int(np.prod(shape))] = False
    assert int(gaps.sum()) == 3  # after ConvTranspose_3's one bias
    x = torch.rand(4, 28, 28, 1) * 2 - 1
    trainer.make_train_step(tm, tcfg)(state, {"x": x}, torch.Generator().manual_seed(1))
    for vec in (flat.flat, flat.grad, state.opt_state.m, state.opt_state.v, state.ema_params):
        assert float(vec[gaps].abs().max()) == 0.0


@pytest.mark.parametrize("model", ["vae", "default"])
def test_bridge_round_trip_is_bit_exact(model):
    if model == "vae":
        _, v, tm, _ = _pair()
    else:
        jm = JaxDefaultVAE()
        v = np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 784)), train=False))
        tm = DefaultVAE()
    assert_round_trip(v, tm)


def test_one_vae_train_step_and_eval_step_match_jax():
    """The JAX step draws eps under rngs={"sample": the step's key}; the
    port's draw is replaced by that eps. Gradients first, then the metrics
    (loss, kl, grad_norm) and the whole state after the step; then the eval
    step on the EMA shadow."""
    jm, v, tm, x = _pair(seed=6)
    jcfg, tcfg = cfgs(dim=DIM, z_dim=Z, model="vae")
    pair = TrainPair(jm, v, tm, jcfg, tcfg, seed=6)
    key = jax.random.PRNGKey(21)
    batch = {"x": jnp.asarray(x)}
    loss_fn = jtrainer._vae_loss_fn(jm)
    _, jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        pair.jstate.params, pair.jstate.batch_stats, batch, key)
    jstate, jmetrics = jtrainer.make_train_step(jm, jcfg, donate=False)(pair.jstate, batch, key)
    _inject(tm, _vae_noise(key, (x.shape[0], 1, 1, Z)))
    _, tmetrics = trainer.make_train_step(tm, tcfg)(pair.tstate, {"x": torch.from_numpy(x)})
    pair.assert_grads_match(jgrads)
    assert_metrics(tmetrics, jmetrics, ("loss", "kl"))
    pair.assert_states_match(jstate)

    jx, jm_eval = jtrainer.make_eval_step(jm, jcfg)(jstate, batch)
    tx, tm_eval = trainer.make_eval_step(tm, tcfg)(pair.tstate, {"x": torch.from_numpy(x)})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)
    for k in ("loss", "kl"):
        np.testing.assert_allclose(float(tm_eval[k]), float(jm_eval[k]), rtol=1e-4, err_msg=k)


# -- the CLI on synthetic image files ---------------------------------------


def _write_mnist(root, n_train=24, n_test=8):
    """idx files of structured 28x28 digits-like strokes (as
    tests/test_cli.py writes them)."""
    rng = np.random.default_rng(0)
    for prefix, n in (("train", n_train), ("t10k", n_test)):
        imgs = np.zeros((n, 28, 28), np.uint8)
        for i in range(n):
            r = rng.integers(4, 20)
            imgs[i, r:r + 6, 4:24] = 255
            imgs[i, 4:24, r:r + 3] = 200
        with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write((2051).to_bytes(4, "big") + n.to_bytes(4, "big")
                    + (28).to_bytes(4, "big") + (28).to_bytes(4, "big") + imgs.tobytes())
        with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
            f.write((2049).to_bytes(4, "big") + n.to_bytes(4, "big")
                    + rng.integers(0, 10, n).astype(np.uint8).tobytes())


def _write_cifar(root, n=16):
    import pickle

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    rng = np.random.default_rng(1)
    for name in ("data_batch_1", "test_batch"):
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                         b"labels": rng.integers(0, 10, n).tolist()}, f)


def _cli(tmp_path, dataset, datadir, *extra):
    return ["--model", "vae", "--dataset", dataset, "--datadir", datadir, "--dim", str(DIM),
            "--z-dim", str(Z), "--batch-size", "4", "--log-interval", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "models"), "--sampledir", str(tmp_path / "results"),
            *extra]


def test_cli_main_trains_resumes_and_evaluates_vae_on_mnist(tmp_path, capsys):
    datadir = tmp_path / "mnist"
    os.makedirs(datadir)
    _write_mnist(str(datadir))
    main.main(_cli(tmp_path, "MNIST", str(datadir), "--epochs", "2"))
    ckpt = os.path.join(tmp_path, "models", "vae", f"checkpoint_MNIST_{DIM}_{Z}")
    assert checkpoint.latest_step(ckpt) == 12  # 24 images, batch 4, two epochs
    assert checkpoint.read_extra(ckpt)["arch"] == "vae"
    recon = np.load(tmp_path / "results" / "MNIST" /
                    f"reconstruction_vae_data_MNIST_dim_{DIM}_z_dim_{Z}_epoch_2.npy")
    assert recon.shape == (4, 28, 28) and np.isfinite(recon).all()
    out = capsys.readouterr().out
    losses_logged = [float(t.split("=")[1]) for t in out.split() if t.startswith("loss=")]
    assert len(losses_logged) == 12 and losses_logged[-1] < losses_logged[0]
    main.main(_cli(tmp_path, "MNIST", str(datadir), "--epochs", "3", "--resume"))
    assert checkpoint.latest_step(ckpt) == 18
    assert checkpoint.read_extra(ckpt)["epoch"] == 3
    means = evaluate.main(["--model", "vae", "--dataset", "MNIST", "--datadir", str(datadir),
                           "--ckpt-dir", ckpt, "--dim", str(DIM), "--z-dim", str(Z),
                           "--batch-size", "4", "--device", "cpu"])
    assert set(means) == {"loss", "kl"} and np.isfinite(means["loss"])
    with pytest.raises(SystemExit, match="trained with arch='vae'"):
        evaluate.main(["--model", "vqvae", "--dataset", "MNIST", "--datadir", str(datadir),
                       "--ckpt-dir", ckpt, "--dim", str(DIM), "--z-dim", str(Z),
                       "--device", "cpu"])
    with pytest.raises(SystemExit, match="codebook-init data"):
        main.main(_cli(tmp_path, "MNIST", str(datadir), "--epochs", "1",
                       "--codebook-init", "data", "--ckpt-dir", str(tmp_path / "other")))


def test_cli_main_trains_vae_on_cifar10(tmp_path):
    datadir = tmp_path / "cifar"
    _write_cifar(str(datadir))
    main.main(_cli(tmp_path, "CIFAR10", str(datadir), "--epochs", "1"))
    ckpt = os.path.join(tmp_path, "models", "vae", f"checkpoint_CIFAR10_{DIM}_{Z}")
    assert checkpoint.latest_step(ckpt) == 4
    state = torch.load(os.path.join(ckpt, "step_4", "state.pt"), weights_only=True)
    assert tuple(state["params/Conv_0.weight"].shape) == (DIM, 3, 4, 4)  # input_dim 3

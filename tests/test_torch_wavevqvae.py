"""The port's WaveVQVAE held against the JAX package on the CPU, with the JAX
weights carried over by the bridge (convert.py, which takes the decoder's
transpose convs from the module: flax names them ``conv_i`` and ``out``):
the 1-D layers alone, eval and train forwards in ``raw``, ``mulaw-quantize``,
with residual VQ and with speakers, ``encode``, ``quantized_latents`` and
``decode``, the 1-D BatchNorm's running averages, the masked cross
entropy, one train step (raw with EMA codebooks; mulaw-quantize with RVQ
and a masked CE), the bridge's round trip, and ``cli.main`` /
``cli.evaluate --model wavevqvae`` end to end on a synthetic corpus.

Tolerances: ATOL 1e-4 for forwards (float32 convolutions summed in another
order), codes equal; one train step as ``tests/test_torch_training.py``.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from neural_sound_generation_tpu.models import WaveVQVAE as JaxWave
from neural_sound_generation_tpu.models import layers as jlayers
from neural_sound_generation_tpu.models import wavevqvae as jwave
from neural_sound_generation_tpu.training import losses as jlosses
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import evaluate, main
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, write_manifest
from neural_sound_generation_tpu_torch.models import WaveVQVAE
from neural_sound_generation_tpu_torch.models import layers
from neural_sound_generation_tpu_torch.models.wavevqvae import ResBlock1D
from neural_sound_generation_tpu_torch.training import checkpoint, losses, trainer
from torch_parity import (
    ATOL,
    PARAM_ATOL,
    TrainPair,
    assert_metrics,
    assert_round_trip,
    cfgs,
    np_tree,
    perturb_params,
    perturb_stats,
)

torch.set_num_threads(1)

DIM, Z, T, NDOWN, QC = 16, 32, 64, 3, 64
STEP_KEYS = ("loss", "loss_recons", "loss_vq", "loss_commit", "train_loss")

VARIANTS = {
    "raw": dict(input_type="raw"),
    "mulaw-quantize": dict(input_type="mulaw-quantize"),
    "rvq": dict(input_type="raw", num_quantizers=2),
    "speakers": dict(input_type="mulaw", n_speakers=3, gin_channels=8),
}


class _Holder(torch.nn.Module):
    def __init__(self, name, child):
        super().__init__()
        self.add_module(name, child)


def _inputs(kw, rng, batch=4):
    if kw.get("input_type") == "mulaw-quantize":
        return rng.integers(0, QC, (batch, T)).astype(np.int32)
    t = np.arange(T)[None] / T
    f = rng.uniform(2, 6, (batch, 1))
    wav = 0.6 * np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal((batch, T))
    return wav[..., None].astype(np.float32)


def _stagewise(ze, q, k, rng):
    books, residual = [], ze.reshape(-1, ze.shape[-1])
    for _ in range(q):
        pick = rng.choice(residual.shape[0], k, replace=residual.shape[0] < k)
        book = (residual[pick] + 0.01 * rng.standard_normal((k, ze.shape[-1]))).astype(
            np.float32)
        books.append(book)
        residual = residual - book[((residual[:, None] - book[None]) ** 2).sum(-1).argmin(1)]
    return np.stack(books) if q > 1 else books[0]


def _pair(variant, seed=0, train_codebook=False):
    """A JAX WaveVQVAE (a ``VARIANTS`` name or its fields) with perturbed
    weights and statistics and a codebook seeded from its own z_e (in train
    mode with ``train_codebook``), so that codes vary, and the port's copy."""
    kw = VARIANTS[variant] if isinstance(variant, str) else variant
    rng = np.random.default_rng(seed)
    x = _inputs(kw, rng)
    g = np.array([2, 0, 1, 2], np.int32) if kw.get("n_speakers") else None
    jm = JaxWave(dim=DIM, z_dim=Z, num_downsample=NDOWN, quantize_channels=QC, **kw)
    init_kw = {"g": jnp.asarray(g[:1])} if g is not None else {}
    v = np_tree(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]), train=False, **init_kw))
    v = perturb_params(perturb_stats(v, seed + 1), seed + 2, scale=0.05)
    if train_codebook:
        (_, ze, _), _ = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        _, ze, _ = jm.apply(v, jnp.asarray(x), train=False)
    v["params"]["codebook"] = _stagewise(np.asarray(ze), kw.get("num_quantizers", 1), Z, rng)
    tm = WaveVQVAE(DIM, Z, NDOWN, quantize_channels=QC, **kw)
    tm.load_state_dict(convert.flax_to_state_dict(v, tm))
    tm.eval()
    return jm, v, tm, x, g


def test_batchnorm1d_matches_flax_over_three_train_steps():
    """flax's BatchNorm over (B, T, C): statistics over (B, T), the biased
    variance in the 0.99 / 0.01 running averages; outputs and statistics
    after each of three steps, then eval mode."""
    rng = np.random.default_rng(5)
    xs = (rng.standard_normal((3, 4, 37, 16)) * 2.0 + 0.5).astype(np.float32)
    fmod = fnn.BatchNorm(use_running_average=False)
    v = perturb_stats(np_tree(fmod.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]))), 6)
    v["params"] = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
                   "bias": rng.standard_normal(16).astype(np.float32)}
    tmod = layers.BatchNorm1d(16)
    holder = _Holder("BatchNorm_0", tmod)
    holder.load_state_dict(convert.flax_to_state_dict(
        {"params": {"BatchNorm_0": v["params"]}, "batch_stats": {"BatchNorm_0": v["batch_stats"]}},
        holder))
    tmod.train()
    for x in xs:
        want, mut = fmod.apply(v, jnp.asarray(x), mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": np_tree(mut["batch_stats"])}
        with torch.no_grad():
            got = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(tmod.running_mean.numpy(), v["batch_stats"]["mean"], atol=1e-5)
        np.testing.assert_allclose(tmod.running_var.numpy(), v["batch_stats"]["var"], atol=1e-5)
    tmod.eval()
    want = fnn.BatchNorm(use_running_average=True).apply(v, jnp.asarray(xs[0]))
    with torch.no_grad():
        got = tmod(torch.from_numpy(xs[0]).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="B, C, T"):
        tmod(torch.zeros(2, 16, 3, 3))


@pytest.mark.parametrize("which,t", [("down", 64), ("down", 37), ("up", 16), ("up", 5)])
def test_1d_stride_convs_match_flax(which, t):
    """The stride-2 width-4 conv (the JAX ``_s2d_conv`` lowers the same
    function) and the SAME transpose conv of width 4, stride 2 (flax: no
    kernel flip), each alone with a nonzero bias."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, 8)).astype(np.float32)
    if which == "down":
        fmod = fnn.Conv(6, (4,), strides=(2,), padding=((1, 1),),
                        conv_general_dilated=jlayers._s2d_conv)
        tmod = layers.conv1d_down(8, 6)
    else:
        fmod = jlayers.ConvTranspose(6, (4,), strides=(2,), padding="SAME")
        tmod = layers.ConvTranspose1dSame(8, 6, 4, 2)
    v = np_tree(fmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v["params"]["bias"] = rng.standard_normal(6).astype(np.float32)
    want = np.asarray(fmod.apply(v, jnp.asarray(x)))
    holder = _Holder("conv_0", tmod)  # the wave family's names: no ConvTranspose_ prefix
    holder.load_state_dict(convert.flax_to_state_dict({"params": {"conv_0": v["params"]}}, holder))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, t // 2 if which == "down" else 2 * t, 6)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_resblock1d_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 20, 16)).astype(np.float32)
    fmod = jwave.ResBlock1D(16)
    v = perturb_params(perturb_stats(np_tree(fmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                                       train=False)), 2), 3)
    tmod = ResBlock1D(16)
    holder = _Holder("res_0", tmod)
    holder.load_state_dict(convert.flax_to_state_dict(
        {"params": {"res_0": v["params"]}, "batch_stats": {"res_0": v["batch_stats"]}}, holder))
    holder.eval()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, np.asarray(fmod.apply(v, jnp.asarray(x), train=False)),
                               atol=ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_forward_encode_decode_match_jax(variant):
    jm, v, tm, x, g = _pair(variant)
    jg = jnp.asarray(g) if g is not None else None
    tg = torch.from_numpy(g) if g is not None else None
    out, ze, zq = jm.apply(v, jnp.asarray(x), train=False, g=jg)
    codes = np.asarray(jm.apply(v, jnp.asarray(x), train=False, method=JaxWave.encode))
    latents = jm.apply(v, jnp.asarray(x), train=False, method=JaxWave.quantized_latents)
    dec = jm.apply(v, jnp.asarray(codes), g=jg, train=False, method=JaxWave.decode)
    with torch.no_grad():
        tout, tze, tzq = tm(torch.from_numpy(x), g=tg)
        tcodes = tm.encode(torch.from_numpy(x))
        tlatents = tm.quantized_latents(torch.from_numpy(x))
        tdec = tm.decode(torch.from_numpy(codes), g=tg)
    q = VARIANTS[variant].get("num_quantizers", 1)
    t_units = T // 2**NDOWN
    assert codes.shape == ((q, 4, t_units) if q > 1 else (4, t_units))
    assert tcodes.dtype == torch.int32 and len(np.unique(codes)) > 6
    want_out = (4, T, QC) if variant == "mulaw-quantize" else (4, T, 1)
    assert tuple(tout.shape) == want_out  # the decoder's length is the input's
    np.testing.assert_array_equal(tcodes.numpy(), codes)
    for got, want in ((tze, ze), (tzq, zq), (tlatents, latents), (tout, out), (tdec, dec)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if variant == "mulaw-quantize":  # int64 codes embed as int32 ones do
        with torch.no_grad():
            t64 = tm(torch.from_numpy(x.astype(np.int64)))[0]
        torch.testing.assert_close(t64, tout, rtol=0, atol=0)
    if variant == "speakers":  # ids matter, and the unconditioned model ignores them
        with torch.no_grad():
            other = tm.decode(torch.from_numpy(codes), g=torch.zeros(4, dtype=torch.int32))
        assert not torch.allclose(other, tdec)
        _, _, plain, xr, _ = _pair("raw")
        with torch.no_grad():
            torch.testing.assert_close(plain(torch.from_numpy(xr), g=tg)[0],
                                       plain(torch.from_numpy(xr))[0])


@pytest.mark.parametrize("variant", ["raw", "mulaw-quantize", "speakers"])
def test_train_forward_and_running_averages_match_jax(variant):
    jm, v, tm, x, g = _pair(variant, seed=3, train_codebook=True)
    jg = jnp.asarray(g) if g is not None else None
    (out, ze, zq), mut = jm.apply(v, jnp.asarray(x), train=True, g=jg, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        tout, tze, tzq = tm(torch.from_numpy(x), g=torch.from_numpy(g) if g is not None else None)
    for got, want in ((tout, out), (tze, ze), (tzq, zq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    stats = convert.module_to_flax(tm)["batch_stats"]
    np.testing.assert_allclose(ravel_pytree(stats)[0],
                               ravel_pytree(np_tree(mut["batch_stats"]))[0], atol=1e-5)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_masked_cross_entropy_matches_jax(dtype):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 10, 7)).astype(np.float32)
    targets = rng.integers(0, 7, (3, 10)).astype(dtype)
    lengths = np.array([10, 4, 0], np.int32)
    for lens in (None, lengths):
        want = jlosses.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(targets, jnp.int32),
                                            None if lens is None else jnp.asarray(lens))
        got = losses.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                          None if lens is None else torch.from_numpy(lens))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_array_equal(
        losses.sequence_mask(torch.from_numpy(lengths), 10).numpy(),
        np.asarray(jlosses.sequence_mask(jnp.asarray(lengths), 10)))


@pytest.mark.parametrize("variant,ema", [("raw", True), ("mulaw-quantize", False)])
def test_one_train_step_and_eval_step_match_jax(variant, ema):
    """raw: MSE, EMA codebook statistics (the codebook's gradient zeroed,
    then its rows the EMA means). mulaw-quantize: the masked cross entropy
    over ``input_lengths`` and residual VQ (2 stages) by gradient.
    Gradients, the metrics and the whole state after the step, then the
    eval step."""
    kw = dict(VARIANTS[variant])
    if variant == "mulaw-quantize":
        kw["num_quantizers"] = 2
    jm, v, tm, x, _ = _pair(kw, seed=7, train_codebook=True)
    jcfg, tcfg = cfgs(beta=0.25, dim=DIM, z_dim=Z, model="wavevqvae", ema_codebook=ema,
                      ema_codebook_decay=0.9, num_quantizers=kw.get("num_quantizers", 1))
    pair = TrainPair(jm, v, tm, jcfg, tcfg, ema_codebook=ema, seed=7)
    lengths = np.array([T, T - 9, T // 2, 5], np.int32)
    jbatch = {"x": jnp.asarray(x), "input_lengths": jnp.asarray(lengths)}
    tbatch = {"x": torch.from_numpy(x), "input_lengths": torch.from_numpy(lengths)}
    _, jgrads = jax.value_and_grad(jtrainer._wave_vqvae_loss_fn(jm, 0.25), has_aux=True)(
        pair.jstate.params, pair.jstate.batch_stats, jbatch, None)
    jstate, jmetrics = jtrainer.make_train_step(jm, jcfg, donate=False)(
        pair.jstate, jbatch, jax.random.PRNGKey(0))
    _, tmetrics = trainer.make_train_step(tm, tcfg)(pair.tstate, tbatch)
    if ema:
        assert float(pair.tstate.flat.view("codebook", pair.tstate.flat.grad).abs().max()) == 0
        jgrads = dict(jgrads)
        jgrads["codebook"] = jnp.zeros_like(jgrads["codebook"])
    pair.assert_grads_match(jgrads)
    assert_metrics(tmetrics, jmetrics, STEP_KEYS)
    pair.assert_states_match(jstate)
    if ema:
        for k in ("cluster", "embed_sum"):
            np.testing.assert_allclose(pair.tstate.codebook_ema[k].numpy(),
                                       np.asarray(jstate.codebook_ema[k]), atol=PARAM_ATOL,
                                       rtol=1e-5, err_msg=k)

    jout, jeval = jtrainer.make_eval_step(jm, jcfg)(jstate, jbatch)
    tout, teval = trainer.make_eval_step(tm, tcfg)(pair.tstate, tbatch)
    assert set(teval) == set(jeval) == {"loss", "loss_recons", "perplexity"}
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    for k in jeval:
        np.testing.assert_allclose(float(teval[k]), float(jeval[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bridge_round_trip_is_bit_exact(variant):
    _, v, tm, _, _ = _pair(variant)
    assert_round_trip(v, tm)


def test_bridge_needs_the_module_for_the_decoders_transpose_convs():
    """Without the module, flax's auto-names decide, and the decoder's
    ``conv_i``/``out`` would be laid out as plain convs (unflipped)."""
    _, v, tm, _, _ = _pair("raw")
    by_module = convert.flax_to_state_dict(v, tm)
    by_name = convert.flax_to_state_dict(v)
    k = v["params"]["decoder"]["out"]["kernel"]
    np.testing.assert_array_equal(by_module["decoder.out.weight"].numpy(),
                                  k[::-1].transpose(1, 2, 0))
    assert not torch.equal(by_name["decoder.out.weight"], by_module["decoder.out.weight"])
    torch.testing.assert_close(by_name["encoder.conv_0.weight"],
                               by_module["encoder.conv_0.weight"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="no port module"):
        convert.flax_to_state_dict({"params": {"nowhere": {"kernel": np.zeros((4, 2, 2))}}}, tm)


def test_init_is_seeded_and_validates():
    a = WaveVQVAE(16, 32, 3, "mulaw-quantize", 64, 2, 4, generator=torch.Generator().manual_seed(0))
    b = WaveVQVAE(16, 32, 3, "mulaw-quantize", 64, 2, 4, generator=torch.Generator().manual_seed(0))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert float(a.codebook.detach().abs().max()) <= 1 / 32 and a.hop == 8
    assert abs(float(a.input_embed.weight.std()) - 16**-0.5) < 0.05
    with pytest.raises(ValueError):
        WaveVQVAE(16, 32, 3, "mp3")
    with pytest.raises(ValueError):
        WaveVQVAE(16, 32, 3, num_quantizers=0)


# -- cli.main and cli.evaluate on a synthetic corpus ------------------------


def _corpus(root, quantize=None, n=24, sr=22050):
    """Chirps of 0.35-0.5 s (longer than the 7168-sample crop), mu-law
    integers under ``quantize`` levels as preprocessing writes them."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.ops import dsp

    os.makedirs(root)
    rng = np.random.default_rng(0)
    entries = []
    for i in range(n):
        t = np.arange(int(sr * rng.uniform(0.35, 0.5))) / sr
        f = rng.uniform(100, 300) + rng.uniform(500, 2500) * t / t[-1]
        wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr)).astype(np.float32)
        mel = dsp.melspectrogram(torch.from_numpy(wav), Config().audio).T.numpy()
        audio = wav if quantize is None else dsp.mulaw_quantize(
            torch.from_numpy(wav), quantize).numpy().astype(np.int16)
        np.save(os.path.join(root, f"a{i}.npy"), audio)
        np.save(os.path.join(root, f"m{i}.npy"), mel.astype(np.float32))
        entries.append(ManifestEntry(f"a{i}.npy", f"m{i}.npy", len(wav), "chirp"))
    write_manifest(root, entries)
    return root


def _cli(root, datadir, *extra):
    return ["--model", "wavevqvae", "--dataset", "ljspeech", "--datadir", datadir,
            "--dim", str(DIM), "--z-dim", str(Z), "--batch-size", "4", "--log-interval", "1",
            "--max-batches-per-epoch", "3", "--device", "cpu",
            "--ckpt-dir", os.path.join(root, "models"),
            "--sampledir", os.path.join(root, "results"), *extra]


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main.main(argv)
    return out.getvalue()


def test_cli_main_raw_with_ema_restarts_and_data_init(tmp_path):
    root = str(tmp_path)
    datadir = _corpus(os.path.join(root, "corpus"))
    log = _run(_cli(root, datadir, "--epochs", "2", "--ema-codebook",
                    "--restart-dead-threshold", "1.0", "--codebook-init", "data"))
    assert "codebook seeded from encoder outputs ((32, 16))" in log
    ckpt = os.path.join(root, "models", "wavevqvae", f"checkpoint_ljspeech_{DIM}_{Z}")
    assert checkpoint.latest_step(ckpt) == 6
    assert checkpoint.read_extra(ckpt) == {"epoch": 2, "arch": "wavevqvae",
                                           "num_quantizers": 1, "num_downsample": 6}
    state = torch.load(os.path.join(ckpt, "step_6", "state.pt"), weights_only=True)
    assert tuple(state["codebook_ema/cluster"].shape) == (Z,)
    logged = [float(t.split("=")[1]) for t in log.split() if t.startswith("loss=")]
    assert len(logged) == 6 and all(np.isfinite(logged))
    recon = np.load(os.path.join(root, "results", "ljspeech",
                                 f"reconstruction_wavevqvae_data_ljspeech_dim_{DIM}_z_dim_{Z}"
                                 f"_epoch_2.npy"))
    assert recon.shape[1:] == (7168, 1)  # 28 frames x hop 256, a multiple of 64
    assert os.path.exists(os.path.join(
        root, "results", "ljspeech",
        f"audio_recon_wavevqvae_data_ljspeech_dim_{DIM}_z_dim_{Z}_epoch_2.wav"))
    _run(_cli(root, datadir, "--epochs", "3", "--resume", "--ema-codebook",
              "--restart-dead-threshold", "1.0"))
    assert checkpoint.latest_step(ckpt) == 9
    means = evaluate.main(["--model", "wavevqvae", "--datadir", datadir, "--ckpt-dir", ckpt,
                           "--dim", str(DIM), "--z-dim", str(Z), "--batch-size", "4",
                           "--device", "cpu"])
    assert set(means) == {"loss", "loss_recons", "perplexity"} and np.isfinite(means["loss"])
    with pytest.raises(SystemExit, match="num_downsample=6"):
        evaluate.main(["--model", "wavevqvae", "--datadir", datadir, "--ckpt-dir", ckpt,
                       "--dim", str(DIM), "--z-dim", str(Z), "--num-downsample", "4",
                       "--device", "cpu"])


def test_cli_main_mulaw_quantize_rvq_ema_with_fewer_downsamples(tmp_path):
    root = str(tmp_path)
    datadir = _corpus(os.path.join(root, "corpus"), quantize=QC)
    preset = tmp_path / "mulaw.json"
    preset.write_text(json.dumps({"input_type": "mulaw-quantize", "quantize_channels": QC}))
    log = _run(_cli(root, datadir, "--epochs", "1", "--preset", str(preset),
                    "--num-quantizers", "2", "--num-downsample", "4",
                    "--codebook-init", "data", "--ema-codebook"))
    ckpt = os.path.join(root, "models", "wavevqvae", f"checkpoint_ljspeech_{DIM}_{Z}")
    assert checkpoint.read_extra(ckpt) == {"epoch": 1, "arch": "wavevqvae",
                                           "num_quantizers": 2, "num_downsample": 4}
    state = torch.load(os.path.join(ckpt, "step_3", "state.pt"), weights_only=True)
    assert tuple(state["params/codebook"].shape) == (2, Z, DIM)
    assert tuple(state["params/decoder.out.weight"].shape) == (DIM, QC, 4)
    assert tuple(state["codebook_ema/cluster"].shape) == (2, Z)  # per-stage statistics
    assert "codebook seeded from encoder outputs ((2, 32, 16))" in log
    recon = np.load(os.path.join(root, "results", "ljspeech",
                                 f"reconstruction_wavevqvae_data_ljspeech_dim_{DIM}_z_dim_{Z}"
                                 f"_epoch_1.npy"))
    assert recon.shape[1:] == (7168, QC)  # logits
    means = evaluate.main(["--model", "wavevqvae", "--datadir", datadir, "--ckpt-dir", ckpt,
                           "--dim", str(DIM), "--z-dim", str(Z), "--preset", str(preset),
                           "--num-quantizers", "2", "--num-downsample", "4",
                           "--batch-size", "4", "--device", "cpu"])
    assert np.isfinite(means["loss"]) and means["perplexity"] >= 1.0

"""The port's vocoder training held against the JAX package on the CPU: the
mixture-of-logistics loss (training/losses.py) and its gradient, the bf16
teacher-forced WaveNet (models/wavenet.py), one train step of each loss
(MoL, categorical cross entropy with speakers, units conditioning) in
float32 and in bf16, the eval step, and ``cli.vocoder train`` end to end on
a synthetic corpus: the artifact and its ``_ema`` and ``_train`` siblings,
``--resume`` from either, ``--multi-steps``, ``--ema-warmup``, a trained
artifact in the JAX model, ``synthesize`` and ``serve --vocoder-ckpt``.

Tolerances: the MoL loss within 1e-5 relative and its gradient within 1e-4
of the largest magnitude (elements near the 1e-5 branch switch may take the
other branch: counted and reported, not hidden); the bf16 pass within 2e-2
of the largest logit magnitude (bf16 roundings of sums in another order)
and at least 99% of its logits bit-equal (the same rounding points);
a float32 step: loss 1e-5 relative, grad_norm 1e-4 relative, parameters
and EMA 1e-5 absolute; a bf16 step: loss 2e-2 relative; the eval step 1e-5
relative; ``--multi-steps 2`` against two single steps 1e-6; a trained
artifact's logits in the JAX model 1e-5.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from neural_sound_generation_tpu.cli import vocoder as jvocoder
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.training import losses as jlosses
from neural_sound_generation_tpu.training import trainer as jtrainer
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import serve, vocoder
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, write_manifest
from neural_sound_generation_tpu_torch.training import checkpoint, losses, trainer
from torch_parity import GNORM_RTOL, LOSS_RTOL, TRAIN, TrainPair, np_tree, perturb_params

torch.set_num_threads(1)

WIDTHS = dict(residual_channels=8, layers=2, stacks=1)
CLI_WIDTHS = ["--layers", "2", "--stacks", "1", "--residual-channels", "8"]
B, T, QC, SPEAKERS, GIN = 2, 512, 32, 3, 4
PARAM_ATOL, BF16_REL, MOL_GRAD_FRAC = 1e-5, 2e-2, 1e-4


def _ns(**kw):
    return types.SimpleNamespace(**{**WIDTHS, "condition": "mel", "bf16": False, **kw})


def _cfgs(**audio_arch):
    """(JAX Config, port Config) with the parity train settings and the
    given audio/arch fields."""
    out = []
    for base in (JaxConfig(), Config()):
        audio = {k: v for k, v in audio_arch.items() if hasattr(base.audio, k)}
        arch = {k: v for k, v in audio_arch.items() if not hasattr(base.audio, k)}
        out.append(dataclasses.replace(
            base, train=dataclasses.replace(base.train, **TRAIN),
            audio=dataclasses.replace(base.audio, **audio),
            arch=dataclasses.replace(base.arch, **arch)))
    return out


# -- the mixture-of-logistics loss ------------------------------------------


def _mol_inputs(seed=0):
    """y_hat (2, 64, 30) with log-scales over [-7, 0.5] (both branches of
    the bin mass) and targets in [-1, 1] that include the edges."""
    rng = np.random.default_rng(seed)
    y_hat = rng.standard_normal((2, 64, 30)).astype(np.float32)
    y_hat[..., 10:20] = rng.uniform(-1, 1, (2, 64, 10))
    y_hat[..., 20:] = rng.uniform(-7, 0.5, (2, 64, 10))
    y = rng.uniform(-1, 1, (2, 64)).astype(np.float32)
    edges = [-1.0, 1.0, -0.9995, 0.9995, -0.999, 0.999, -0.9989, 0.9989]
    y[0, : len(edges)] = edges
    y[1, -len(edges):] = edges
    # targets at a mixture's mean, where the bin's mass is largest
    y[1, :10] = y_hat[1, :10, 10]
    return y_hat, y


def _branch_disagreements(y_hat, y, num_classes=65536):
    """Elements where JAX and the port put cdf_delta on opposite sides of
    the 1e-5 switch."""
    def delta(sig, yh, yy, exp, clamp):
        _, means, log_scales = np.split(yh, 3, axis=-1)
        inv = exp(-clamp(log_scales))
        c = yy[..., None] - means
        hb = 1.0 / (num_classes - 1)
        return sig(inv * (c + hb)) - sig(inv * (c - hb))

    jd = np.asarray(delta(jax.nn.sigmoid, jnp.asarray(y_hat), jnp.asarray(y), jnp.exp,
                          lambda s: jnp.maximum(s, -32.23619130191664)))
    td = delta(torch.sigmoid, torch.from_numpy(y_hat), torch.from_numpy(y), torch.exp,
               lambda s: torch.clamp(s, min=-32.23619130191664)).numpy()
    return int(((jd > 1e-5) != (td > 1e-5)).sum())


@pytest.mark.parametrize("num_classes", [65536, 256])
@pytest.mark.parametrize("with_lengths", [False, True])
def test_mol_loss_and_gradient_match_jax(num_classes, with_lengths):
    y_hat, y = _mol_inputs()
    lengths = np.array([64, 41], np.int32) if with_lengths else None
    jl = lambda yh: jlosses.discretized_mix_logistic_loss(  # noqa: E731
        yh, jnp.asarray(y), num_classes=num_classes,
        lengths=None if lengths is None else jnp.asarray(lengths))
    want, jgrad = jax.value_and_grad(jl)(jnp.asarray(y_hat))
    yh = torch.from_numpy(y_hat).requires_grad_(True)
    got = losses.discretized_mix_logistic_loss(
        yh, torch.from_numpy(y), num_classes=num_classes,
        lengths=None if lengths is None else torch.from_numpy(lengths))
    got.backward()
    flips = _branch_disagreements(y_hat, y, num_classes)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5,
                               err_msg=f"{flips} branch disagreements")
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(yh.grad.numpy(), jgrad,
                               atol=MOL_GRAD_FRAC * np.abs(jgrad).max(),
                               err_msg=f"{flips} branch disagreements")
    # the 3-D target layout is the same loss
    got3 = losses.discretized_mix_logistic_loss(
        torch.from_numpy(y_hat), torch.from_numpy(y)[..., None], num_classes=num_classes,
        lengths=None if lengths is None else torch.from_numpy(lengths))
    assert float(got3) == float(got.detach())


def test_mol_inputs_reach_every_branch():
    """The parity inputs take both edge branches and both sides of the
    bin-mass switch."""
    y_hat, y = _mol_inputs()
    assert (y < -0.999).sum() >= 4 and (y > 0.999).sum() >= 4
    _, means, log_scales = np.split(y_hat.astype(np.float64), 3, axis=-1)
    inv = np.exp(-log_scales)
    c = y[..., None] - means
    with np.errstate(over="ignore"):
        delta = (1 / (1 + np.exp(-inv * (c + 1 / 65535)))
                 - 1 / (1 + np.exp(-inv * (c - 1 / 65535))))
    assert (delta > 1e-5).sum() > 50 and (delta <= 1e-5).sum() > 50


def _peak_at_mean():
    M = 10
    y_hat = torch.zeros(2, 16, 3 * M)
    y_hat[..., M: 2 * M] = 0.3
    y_hat[..., 2 * M:] = -5.0
    good = losses.discretized_mix_logistic_loss(y_hat, torch.full((2, 16), 0.3), 256)
    bad = losses.discretized_mix_logistic_loss(y_hat, torch.full((2, 16), -0.8), 256)
    assert float(good) < float(bad)
    assert np.isfinite(float(good)) and np.isfinite(float(bad))


def _edge_targets():
    y_hat = torch.zeros(1, 8, 12)
    for target in (-1.0, 1.0, 0.0):
        val = losses.discretized_mix_logistic_loss(y_hat, torch.full((1, 8), target), 256)
        assert np.isfinite(float(val))


def _finite_gradient():
    rng = np.random.default_rng(0)
    y_hat = torch.from_numpy(rng.standard_normal((2, 8, 30)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (2, 8)).astype(np.float32))
    y_hat.requires_grad_(True)
    losses.discretized_mix_logistic_loss(y_hat, y).backward()
    assert torch.isfinite(y_hat.grad).all()


@pytest.mark.parametrize("case", [_peak_at_mean, _edge_targets, _finite_gradient],
                         ids=["peak_at_mean", "edge_targets", "finite_gradient"])
def test_mol_loss_properties(case):
    """The JAX tests' MoL checks (tests/test_wavevqvae.py:168-206)."""
    case()


# -- the model, bf16 and one train step -------------------------------------


def _pair(jcfg, tcfg, ns, batch, seed=0):
    """The JAX CLI's WaveNet and the port's over the same perturbed weights
    (nonzero biases)."""
    jm = jvocoder.build_model(jcfg, ns)
    x = jm.shift_inputs(jnp.asarray(batch["y"]), jcfg.audio.is_scalar_input)
    v = np_tree(jm.init(jax.random.PRNGKey(seed), x, jnp.asarray(batch["c"]),
                        None if "g" not in batch else jnp.asarray(batch["g"])))
    v = perturb_params(v, seed, scale=0.05)
    tm = vocoder.build_model(tcfg, ns)
    tm.load_state_dict(convert.flax_to_state_dict(v, tm))
    return jm, v, tm


def _batch(kind, seed=0, cin=80, frames=T // 256):
    rng = np.random.default_rng(seed)
    if kind == "categorical":
        y = rng.integers(0, QC, (B, T)).astype(np.int32)
    else:
        t = np.arange(T)[None] / T
        y = (0.7 * np.sin(2 * np.pi * rng.uniform(3, 9, (B, 1)) * t)
             + 0.05 * rng.standard_normal((B, T)))[..., None].astype(np.float32)
        y[0, :3, 0] = [-1.0, 1.0, 0.9995]
    batch = {"y": y, "c": rng.standard_normal((B, frames, cin)).astype(np.float32),
             "input_lengths": np.array([T, T - 100], np.int32)}
    if kind == "categorical":
        batch["g"] = np.array([0, 2], np.int32)
    return batch


VARIANTS = {
    "mol": (dict(), lambda: _batch("mol"), dict()),
    "categorical_speakers": (
        dict(input_type="mulaw-quantize", quantize_channels=QC, gin_channels=GIN,
             n_speakers=SPEAKERS),
        lambda: _batch("categorical"), dict()),
    "units": (dict(), lambda: _batch("mol", cin=8, frames=T // 8),
              dict(condition="units", units_dim=8, units_z_dim=16, units_downsample=3,
                   units_num_quantizers=1)),
}


def _variant(name, bf16=False):
    fields, make_batch, ns_kw = VARIANTS[name]
    jcfg, tcfg = _cfgs(**fields)
    batch = make_batch()
    jm, v, tm = _pair(jcfg, tcfg, _ns(bf16=bf16, **ns_kw), batch)
    return jcfg, tcfg, batch, jm, v, tm


@pytest.mark.parametrize("name", ["mol", "categorical_speakers"])
def test_bf16_teacher_forced_pass_matches_jax(name):
    """bf16 convolutions, bf16 h, gate and skips; embeddings, upsampler and
    the returned logits float32."""
    _, _, batch, jm, v, tm = _variant(name, bf16=True)
    assert jm.dtype == jnp.bfloat16 and tm.dtype == torch.bfloat16
    scalar = name == "mol"
    x = jm.shift_inputs(jnp.asarray(batch["y"]), scalar)
    g = batch.get("g")
    want = np.asarray(jm.apply(v, x, jnp.asarray(batch["c"]),
                               None if g is None else jnp.asarray(g)))
    with torch.no_grad():
        got = tm(torch.from_numpy(np.array(x)), torch.from_numpy(batch["c"]),
                 None if g is None else torch.from_numpy(g))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_REL * np.abs(want).max())
    # the same rounding points: nearly every logit bit-equal (an f32 pass
    # sits some 1e-2 of the largest logit away)
    assert (got.numpy() == want).mean() >= 0.99
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def _jax_step(jm, jcfg, pair, batch):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return jtrainer.make_train_step(jm, jcfg, donate=False)(
        pair.jstate, jbatch, jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_one_f32_train_step_and_eval_step_match_jax(name):
    jcfg, tcfg, batch, jm, v, tm = _variant(name)
    pair = TrainPair(jm, v, tm, jcfg, tcfg)
    jstate, jmetrics = _jax_step(jm, jcfg, pair, batch)
    tbatch = {k: torch.from_numpy(x) for k, x in batch.items()}
    _, tmetrics = trainer.make_train_step(tm, tcfg)(pair.tstate, tbatch)
    assert set(tmetrics) == set(jmetrics) == {"loss", "grad_norm"}
    np.testing.assert_allclose(float(tmetrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmetrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=GNORM_RTOL)
    ts = pair.tstate
    np.testing.assert_allclose(pair.to_jax_order(ts.flat.flat),
                               np.asarray(ravel_pytree(jstate.params)[0]), atol=PARAM_ATOL)
    np.testing.assert_allclose(pair.to_jax_order(ts.ema_params), np.asarray(jstate.ema_params),
                               atol=PARAM_ATOL)
    assert int(ts.step) == int(jstate.step) and int(ts.opt_state.count) == int(
        jstate.opt_state.count)

    jout, jeval = jtrainer.make_eval_step(jm, jcfg)(jstate, {k: jnp.asarray(x)
                                                            for k, x in batch.items()})
    tout, teval = trainer.make_eval_step(tm, tcfg)(ts, tbatch)
    assert set(teval) == set(jeval) == {"loss"}
    np.testing.assert_allclose(float(teval["loss"]), float(jeval["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-4)


@pytest.mark.parametrize("name", ["mol", "categorical_speakers"])
def test_one_bf16_train_step_matches_jax(name):
    jcfg, tcfg, batch, jm, v, tm = _variant(name, bf16=True)
    pair = TrainPair(jm, v, tm, jcfg, tcfg)
    _, jmetrics = _jax_step(jm, jcfg, pair, batch)
    _, tmetrics = trainer.make_train_step(tm, tcfg)(
        pair.tstate, {k: torch.from_numpy(x) for k, x in batch.items()})
    np.testing.assert_allclose(float(tmetrics["loss"]), float(jmetrics["loss"]), rtol=BF16_REL)
    assert pair.tstate.flat.flat.dtype == torch.float32


# -- cli.vocoder train -------------------------------------------------------


def write_corpus(root, n=12, quantize=None, speakers=0, sr=22050):
    """Chirps of 0.3-0.5 s with mels from the port's analysis; mu-law
    integers under ``quantize`` levels; speaker ids 0..speakers-1 in turn."""
    from neural_sound_generation_tpu_torch.ops import dsp

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    entries = []
    for i in range(n):
        t = np.arange(int(sr * rng.uniform(0.3, 0.5))) / sr
        f = rng.uniform(100, 300) + rng.uniform(500, 2500) * t / t[-1]
        wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr)).astype(np.float32)
        mel = dsp.melspectrogram(torch.from_numpy(wav), Config().audio).T.numpy()
        audio = wav if quantize is None else dsp.mulaw_quantize(
            torch.from_numpy(wav), quantize).numpy().astype(np.int16)
        np.save(os.path.join(root, f"a{i}.npy"), audio)
        np.save(os.path.join(root, f"m{i}.npy"), mel.astype(np.float32))
        entries.append(ManifestEntry(f"a{i}.npy", f"m{i}.npy", len(wav), "chirp",
                                     speaker_id=i % speakers if speakers else None))
    write_manifest(root, entries)
    return root


def run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        vocoder.main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs of 2 batches, then --resume for a third."""
    root = tmp_path_factory.mktemp("vocoder_train")
    datadir = write_corpus(str(root / "corpus"))
    ckpt = str(root / "wn")
    base = ["train", "--datadir", datadir, "--ckpt-dir", ckpt, "--batch-size", "2",
            "--max-batches-per-epoch", "2", "--device", "cpu", *CLI_WIDTHS]
    first = run(base + ["--epochs", "2"])
    snap = str(root / "after_two")
    for suffix in ("", "_ema", "_train"):
        shutil.copytree(ckpt + suffix, snap + suffix)
    resumed = run(base + ["--epochs", "3", "--resume"])
    return types.SimpleNamespace(root=root, datadir=datadir, ckpt=ckpt, base=base, first=first,
                                 resumed=resumed, snap=snap)


def test_artifact_and_siblings(trained):
    assert "wavenet epoch 1: loss" in trained.first and "wavenet epoch 2: loss" in trained.first
    assert f"averaged-model (EMA) artifact saved to {trained.ckpt}_ema" in trained.first
    for suffix, extra in (("", {}), ("_ema", {"averaged": True}), ("_train", {})):
        d = trained.snap + suffix
        assert checkpoint.latest_step(d) == 4
        assert checkpoint.read_extra(d) == {"epoch": 2, "condition": "mel", **extra}
    art = torch.load(os.path.join(trained.snap, "step_4", "state.pt"), weights_only=True)
    assert all(k.startswith("params/") for k in art)
    full = torch.load(os.path.join(trained.snap + "_train", "step_4", "state.pt"),
                      weights_only=True)
    assert int(full["step"]) == 4 and int(full["opt_state/count"]) == 4
    assert any(k.startswith("ema_params/") for k in full)
    assert any(k.startswith("opt_state/m/") for k in full)


def test_resume_from_the_train_sibling(trained):
    """The JAX test of the same name (tests/test_wavenet.py:523-560): the
    epoch count continues and no epoch is re-run."""
    out = trained.resumed
    assert "resumed train state from step 4, epoch 3" in out
    assert "wavenet epoch 3:" in out and "wavenet epoch 2:" not in out
    assert checkpoint.latest_step(trained.ckpt) == 6
    assert checkpoint.read_extra(trained.ckpt + "_train")["epoch"] == 3
    losses_by_epoch = [float(line.split("loss ")[1]) for line in
                       (trained.first + out).splitlines() if line.startswith("wavenet epoch")]
    assert len(losses_by_epoch) == 3 and all(np.isfinite(losses_by_epoch))
    assert losses_by_epoch[-1] < losses_by_epoch[0]


def test_resume_from_the_artifact_alone(trained, tmp_path):
    ckpt = str(tmp_path / "wn")
    shutil.copytree(trained.snap, ckpt)
    shutil.copytree(trained.snap + "_ema", ckpt + "_ema")
    base = [a if a != trained.ckpt else ckpt for a in trained.base]
    out = run(base + ["--epochs", "3", "--resume"])
    assert ("resumed params from step 4, epoch 3 (no *_train sibling: Adam moments restart)"
            in out)
    assert "wavenet epoch 3:" in out and "wavenet epoch 2:" not in out
    assert checkpoint.latest_step(ckpt) == 6 and checkpoint.latest_step(ckpt + "_train") == 6
    full = torch.load(os.path.join(ckpt + "_train", "step_6", "state.pt"), weights_only=True)
    assert int(full["step"]) == 6 and int(full["opt_state/count"]) == 2


def _params(ckpt, step=None):
    d = os.path.join(ckpt, f"step_{step or checkpoint.latest_step(ckpt)}", "state.pt")
    return torch.load(d, weights_only=True)


def test_multi_steps_equal_single_steps(trained, tmp_path):
    """--multi-steps 2 over an epoch of 2 batches: the same parameters as
    two single steps, within 1e-6."""
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    base = [a for a in trained.base]
    run([one if a == trained.ckpt else a for a in base] + ["--epochs", "1"])
    run([two if a == trained.ckpt else a for a in base] + ["--epochs", "1", "--multi-steps", "2"])
    a, b = _params(one), _params(two)
    assert checkpoint.latest_step(one) == checkpoint.latest_step(two) == 2
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=1e-6, err_msg=k)


def test_ema_warmup(trained, tmp_path):
    """Without the warmup the shadow stays at the initial weights (decay
    0.9999 over 2 steps); with it the decay starts near 0.18 and the shadow
    follows the live parameters."""
    base = list(trained.base)
    out = {}
    for tag, extra in (("plain", []), ("warm", ["--ema-warmup"])):
        ckpt = str(tmp_path / tag)
        run([ckpt if a == trained.ckpt else a for a in base] + ["--epochs", "1", *extra])
        live, ema = _params(ckpt), _params(ckpt + "_ema")
        out[tag] = sum(float((live[k] - ema[k]).abs().sum()) for k in live)
    assert out["warm"] < 0.5 * out["plain"]


def test_trained_artifact_in_the_jax_model(trained):
    """The artifact converted to the flax tree: JAX's logits equal the
    port's within 1e-5, and the JAX CLI's own restore template matches it."""
    tm = vocoder.build_model(Config(), _ns())
    checkpoint.restore_params(trained.ckpt, tm)
    v = convert.module_to_flax(tm)
    jm = jvocoder.build_model(JaxConfig(), _ns())
    rng = np.random.default_rng(3)
    y = rng.uniform(-0.5, 0.5, (1, 256, 1)).astype(np.float32)
    c = rng.standard_normal((1, 1, 80)).astype(np.float32)
    template = jm.init(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(c), None)
    assert (jax.tree_util.tree_structure(template["params"])
            == jax.tree_util.tree_structure(v["params"]))
    want = np.asarray(jm.apply(v, jnp.asarray(y), jnp.asarray(c)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(y), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_synthesize_and_serve_restore_the_trained_artifact(trained, tmp_path):
    from scipy.io import wavfile

    mel = str(tmp_path / "mel.npy")
    np.save(mel, np.load(os.path.join(trained.datadir, "m0.npy")))
    for ckpt in (trained.ckpt, trained.ckpt + "_ema"):
        out = str(tmp_path / "o.wav")
        log = run(["synthesize", "--ckpt-dir", ckpt, "--mel-npy", mel, "--output", out,
                   "--max-frames", "2", "--device", "cpu", *CLI_WIDTHS])
        assert "synthesized 512 samples" in log
        wav = wavfile.read(out)[1]
        assert len(wav) == 512 and np.isfinite(wav.astype(np.float64)).all()
    model = serve.load_serving_vocoder(serve.parse_args([
        "--device", "cpu", "--vocoder", "wavenet", "--vocoder-ckpt", trained.ckpt,
        "--vocoder-layers", "2", "--vocoder-stacks", "1", "--vocoder-residual-channels", "8"]),
        Config(), torch.device("cpu"))
    want = _params(trained.ckpt)
    for k, p in model.named_parameters():
        assert torch.equal(p.detach(), want[f"params/{k}"]), k


def test_bf16_and_categorical_speakers_train(tmp_path):
    """--bf16 trains and writes float32 weights that synthesize restores;
    mulaw-quantize with speakers (a preset with gin_channels) trains on the
    masked cross entropy and synthesizes with --speaker-id."""
    datadir = write_corpus(str(tmp_path / "corpus"))
    ckpt = str(tmp_path / "bf16")
    log = run(["train", "--datadir", datadir, "--ckpt-dir", ckpt, "--batch-size", "2",
               "--max-batches-per-epoch", "2", "--epochs", "1", "--bf16", "--device", "cpu",
               *CLI_WIDTHS])
    assert "wavenet epoch 1: loss" in log
    assert all(t.dtype == torch.float32 for t in _params(ckpt).values())

    mu = write_corpus(str(tmp_path / "mu"), quantize=QC, speakers=2)
    preset = tmp_path / "mu.json"
    preset.write_text(json.dumps({"input_type": "mulaw-quantize", "quantize_channels": QC,
                                  "gin_channels": GIN, "n_speakers": 2}))
    ckpt = str(tmp_path / "mu_wn")
    log = run(["train", "--datadir", mu, "--ckpt-dir", ckpt, "--batch-size", "2",
               "--max-batches-per-epoch", "2", "--epochs", "1", "--preset", str(preset),
               "--device", "cpu", *CLI_WIDTHS])
    loss = float(log.split("wavenet epoch 1: loss ")[1].split()[0])
    assert abs(loss - np.log(QC)) < 1.0  # cross entropy near uniform after 2 steps
    params = _params(ckpt)
    assert tuple(params["params/speaker_embed.weight"].shape) == (2, GIN)
    assert tuple(params["params/post2.weight"].shape) == (QC, 8, 1)
    mel = str(tmp_path / "mel.npy")
    np.save(mel, np.load(os.path.join(mu, "m0.npy")))
    out = str(tmp_path / "o.wav")
    run(["synthesize", "--ckpt-dir", ckpt, "--mel-npy", mel, "--output", out, "--preset",
         str(preset), "--max-frames", "1", "--speaker-id", "1", "--device", "cpu", *CLI_WIDTHS])
    assert os.path.exists(out)

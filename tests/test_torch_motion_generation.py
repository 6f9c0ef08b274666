"""The motion path's model, generator and CLI held against the JAX package
on the CPU, both in one process, at dim 16 and 32 codes with the JAX weights
carried over by the bridge: the feature-conditioned VQ-VAE's ``forward``,
``decode`` and ``decode_from_features`` at Q = 1 and Q = 2 (codes equal,
outputs within 1e-5), ``MotionDrivenGenerator`` window by window, and
``cli.motion`` end to end with ``--device cpu``, including ``generate
--ckpt-dir`` on a ``cli.main`` checkpoint, which fills only
``feature_proj`` as the JAX CLI does."""

import logging
import os
import re
import shutil
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.cli import motion as jcli
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu.models import VQVAE as JaxVQVAE
from neural_sound_generation_tpu.motion import capture as jcap
from neural_sound_generation_tpu.motion import pca as jpca
from neural_sound_generation_tpu.motion.inference import (
    MotionDrivenGenerator as JaxGenerator,
)
from neural_sound_generation_tpu.ops.vq import residual_vq as jax_residual_vq
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import main as cli_main
from neural_sound_generation_tpu_torch.cli import motion as cli
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import VQVAE
from neural_sound_generation_tpu_torch.motion import capture, pca
from neural_sound_generation_tpu_torch.motion.inference import MotionDrivenGenerator
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.ops.vq import residual_vq, vq
from neural_sound_generation_tpu_torch.training import checkpoint, train_state
from torch_parity import assert_round_trip, np_tree, perturb_params, perturb_stats

jax_vq = __import__("importlib").import_module("neural_sound_generation_tpu.ops.vq").vq

torch.set_num_threads(1)

DIM, Z_DIM, F = 16, 32, 3
ATOL = 1e-5
LATENT_HW = (20, 4)


def _pair(num_quantizers=1, n_speakers=0, gin=-1, seed=0):
    """A JAX feature-conditioned VQ-VAE with perturbed weights and
    statistics, its codebook half on the scale of the encoder's output and
    half on the projected features' (so both paths pick varied codes), and
    the port's copy of it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 80, 16, 1)).astype(np.float32)
    kw = {"g": jnp.zeros((1,), jnp.int32)} if n_speakers else {}
    jm = JaxVQVAE(input_dim=1, dim=DIM, z_dim=Z_DIM, cond_features=F,
                  num_quantizers=num_quantizers, n_speakers=n_speakers, gin_channels=gin)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x[:1]), train=False,
                features=jnp.zeros((1, F)), **kw)
    v = perturb_stats(perturb_params(np_tree(v), seed + 1), seed + 2)
    ze = np.asarray(jm.apply(v, jnp.asarray(x), train=False)[1]).reshape(-1, DIM)
    emb = np.asarray(jm.apply(v, jnp.asarray(_latents(rng, 64)),
                              method=lambda m, f: m.feature_proj(f)))
    half = Z_DIM // 2
    rows = np.concatenate([ze[rng.choice(len(ze), half, replace=False)],
                           emb[rng.choice(len(emb), Z_DIM - half, replace=False)]])
    cb = (rows + 0.01 * rng.standard_normal(rows.shape)).astype(np.float32)
    if num_quantizers > 1:
        cb = np.stack([cb] + [0.3 * rng.standard_normal(cb.shape).astype(np.float32)
                              for _ in range(num_quantizers - 1)])
    v["params"]["codebook"] = cb
    tm = VQVAE(1, DIM, Z_DIM, n_speakers, gin, num_quantizers=num_quantizers,
               cond_features=F)
    tm.load_state_dict(convert.flax_to_state_dict(v, tm))
    return jm, v, tm.eval(), x


def _latents(rng, n):
    return (2.0 * rng.standard_normal((n, F))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_feature_codes(jm, v, feats, q):
    emb = jm.apply(v, jnp.asarray(feats), method=lambda m, f: m.feature_proj(f))
    if q > 1:
        return np.asarray(jax_residual_vq(emb, jnp.asarray(v["params"]["codebook"]))[2])
    return np.asarray(jax_vq(emb, jnp.asarray(v["params"]["codebook"])))


def _port_feature_codes(tm, feats):
    with torch.no_grad():
        emb = tm.feature_proj(_t(feats))
        if tm.num_quantizers > 1:
            return residual_vq(emb, tm.codebook)[2].numpy()
        return vq(emb, tm.codebook).numpy()


@pytest.mark.parametrize("q", [1, 2])
def test_decode_from_features_matches_jax(q):
    jm, v, tm, _ = _pair(num_quantizers=q, seed=q)
    rng = np.random.default_rng(10 + q)
    feats = _latents(rng, 6)
    codes = _port_feature_codes(tm, feats)
    np.testing.assert_array_equal(codes, _jax_feature_codes(jm, v, feats, q))
    assert len(np.unique(codes)) > 1
    want = np.asarray(jm.apply(v, jnp.asarray(feats), LATENT_HW, train=False,
                               method=JaxVQVAE.decode_from_features))
    with torch.no_grad():
        got = tm.decode_from_features(_t(feats), LATENT_HW).numpy()
    assert got.shape == want.shape == (6, 80, 16, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("q, speakers", [(1, False), (2, False), (1, True)],
                         ids=["q1", "q2", "q1_speakers"])
def test_forward_and_decode_with_features_match_jax(q, speakers):
    """The feature term rides on the straight-through codes in ``forward``
    and on the looked-up codes in ``decode``; with speakers, the speaker term
    comes first (JAX's order)."""
    jm, v, tm, x = _pair(num_quantizers=q, n_speakers=3 if speakers else 0,
                         gin=4 if speakers else -1, seed=5 + q)
    feats = _latents(np.random.default_rng(20 + q), 2)
    g = np.array([2, 1], np.int32)
    jkw = {"features": jnp.asarray(feats)}
    tkw = {"features": _t(feats)}
    if speakers:
        jkw["g"], tkw["g"] = jnp.asarray(g), _t(g)
    jx, jze, jzq = jm.apply(v, jnp.asarray(x), train=False, **jkw)
    with torch.no_grad():
        tx, tze, tzq = tm(_t(x), **tkw)
    for got, want in ((tx, jx), (tze, jze), (tzq, jzq)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    jcodes = np.asarray(jm.apply(v, jnp.asarray(x), method=JaxVQVAE.encode))
    with torch.no_grad():
        tcodes = tm.encode(_t(x))
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    want = np.asarray(jm.apply(v, jnp.asarray(jcodes), train=False,
                               method=JaxVQVAE.decode, **jkw))
    with torch.no_grad():
        got = tm.decode(tcodes, **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    with torch.no_grad():
        plain = tm.decode(tcodes, g=tkw.get("g")).numpy()
    assert np.abs(plain - got).max() > 1e-3  # the features take part


@pytest.mark.parametrize("q", [1, 2])
def test_bridge_carries_feature_proj_both_ways(q):
    _, v, tm, _ = _pair(num_quantizers=q)
    sd = convert.flax_to_state_dict(v, tm)
    np.testing.assert_array_equal(sd["feature_proj.weight"].numpy(),
                                  v["params"]["feature_proj"]["kernel"].T)
    np.testing.assert_array_equal(sd["feature_proj.bias"].numpy(),
                                  v["params"]["feature_proj"]["bias"])
    assert_round_trip(v, tm)  # the tree and a JAX-order flat vector, bit-exact
    flat = train_state.FlatParams(tm)
    assert "feature_proj.weight" in flat.names and "feature_proj.bias" in flat.names


def test_models_without_features_are_unchanged():
    plain = VQVAE(1, DIM, Z_DIM, generator=torch.Generator().manual_seed(3))
    assert not any("feature_proj" in k for k in plain.state_dict())
    again = VQVAE(1, DIM, Z_DIM, generator=torch.Generator().manual_seed(3), cond_features=0)
    for (ka, a), (kb, b) in zip(plain.state_dict().items(), again.state_dict().items()):
        assert ka == kb
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cond_features"):
        plain.decode_from_features(torch.zeros(1, F), LATENT_HW)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """A 120-frame synthetic recording (7 full windows of 16 and one of 8)
    and both packages' projectors fitted on it."""
    root = tmp_path_factory.mktemp("motion")
    csv = str(root / "session.csv")
    c = capture.synthetic_controller(seed=3, n_frames=120)
    try:
        c.record_csv(csv, 120)
    finally:
        c.close()
    return csv, pca.load_pca(csv, F), jpca.load_pca(csv, F)


def test_generator_run_stream_matches_jax_window_by_window(session):
    csv, proj, jproj = session
    jm, v, tm, _ = _pair(seed=11)
    cfg = Config().audio
    jgen = JaxGenerator(jm, v, jproj, JaxConfig().audio, latent_hw=LATENT_HW)
    gen = MotionDrivenGenerator(tm, proj, cfg, LATENT_HW, device="cpu")
    windows = {}
    for name, mod, g in (("port", capture, gen), ("jax", jcap, jgen)):
        rep = mod.replay_controller(csv)
        try:
            windows[name] = list(g.run_stream(rep, window=16))
        finally:
            rep.close()
    assert len(windows["port"]) == len(windows["jax"]) == 8
    codes = []
    for (lat, mel), (jlat, jmel) in zip(windows["port"], windows["jax"]):
        assert isinstance(mel, np.ndarray) and mel.shape == (80, 16)
        np.testing.assert_allclose(lat, jlat, atol=1e-8)
        np.testing.assert_allclose(mel, np.asarray(jmel), atol=ATOL)
        pooled = lat.mean(axis=0, keepdims=True).astype(np.float32)
        codes.append(_port_feature_codes(tm, pooled)[0])
        assert codes[-1] == _jax_feature_codes(
            jm, v, jlat.mean(axis=0, keepdims=True).astype(np.float32), 1)[0]
    assert windows["port"][-1][0].shape == (8, F)
    assert not np.allclose(windows["port"][0][1], windows["port"][-1][1])


def test_generator_frames_to_mel_and_audio(session):
    csv, proj, jproj = session
    jm, v, tm, _ = _pair(seed=12)
    frames = np.genfromtxt(csv, delimiter=",")[::12]  # 10 frames, one batch
    gen = MotionDrivenGenerator(tm, proj, Config().audio, LATENT_HW, device="cpu")
    mel = gen.frames_to_mel(frames)
    want = JaxGenerator(jm, v, jproj, JaxConfig().audio, LATENT_HW).frames_to_mel(frames)
    assert mel.shape == (10, 80, 16)
    np.testing.assert_allclose(mel.numpy(), np.asarray(want), atol=ATOL)
    angles = torch.rand(10, 16, 513, generator=torch.Generator().manual_seed(0)) * 6.28
    audio = gen.frames_to_audio(frames[:2], init_angles=angles[:2])
    ref = dsp.inv_mel_spectrogram_batch(mel[:2], Config().audio, init_angles=angles[:2])
    assert audio.shape == (2, 15 * 256)
    torch.testing.assert_close(audio, ref, rtol=0, atol=0)
    drawn = [gen.frames_to_audio(frames[:2], torch.Generator().manual_seed(4)) for _ in "ab"]
    assert torch.equal(*drawn) and torch.isfinite(drawn[0]).all()
    with pytest.raises(AssertionError, match="conditioning features"):
        MotionDrivenGenerator(tm, pca.PCAProjector.fit(frames, 2), Config().audio,
                              device="cpu")


def test_cli_capture_analyze_watch_match_jax(tmp_path, capsys):
    outs = {}
    for name, mod in (("port", cli), ("jax", jcli)):
        csv = str(tmp_path / f"{name}.csv")
        mod.main(["capture", csv, "--frames", "64", "--seed", "2"])
        mod.main(["analyze", csv])
        mod.main(["watch", "--frames", "5", "--fps", "500"])
        outs[name] = capsys.readouterr().out.replace(csv, "<csv>").splitlines()
    with open(tmp_path / "port.csv", "rb") as a, open(tmp_path / "jax.csv", "rb") as b:
        assert a.read() == b.read()
    assert outs["port"][:3] == outs["jax"][:3]  # capture and analyze
    frames = [ln for ln in outs["port"] if ln.startswith("frame ")]
    assert frames[:5] == [ln for ln in outs["jax"] if ln.startswith("frame ")][:5]
    assert "64 frames x 18 features -> 3 components" in outs["port"][1]


def test_cli_watch_gestures_prints_every_gesture_type(capsys):
    cli.main(["watch", "--gestures", "--fps", "1000"])
    out = capsys.readouterr().out
    assert "Circle" in out and "clockwise" in out and "degrees" in out
    assert "Swipe" in out and "key_tap" in out and "screen_tap" in out
    # the lines render as the JAX CLI renders the same events
    c = capture.scripted_gesture_controller(fps=60.0)
    jc = jcap.scripted_gesture_controller(fps=60.0)
    try:
        c.drain(len(c))
        jc.drain(len(jc))
        events, jevents = c.poll_gestures(4096), jc.poll_gestures(4096)
    finally:
        c.close()
        jc.close()
    mine, theirs = {}, {}
    assert ([cli._describe_gesture(e, mine) for e in events]
            == [jcli._describe_gesture(e, theirs) for e in jevents])


def test_cli_analyze_single_row_csv(tmp_path, capsys):
    path = tmp_path / "one.csv"
    np.savetxt(path, np.linspace(0.0, 1.0, 22)[None], delimiter=",")
    cli.cmd_analyze(types.SimpleNamespace(input_csv=str(path), components=1))
    assert "1 frames x 22 features -> 1 components" in capsys.readouterr().out


def test_cli_generate_without_a_checkpoint(tmp_path, capsys):
    csv, wav = str(tmp_path / "cap.csv"), str(tmp_path / "gen.wav")
    cli.main(["capture", csv, "--frames", "64", "--seed", "2"])
    cli.main(["generate", csv, wav, "--dim", "8", "--z-dim", "16", "--max-windows", "3",
              "--device", "cpu"])
    assert "generated 3 windows" in capsys.readouterr().out
    from scipy.io import wavfile

    sr, data = wavfile.read(wav)
    assert sr == 22050 and data.shape == ((3 * 16 - 1) * 256,)
    assert np.abs(data).max() > 0


def _filled(records):
    return sorted(m.group(1) for r in records
                  if (m := re.search(r"missing '([^']+)'", r.getMessage())))


@pytest.fixture(scope="module")
def main_ckpt(tmp_path_factory):
    """A checkpoint written by the port's ``cli.main`` (dim 32, 64 codes,
    one epoch of four batches), and its capture."""
    from test_torch_cli_train import DIM as MAIN_DIM
    from test_torch_cli_train import Z_DIM as MAIN_Z
    from test_torch_cli_train import _corpus, _train_args

    root = tmp_path_factory.mktemp("ckpt")
    os.makedirs(root / "corpus")
    cli_main.main(_train_args(root, _corpus(root / "corpus", n=24), "--epochs", "1"))
    ckpt = os.path.join(root, "models", "vqvae", f"checkpoint_ljspeech_{MAIN_DIM}_{MAIN_Z}")
    csv = str(root / "cap.csv")
    cli.main(["capture", csv, "--frames", "48"])
    return ckpt, csv, MAIN_DIM, MAIN_Z


def _generate_args(csv, out, dim, z, ckpt=None):
    argv = ["generate", csv, out, "--dim", str(dim), "--z-dim", str(z), "--device", "cpu",
            "--max-windows", "2"]
    return argv + (["--ckpt-dir", ckpt] if ckpt else [])


def test_generate_restores_a_cli_main_checkpoint_filling_only_feature_proj(
        main_ckpt, tmp_path, caplog):
    ckpt, csv, dim, z = main_ckpt
    args = cli.parse_args(_generate_args(csv, str(tmp_path / "o.wav"), dim, z, ckpt))
    with caplog.at_level(logging.WARNING, logger="nsg.checkpoint"):
        model = cli.build_model(args)
    assert _filled(caplog.records) == ["params/feature_proj"]
    src = torch.load(os.path.join(ckpt, f"step_{checkpoint.latest_step(ckpt)}", "state.pt"),
                     weights_only=True)
    fresh = VQVAE(1, dim, z, cond_features=F, generator=torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        want = fresh.get_parameter(name) if name.startswith("feature_proj.") \
            else src[f"params/{name}"]
        assert torch.equal(p, want), name
    for name, b in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(b, src[f"batch_stats/{name}"]), name
    assert not torch.equal(model.codebook, fresh.codebook)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="nsg.checkpoint"):
        cli.main(_generate_args(csv, str(tmp_path / "o.wav"), dim, z, ckpt))
    assert _filled(caplog.records) == ["params/feature_proj"]
    assert os.path.getsize(tmp_path / "o.wav") > 44


def test_the_jax_cli_fills_the_same_leaves(tmp_path, caplog):
    """The JAX CLI's ``generate --ckpt-dir`` on an unconditioned checkpoint
    of its own (what its ``cli.main`` writes) fills the same subtree."""
    from neural_sound_generation_tpu.training import checkpoint as jckpt
    from neural_sound_generation_tpu.training import create_train_state

    jm = JaxVQVAE(input_dim=1, dim=8, z_dim=16)
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 80, 16, 1)), train=False)
    ckpt = str(tmp_path / "jax_ckpt")
    jckpt.save(ckpt, create_train_state(v, JaxConfig().train), 1, {"epoch": 1})
    csv = str(tmp_path / "cap.csv")
    cli.main(["capture", csv, "--frames", "32"])
    argv = _generate_args(csv, str(tmp_path / "j.wav"), 8, 16, ckpt)
    argv.remove("--device")
    argv.remove("cpu")
    with caplog.at_level(logging.WARNING, logger="nsg.checkpoint"):
        jcli.main(argv)
    assert _filled(caplog.records) == ["params/feature_proj"]


def test_generate_refuses_a_wrong_dim_and_restore_stays_strict(main_ckpt, tmp_path):
    ckpt, csv, dim, z = main_ckpt
    with pytest.raises(ValueError, match="does not match"):
        cli.main(_generate_args(csv, str(tmp_path / "o.wav"), 2 * dim, z, ckpt))
    model = VQVAE(1, dim, z, cond_features=F)
    with pytest.raises(ValueError, match="feature_proj"):
        checkpoint.restore_model(ckpt, model)
    with pytest.raises(ValueError, match="feature_proj"):
        checkpoint.restore(ckpt, train_state.create_train_state(model, Config().train))
    # a checkpoint that lacks another leaf still refuses under the fill rule
    broken = str(tmp_path / "broken")
    step = checkpoint.latest_step(ckpt)
    shutil.copytree(os.path.join(ckpt, f"step_{step}"), os.path.join(broken, f"step_{step}"))
    path = os.path.join(broken, f"step_{step}", "state.pt")
    src = torch.load(path, weights_only=True)
    del src["params/encoder.Conv_0.bias"]
    torch.save(src, path)
    with pytest.raises(ValueError, match="encoder.Conv_0.bias"):
        checkpoint.restore_model(broken, model, fill=cli.FILLED_FROM_INIT)

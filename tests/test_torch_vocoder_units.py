"""The port's units -> WaveNet chain on the CPU: a WaveVQVAE trained by
``cli.main --model wavevqvae``, its quantized latents through the chain's
encoder held against the JAX model on the same weights, ``cli.vocoder
train --condition units`` and ``synthesize --condition units --wav-in``
(the port's version of the JAX test ``tests/test_cli.py:354-400``), the
units WaveNet's weight bridge, and every refusal of the recorded chain
(``_check_condition_meta``, held to the JAX CLI's own on the same
metadata) and of ``synthesize``.

Tolerances: the units within 1e-5 (float32 convolutions summed in another
order; the codes equal); the bridge bit-exact.
"""

import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.cli import vocoder as jvocoder
from neural_sound_generation_tpu.models import WaveVQVAE as JaxWave
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import main as cli_main
from neural_sound_generation_tpu_torch.cli import vocoder
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from test_torch_vocoder_train import CLI_WIDTHS, run, write_corpus
from torch_parity import assert_round_trip, np_tree

torch.set_num_threads(1)

DIM, Z, NDOWN = 8, 16, 3
UNITS = ["--condition", "units", "--units-dim", str(DIM), "--units-z-dim", str(Z),
         "--units-downsample", str(NDOWN)]


def _units_ns(**kw):
    return types.SimpleNamespace(**{
        "condition": "units", "units_dim": DIM, "units_z_dim": Z, "units_downsample": NDOWN,
        "units_num_quantizers": 1, "units_vqvae_ckpt": None, **kw})


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A WaveVQVAE of 2 steps (EMA shadow on), then a units WaveNet of one
    epoch of 2 batches on its units."""
    root = tmp_path_factory.mktemp("units")
    datadir = write_corpus(str(root / "corpus"))
    cli_main.main(["--model", "wavevqvae", "--dataset", "ljspeech", "--datadir", datadir,
                   "--dim", str(DIM), "--z-dim", str(Z), "--num-downsample", str(NDOWN),
                   "--batch-size", "2", "--epochs", "1", "--max-batches-per-epoch", "2",
                   "--log-interval", "0", "--device", "cpu",
                   "--ckpt-dir", str(root / "models"), "--sampledir", str(root / "results")])
    units_ckpt = str(root / "models" / "wavevqvae" / f"checkpoint_ljspeech_{DIM}_{Z}")
    units = UNITS + ["--units-vqvae-ckpt", units_ckpt]
    wn = str(root / "wn_units")
    log = run(["train", "--datadir", datadir, "--ckpt-dir", wn, "--batch-size", "2",
               "--epochs", "1", "--max-batches-per-epoch", "2", "--device", "cpu",
               *CLI_WIDTHS, *units])
    wav = str(root / "source.wav")
    dsp.save_wav(0.3 * np.load(os.path.join(datadir, "a0.npy")), wav, 22050)
    return types.SimpleNamespace(root=root, datadir=datadir, units_ckpt=units_ckpt,
                                 units=units, wn=wn, log=log, wav=wav)


def test_units_train_writes_the_chain_metadata(chain):
    assert "wavenet epoch 1: loss" in chain.log
    meta = {"condition": "units", "units_dim": DIM, "units_z_dim": Z,
            "units_downsample": NDOWN, "units_num_quantizers": 1}
    assert checkpoint.latest_step(chain.wn) == 2
    assert checkpoint.read_extra(chain.wn) == {"epoch": 1, **meta}
    assert checkpoint.read_extra(chain.wn + "_train") == {"epoch": 1, **meta}
    params = torch.load(os.path.join(chain.wn, "step_2", "state.pt"), weights_only=True)
    # cin = the units' width; the upsampler by the unit hop 2^3: scales (4, 2)
    assert tuple(params["params/cond_0.weight"].shape) == (8, DIM, 1)
    assert tuple(params["params/upsampler.ConvTranspose_1.weight"].shape) == (DIM, DIM, 4)
    assert "params/upsampler.ConvTranspose_2.weight" not in params


def test_resynthesize_through_the_units(chain, tmp_path):
    """wav -> units -> WaveNet: 6 unit frames of hop 8, finite."""
    out = str(tmp_path / "resynth.wav")
    log = run(["synthesize", "--ckpt-dir", chain.wn, "--wav-in", chain.wav, "--output", out,
               "--max-frames", "6", "--device", "cpu", *CLI_WIDTHS, *chain.units])
    assert "synthesized 48 samples" in log
    w = dsp.load_wav(out, 22050)
    assert w.size == 6 * 8 and np.isfinite(w).all()


def test_units_encoder_is_the_ema_shadow_and_matches_jax(chain):
    """The chain's encoder takes the checkpoint's EMA shadow and its batch
    statistics in eval mode; its units equal the JAX model's
    ``quantized_latents`` on the same weights."""
    cfg = Config()
    units_fn, model = vocoder._build_units_encoder(
        _units_ns(units_vqvae_ckpt=chain.units_ckpt), cfg, torch.device("cpu"))
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    ref = cli_main.make_model(cli_main.build_config(cli_main.parse_args([
        "--model", "wavevqvae", "--dim", str(DIM), "--z-dim", str(Z), "--num-downsample",
        str(NDOWN), "--device", "cpu"])))
    state, _ = checkpoint.restore(chain.units_ckpt, create_train_state(ref, cfg.train))
    assert state.ema_params is not None
    assert not torch.equal(state.ema_params, state.flat.flat)
    for (name, p), want in zip(model.named_parameters(), state.flat.split(state.ema_params)):
        assert torch.equal(p, want), name
    x = np.load(os.path.join(chain.datadir, "a1.npy"))[: 40 * 8]
    x = torch.from_numpy(x.astype(np.float32))[None, :, None]
    got = units_fn(x)
    assert tuple(got.shape) == (1, 40, DIM)
    jm = JaxWave(dim=DIM, z_dim=Z, num_downsample=NDOWN)
    v = convert.module_to_flax(model)
    want = np.asarray(jm.apply(v, jnp.asarray(x.numpy()), train=False,
                               method=JaxWave.quantized_latents))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("n", range(1, 8))
def test_units_scales_match_jax(n):
    assert vocoder._units_scales(n) == jvocoder._units_scales(n)
    assert int(np.prod(vocoder._units_scales(n))) == 2**n


def test_units_wavenet_bridge_round_trip():
    """The units WaveNet's upsampler (scales (4, 2) over 8 channels) and its
    cond convs map by name, as the mel WaveNet's do."""
    ns = _units_ns(residual_channels=8, layers=2, stacks=1, bf16=False)
    jm = jvocoder.build_model(jvocoder._load_cfg(types.SimpleNamespace(preset=None)), ns)
    v = np_tree(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 1)),
                        jnp.zeros((1, 2, DIM)), None))
    assert_round_trip(v, vocoder.build_model(Config(), ns))


META = {"condition": "units", "units_dim": DIM, "units_z_dim": Z, "units_downsample": NDOWN,
        "units_num_quantizers": 1}


@pytest.mark.parametrize("ns,extra", [
    (dict(condition="mel"), META),
    (dict(), {"condition": "mel"}),
    (dict(units_dim=16), META),
    (dict(units_z_dim=32), META),
    (dict(units_downsample=4), META),
    (dict(units_num_quantizers=2), META),
], ids=["mel_flags_units_ckpt", "units_flags_mel_ckpt", "units_dim", "units_z_dim",
        "units_downsample", "units_num_quantizers"])
def test_check_condition_meta_refuses_as_jax_does(ns, extra):
    args = _units_ns(**ns)
    with pytest.raises(SystemExit) as want:
        jvocoder._check_condition_meta(args, extra)
    with pytest.raises(SystemExit) as got:
        vocoder._check_condition_meta(args, extra)
    assert str(got.value) == str(want.value)
    assert vocoder._condition_meta(args) == jvocoder._condition_meta(args)


def test_check_condition_meta_passes_what_matches():
    for args, extra in ((_units_ns(), META), (_units_ns(), None),
                        (_units_ns(condition="mel"), {"condition": "mel"}), (_units_ns(), {})):
        vocoder._check_condition_meta(args, extra)
        jvocoder._check_condition_meta(args, extra)


def test_units_refusals(chain, tmp_path):
    out = str(tmp_path / "o.wav")
    base = ["synthesize", "--ckpt-dir", chain.wn, "--output", out, "--device", "cpu",
            *CLI_WIDTHS]
    with pytest.raises(SystemExit, match="--condition units synthesize needs --wav-in"):
        vocoder.main(base + chain.units)
    short = str(tmp_path / "short.wav")
    dsp.save_wav(np.zeros(5, np.float32), short, 22050)
    with pytest.raises(SystemExit, match=r"--wav-in shorter than one unit hop \(8 samples\)"):
        vocoder.main(base + chain.units + ["--wav-in", short])
    with pytest.raises(SystemExit, match="requires --units-vqvae-ckpt"):
        vocoder.main(base + UNITS + ["--wav-in", chain.wav])
    with pytest.raises(SystemExit, match="trained with --condition units"):
        vocoder.main(base + ["--mel-npy", "unused.npy"])
    with pytest.raises(SystemExit, match="units_dim=8 does not match --units-dim 16"):
        vocoder.main(base + chain.units + ["--wav-in", chain.wav, "--units-dim", "16"])
    # --resume checks the recorded chain before it restores anything
    with pytest.raises(SystemExit, match="trained with --condition units"):
        vocoder.main(["train", "--datadir", chain.datadir, "--ckpt-dir", chain.wn,
                      "--epochs", "2", "--resume", "--device", "cpu", *CLI_WIDTHS])
    # a units checkpoint of another width refuses at restore
    with pytest.raises(SystemExit, match="num_downsample=3"):
        vocoder._build_units_encoder(
            _units_ns(units_vqvae_ckpt=chain.units_ckpt, units_downsample=4), Config(),
            torch.device("cpu"))

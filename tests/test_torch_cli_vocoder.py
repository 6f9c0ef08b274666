"""The port's vocoder CLI (cli/vocoder.py) on the CPU: ``synthesize`` from
an artifact converted from a JAX WaveNet built by the JAX CLI's own
``build_model``, the recorded-chain refusal at every restore surface
(``synthesize`` and ``serve --vocoder-ckpt``), ``train`` (plain, and with
``--bf16 --multi-steps 4``) and ``synthesize --condition units`` running,
and the flags of more than one device raising NotImplementedError."""

import argparse
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_sound_generation_tpu.cli import vocoder as jvocoder
from neural_sound_generation_tpu.config import Config as JaxConfig
from neural_sound_generation_tpu_torch import convert
from neural_sound_generation_tpu_torch.cli import serve, vocoder
from neural_sound_generation_tpu_torch.config import Config
from neural_sound_generation_tpu_torch.models import WaveVQVAE
from neural_sound_generation_tpu_torch.ops import dsp
from neural_sound_generation_tpu_torch.training import checkpoint
from neural_sound_generation_tpu_torch.training.train_state import create_train_state
from test_torch_vocoder_train import write_corpus

torch.set_num_threads(1)

WIDTHS = ["--layers", "2", "--stacks", "1", "--residual-channels", "8"]
FRAMES, HOP = 3, 256


def _ns(**kw):
    return types.SimpleNamespace(**{"residual_channels": 8, "layers": 2, "stacks": 1, **kw})


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A JAX WaveNet of the CLI's build, carried into the port and saved as
    a vocoder artifact; and a time-major mel."""
    root = tmp_path_factory.mktemp("vocoder")
    jm = jvocoder.build_model(JaxConfig(), _ns())
    v = jax.tree_util.tree_map(np.array, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 1)), jnp.zeros((1, 2, 80)), None))
    tm = vocoder.build_model(Config(), _ns())
    tm.load_state_dict(convert.flax_to_state_dict(v))
    ckpt = str(root / "wavenet")
    checkpoint.save_params(ckpt, tm, 7, vocoder._condition_meta(_ns()))
    mel = str(root / "mel.npy")
    np.save(mel, np.random.default_rng(0).standard_normal((FRAMES, 80)).astype(np.float32))
    return ckpt, mel, tm, root


def test_build_model_matches_the_jax_cli():
    """Gate = residual, skip = min(arch skip, residual), at the defaults and
    under the width flags."""
    for ns in (_ns(residual_channels=None, layers=None, stacks=None), _ns(),
               _ns(residual_channels=128, layers=4, stacks=2)):
        jm, tm = jvocoder.build_model(JaxConfig(), ns), vocoder.build_model(Config(), ns)
        for name in ("out_channels", "layers", "stacks", "residual_channels", "gate_channels",
                     "skip_out_channels", "kernel_size", "cin_channels", "gin_channels",
                     "upsample_scales", "scalar_input", "quantize_channels"):
            assert getattr(tm, name) == getattr(jm, name), name
    full = vocoder.build_model(Config(), _ns(residual_channels=None, layers=None, stacks=None))
    assert (full.residual_channels, full.gate_channels, full.skip_out_channels) == (512, 512, 256)


def test_synthesize_writes_frames_times_hop(artifact, tmp_path, capsys):
    from scipy.io import wavfile

    ckpt, mel, _, _ = artifact
    out = tmp_path / "out.wav"
    vocoder.main(["synthesize", "--ckpt-dir", ckpt, "--mel-npy", mel, "--output", str(out),
                  "--device", "cpu", *WIDTHS])
    assert f"synthesized {FRAMES * HOP} samples" in capsys.readouterr().out
    sr, wav = wavfile.read(out)
    assert sr == 22050 and len(wav) == FRAMES * HOP
    # --max-frames cuts the mel; f32 products run too
    vocoder.main(["synthesize", "--ckpt-dir", ckpt, "--mel-npy", mel, "--output", str(out),
                  "--device", "cpu", "--max-frames", "1", "--gen-precision", "f32", *WIDTHS])
    assert len(wavfile.read(out)[1]) == HOP


def test_synthesize_refusals(artifact, tmp_path):
    ckpt, mel, tm, root = artifact
    base = ["synthesize", "--ckpt-dir", ckpt, "--output", str(tmp_path / "o.wav"),
            "--device", "cpu", *WIDTHS]
    with pytest.raises(SystemExit, match="--mel-npy"):
        vocoder.main(base)
    with pytest.raises(SystemExit, match="no speaker embeddings"):
        vocoder.main(base + ["--mel-npy", mel, "--speaker-id", "0"])
    with pytest.raises(SystemExit, match="does not match the model"):  # wrong widths
        vocoder.main(base[:-1] + ["16", "--mel-npy", mel])
    units = str(root / "units")
    checkpoint.save_params(units, tm, 1, {"condition": "units", "units_dim": 8})
    with pytest.raises(SystemExit, match="trained with --condition units"):
        vocoder.main(["synthesize", "--ckpt-dir", units, "--mel-npy", mel, "--output",
                      str(tmp_path / "o.wav"), "--device", "cpu", *WIDTHS])
    with pytest.raises(SystemExit, match="trained with --condition units; serve"):
        serve.build_service(serve.parse_args([
            "--device", "cpu", "--dim", "16", "--z-dim", "16", "--vocoder", "wavenet",
            "--vocoder-ckpt", units, "--vocoder-layers", "2", "--vocoder-stacks", "1",
            "--vocoder-residual-channels", "8"]))
    with pytest.raises(SystemExit, match="requires --vocoder-ckpt"):
        serve.build_service(serve.parse_args(["--device", "cpu", "--vocoder", "wavenet"]))
    with pytest.raises(SystemExit, match="requires --vocoder wavenet"):
        serve.build_service(serve.parse_args(["--device", "cpu", "--dim", "16", "--z-dim", "16",
                                              "--stream-slots", "2"]))


@pytest.mark.parametrize("argv,match", [
    (["train", "--datadir", "x", "--stacks", "3", "--mesh-pipe", "2"],
     "--stacks 3 does not stage evenly over --mesh-pipe 2"),
    (["train", "--datadir", "x", "--bf16", "--mesh-pipe", "2", "--multi-steps", "4",
      "--preset", "CIN0"], r"--mesh-pipe requires mel conditioning \(cin_channels > 0\)"),
    (["train", "--datadir", "x", "--mesh-pipe", "2", "--pp-microbatches", "3"],
     "--pp-microbatches 3 must divide --batch-size 2"),
    (["train", "--datadir", "x", "--mesh-pipe", "2", "--device", "cpu"],
     r"mesh 1x2 needs 2 ranks, have 1: launch torchrun --nproc_per_node 2"),
])
def test_next_slice_raises(argv, match, tmp_path):
    """The pipe path's refusals (JAX's ``_train_pp`` checks): stacks that
    do not stage, an unconditioned vocoder (a preset with cin_channels 0),
    microbatches that do not divide the batch, and a world that is not
    D x S ranks."""
    preset = tmp_path / "cin0.json"
    preset.write_text('{"cin_channels": 0}')
    with pytest.raises(SystemExit, match=match):
        vocoder.main([str(preset) if a == "CIN0" else a for a in argv])


def _units_artifacts(root):
    """A seeded WaveVQVAE checkpoint (dim 8, 16 codes, hop 8) and a seeded
    units WaveNet artifact recording that chain."""
    units = ["--condition", "units", "--units-dim", "8", "--units-z-dim", "16",
             "--units-downsample", "3"]
    wave = WaveVQVAE(8, 16, 3, generator=torch.Generator().manual_seed(0))
    units_ckpt = str(root / "wave")
    checkpoint.save(units_ckpt, create_train_state(wave, Config().train), 1,
                    {"arch": "wavevqvae", "num_quantizers": 1, "num_downsample": 3})
    args = vocoder.parse_args(["synthesize", "--ckpt-dir", "x", "--output", "o", *units])
    wn = vocoder.build_model(Config(), _ns(**{**vars(args), "residual_channels": 8, "layers": 2,
                                                        "stacks": 1}),
                             generator=torch.Generator().manual_seed(0))
    ckpt = str(root / "wn_units")
    checkpoint.save_params(ckpt, wn, 1, vocoder._condition_meta(args))
    return units + ["--units-vqvae-ckpt", units_ckpt], ckpt


@pytest.mark.parametrize("case", ["train", "train_bf16_multi_steps", "synthesize_units"])
def test_the_former_refusals_run(case, tmp_path, capsys):
    """The three paths that raised before vocoder training was ported:
    ``train``, ``train --bf16 --multi-steps 4`` and ``synthesize
    --condition units``."""
    if case.startswith("train"):
        datadir = write_corpus(str(tmp_path / "corpus"))
        extra = ["--bf16", "--multi-steps", "4"] if case != "train" else []
        ckpt = str(tmp_path / "wn")
        vocoder.main(["train", "--datadir", datadir, "--ckpt-dir", ckpt, "--epochs", "1",
                      "--max-batches-per-epoch", "4", "--device", "cpu", *WIDTHS, *extra])
        assert "wavenet epoch 1: loss" in capsys.readouterr().out
        assert checkpoint.latest_step(ckpt) == 4
        return
    units, ckpt = _units_artifacts(tmp_path)
    wav = str(tmp_path / "in.wav")
    dsp.save_wav(0.5 * np.sin(np.arange(400) / 7.0).astype(np.float32), wav, 22050)
    out = tmp_path / "o.wav"
    vocoder.main(["synthesize", "--ckpt-dir", ckpt, "--wav-in", wav, "--output", str(out),
                  "--max-frames", "5", "--device", "cpu", *WIDTHS, *units])
    assert "synthesized 40 samples" in capsys.readouterr().out


def test_postprocess_follows_the_input_type():
    cfg = Config()
    y = torch.linspace(-1, 1, 9)
    assert torch.equal(vocoder.postprocess(y, cfg.audio), y)  # raw
    for input_type in ("mulaw", "mulaw-quantize"):
        audio = argparse.Namespace(is_mulaw=input_type == "mulaw",
                                   is_mulaw_quantize=input_type == "mulaw-quantize",
                                   quantize_channels=256)
        x = torch.arange(0, 256, 32) if input_type == "mulaw-quantize" else y
        got = vocoder.postprocess(x, audio)
        assert got.dtype == torch.float32 and float(got.abs().max()) <= 1.0 + 1e-6

"""The port's training CLI end to end on the CPU (``--device cpu``) on a
tiny synthetic corpus: two epochs with --multi-steps 2 and --codebook-init
data, --resume for a third, then ``cli.evaluate`` and the server with
``--ckpt-dir --ema`` from the checkpoint it wrote, in process; residual VQ
with bf16 compute (``--num-quantizers 2 --bf16``) through train, restore and
evaluate; and the flags of later slices, which refuse."""

import io
import json
import os

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu_torch.cli import evaluate, main, serve
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, write_manifest
from neural_sound_generation_tpu_torch.training import checkpoint

torch.set_num_threads(1)

DIM, Z_DIM, SR = 32, 64, 22050


def _corpus(root, n=40):
    """Chirps of 0.3-0.5 s with mels from the port's own analysis."""
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.ops import dsp

    rng = np.random.default_rng(0)
    entries = []
    for i in range(n):
        t = np.arange(int(SR * rng.uniform(0.3, 0.5))) / SR
        f = rng.uniform(100, 300) + rng.uniform(500, 2500) * t / t[-1]
        wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / SR)).astype(np.float32)
        mel = dsp.melspectrogram(torch.from_numpy(wav), Config().audio).T.numpy()
        np.save(root / f"a{i}.npy", wav)
        np.save(root / f"m{i}.npy", mel.astype(np.float32))
        entries.append(ManifestEntry(f"a{i}.npy", f"m{i}.npy", len(wav), "chirp"))
    write_manifest(str(root), entries)
    return str(root)


def _train_args(tmp_path, datadir, *extra):
    return ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", datadir,
            "--dim", str(DIM), "--z-dim", str(Z_DIM), "--batch-size", "4",
            "--max-batches-per-epoch", "4", "--log-interval", "1", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "models"), "--sampledir", str(tmp_path / "results"),
            *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("cli")
    os.makedirs(tmp_path / "corpus")
    datadir = _corpus(tmp_path / "corpus")
    main.main(_train_args(tmp_path, datadir, "--epochs", "2", "--multi-steps", "2",
                          "--codebook-init", "data"))
    ckpt = os.path.join(tmp_path, "models", "vqvae", f"checkpoint_ljspeech_{DIM}_{Z_DIM}")
    after_two = checkpoint.latest_step(ckpt)
    main.main(_train_args(tmp_path, datadir, "--epochs", "3", "--multi-steps", "2", "--resume"))
    return tmp_path, datadir, ckpt, after_two


def test_two_epochs_then_resume(trained, capsys):
    tmp_path, _, ckpt, after_two = trained
    # 4 mini-batches per epoch in super-batches of 2: 4 steps per epoch
    assert after_two == 8
    assert checkpoint.latest_step(ckpt) == 12  # the resumed epoch continued the count
    assert checkpoint.read_extra(ckpt) == {"epoch": 3, "arch": "vqvae", "num_quantizers": 1,
                                           "num_downsample": 6}
    lines = open(tmp_path / "results" / "ljspeech" / "metrics.jsonl").read().splitlines()
    records = [json.loads(line) for line in lines]
    assert [(r["phase"], r.get("epoch")) for r in records] == [
        ("train", 1), ("test", None), ("train", 2), ("test", None), ("train", 3), ("test", None)]
    for r in records:
        assert np.isfinite(r["loss"]) and r["batches"] > 0
        assert {"loss_recons", "loss_vq", "loss_commit", "train_loss"} <= r.keys()
    assert records[4]["loss"] < records[0]["loss"]
    assert "grad_norm" in records[0] and "perplexity" in records[1]
    names = os.listdir(tmp_path / "results" / "ljspeech")
    assert sum(n.endswith(".wav") for n in names) == 3
    assert sum(n.startswith("reconstruction_") for n in names) == 3


def test_evaluate_from_the_checkpoint(trained, tmp_path):
    _, datadir, ckpt, _ = trained
    dump = str(tmp_path / "recon.npy")
    common = ["--datadir", datadir, "--ckpt-dir", ckpt, "--dim", str(DIM), "--z-dim",
              str(Z_DIM), "--batch-size", "4", "--device", "cpu"]
    ema = evaluate.main(common + ["--max-batches", "1", "--dump-npy", dump])
    live = evaluate.main(common + ["--no-ema"])
    assert np.load(dump).shape == (4, 80, 28, 1)
    assert np.isfinite(ema["loss"]) and np.isfinite(live["loss"])
    assert ema["loss"] != live["loss"]  # two sets of weights
    with pytest.raises(SystemExit, match="num_downsample"):  # recorded 6
        evaluate.main(common + ["--num-downsample", "4"])


def _wav_bytes(seconds=0.5):
    from scipy.io import wavfile

    t = np.arange(int(SR * seconds)) / SR
    wav = (0.5 * np.sin(2 * np.pi * (200 + 800 * t) * t) * 32767).astype(np.int16)
    buf = io.BytesIO()
    wavfile.write(buf, SR, wav)
    return buf.getvalue()


def test_serve_from_the_checkpoint_with_ema(trained):
    _, _, ckpt, _ = trained
    args = ["--device", "cpu", "--ckpt-dir", ckpt, "--dim", str(DIM), "--z-dim", str(Z_DIM),
            "--frames", "16"]
    ema_svc = serve.build_service(serve.parse_args(args + ["--ema"]))
    live_svc = serve.build_service(serve.parse_args(args))
    state = torch.load(os.path.join(ckpt, "step_12", "state.pt"), weights_only=True)
    for name, p in ema_svc.model.named_parameters():
        assert torch.equal(p.detach(), state[f"ema_params/{name}"]), name
    for name, p in live_svc.model.named_parameters():
        assert torch.equal(p.detach(), state[f"params/{name}"]), name
    for name, b in ema_svc.model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert torch.equal(b, state[f"batch_stats/{name}"]), name
    from scipy.io import wavfile

    rate, wav = wavfile.read(io.BytesIO(ema_svc.reconstruct(_wav_bytes())))
    assert rate == SR and len(wav) == int(SR * 0.5) and np.abs(wav).max() > 0
    with pytest.raises(SystemExit, match="--ema needs --ckpt-dir"):
        serve.build_service(serve.parse_args(["--device", "cpu", "--ema"]))
    with pytest.raises(SystemExit):  # another width than the checkpoint's
        serve.build_service(serve.parse_args(args[:4] + ["--dim", "16", "--frames", "16"]))


def test_serve_ema_refuses_a_checkpoint_without_a_shadow(trained, tmp_path):
    _, datadir, _, _ = trained
    preset = tmp_path / "no_ema.json"
    preset.write_text(json.dumps({"exponential_moving_average": False}))
    main.main(_train_args(tmp_path, datadir, "--epochs", "1", "--preset", str(preset)))
    ckpt = os.path.join(tmp_path, "models", "vqvae", f"checkpoint_ljspeech_{DIM}_{Z_DIM}")
    with pytest.raises(SystemExit, match="no EMA shadow"):
        serve.build_service(serve.parse_args(
            ["--device", "cpu", "--ckpt-dir", ckpt, "--ema", "--dim", str(DIM), "--z-dim",
             str(Z_DIM), "--frames", "16"]))


@pytest.mark.parametrize("flags,slice_name", [
    (["--model", "vqvae", "--dataset", "ljspeech", "--mesh-data", "2"], "parallel"),
    (["--model", "vqvae", "--dataset", "ljspeech", "--mesh-model", "2"], "parallel"),
])
def test_flags_of_later_slices_refuse(flags, slice_name):
    with pytest.raises(SystemExit, match=slice_name):
        main.main(flags + ["--device", "cpu", "--datadir", "/nonexistent"])


def test_rvq_bf16_trains_an_f32_checkpoint_that_restores_and_evaluates(trained, tmp_path):
    """--num-quantizers 2 --bf16 with EMA codebooks, restarts and data init:
    the checkpoint is float32 (a (2, K, D) codebook, (2, K) EMA clusters)
    and restores into a float32 model; cli.evaluate runs on it with and
    without --bf16; a mismatched --num-quantizers is refused at evaluate
    and at --resume."""
    _, datadir, _, _ = trained
    rvq = ["--num-quantizers", "2", "--bf16", "--ema-codebook", "--restart-dead-threshold",
           "1.0", "--codebook-init", "data"]
    main.main(_train_args(tmp_path, datadir, "--epochs", "1", *rvq))
    ckpt = os.path.join(tmp_path, "models", "vqvae", f"checkpoint_ljspeech_{DIM}_{Z_DIM}")
    step = checkpoint.latest_step(ckpt)
    assert step == 4
    assert checkpoint.read_extra(ckpt) == {"epoch": 1, "arch": "vqvae", "num_quantizers": 2,
                                           "num_downsample": 6}
    saved = torch.load(os.path.join(ckpt, f"step_{step}", "state.pt"), weights_only=True)
    assert saved["params/codebook"].shape == (2, Z_DIM, DIM)
    assert saved["codebook_ema/cluster"].shape == (2, Z_DIM)
    assert all(t.dtype == torch.float32 for k, t in saved.items()
               if k.startswith(("params/", "ema_params/", "opt_state/m/", "batch_stats/")))
    # into the default float32 model of the same shape
    args = main.parse_args(_train_args(tmp_path, datadir, "--num-quantizers", "2"))
    cfg = main.build_config(args)
    model = main.make_model(cfg)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    from neural_sound_generation_tpu_torch.training.train_state import create_train_state

    state, _ = checkpoint.restore(ckpt, create_train_state(model, cfg.train))
    assert torch.equal(model.codebook.detach(), saved["params/codebook"])

    common = ["--datadir", datadir, "--ckpt-dir", ckpt, "--dim", str(DIM), "--z-dim",
              str(Z_DIM), "--batch-size", "4", "--device", "cpu", "--max-batches", "1"]
    bf16 = evaluate.main(common + ["--num-quantizers", "2", "--bf16"])
    f32 = evaluate.main(common + ["--num-quantizers", "2"])
    for means in (bf16, f32):
        assert np.isfinite(means["loss"]) and means["perplexity"] >= 1.0
    assert abs(bf16["loss"] - f32["loss"]) <= 0.05 * f32["loss"]
    with pytest.raises(SystemExit, match="num_quantizers"):
        evaluate.main(common)
    with pytest.raises(SystemExit, match="num_quantizers"):
        main.main(_train_args(tmp_path, datadir, "--epochs", "2", "--num-quantizers", "3",
                              "--resume"))
    # the server serves single-codebook models: it refuses by the metadata
    with pytest.raises(SystemExit, match="num_quantizers"):
        serve.build_service(serve.parse_args(["--device", "cpu", "--ckpt-dir", ckpt, "--dim",
                                              str(DIM), "--z-dim", str(Z_DIM), "--frames", "16"]))

"""The port's prior CLI end to end on the CPU (``--device cpu``) on a tiny
synthetic corpus: a VQ-VAE trained by ``cli.main``, then ``cli.prior
train --arch transformer`` and with the default ``--arch pixelcnn``, each
for two epochs and ``--resume`` for a third, ``cli.prior sample``, and
``/sample`` over HTTP from the server started with ``--prior-ckpt``;
checkpoint metadata that disagrees with the flags (the head count, the
family and the experts above all) and the flags of later slices refuse.
A routed transformer (``--moe-experts 2``) trains, resumes, samples and is
served (``serve --prior-moe-experts 2``) on the same VQ-VAE. ``--bf16``
trains and samples each family (the dense and the routed transformer, the
PixelCNN), and a checkpoint samples whatever its training's dtype."""

import contextlib
import io
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu_torch.cli import main, prior, serve
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, write_manifest
from neural_sound_generation_tpu_torch.ops.cuda import flash_attention as fa
from neural_sound_generation_tpu_torch.training import checkpoint

torch.set_num_threads(1)

DIM, Z_DIM, SR = 32, 64, 22050
PRIOR = ["--arch", "transformer", "--prior-dim", "32", "--prior-layers", "2",
         "--prior-heads", "2", "--dim", str(DIM), "--z-dim", str(Z_DIM), "--device", "cpu"]
# the default --arch: the GatedPixelCNN
PIXELCNN = ["--prior-dim", "16", "--prior-layers", "3", "--dim", str(DIM), "--z-dim", str(Z_DIM),
            "--device", "cpu"]


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


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prior")
    os.makedirs(tmp / "corpus")
    datadir = _corpus(tmp / "corpus")
    main.main(["--model", "vqvae", "--dataset", "ljspeech", "--datadir", datadir,
               "--dim", str(DIM), "--z-dim", str(Z_DIM), "--batch-size", "4", "--epochs", "1",
               "--max-batches-per-epoch", "2", "--log-interval", "0", "--device", "cpu",
               "--codebook-init", "data", "--ckpt-dir", str(tmp / "models"),
               "--sampledir", str(tmp / "results")])
    vq_ckpt = str(tmp / "models" / "vqvae" / f"checkpoint_ljspeech_{DIM}_{Z_DIM}")
    ckpt = str(tmp / "prior")
    train = ["train", "--datadir", datadir, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir", ckpt,
             "--batch-size", "4", "--max-batches-per-epoch", "3", "--lr", "3e-3", *PRIOR]
    prior.main(train + ["--epochs", "2"])
    after_two = checkpoint.latest_step(ckpt)
    prior.main(train + ["--epochs", "3", "--resume"])
    return tmp, datadir, vq_ckpt, ckpt, after_two, train


def test_train_then_resume(trained, capsys):
    _, _, _, ckpt, after_two, _ = trained
    assert after_two == 6  # 3 batches per epoch, one step each
    for d in (ckpt, ckpt + "_ema", ckpt + "_train"):
        assert checkpoint.latest_step(d) == 9, d  # the resumed epoch continued the count
    meta = {"arch": "transformer", "prior_dim": 32, "prior_layers": 2, "prior_heads": 2,
            "z_dim": Z_DIM, "n_classes": 10, "spatial_cond": False, "cond_dim": 0,
            "n_experts": 0}
    assert checkpoint.read_extra(ckpt) == {"epoch": 3, **meta}
    assert checkpoint.read_extra(ckpt + "_ema") == {"epoch": 3, "averaged": True, **meta}
    state = torch.load(os.path.join(ckpt, "step_9", "state.pt"), weights_only=True)
    assert all(k.startswith("params/") for k in state) and "params/bos" in state
    full = torch.load(os.path.join(ckpt + "_train", "step_9", "state.pt"), weights_only=True)
    assert int(full["step"]) == 9 and int(full["opt_state/count"]) == 9
    # the code grids are 20 x 7: 80 mels and 28-frame crops over stride 4
    assert full["params/block_0.attn_qkv.weight"].shape == (96, 32)


def test_the_loss_falls(trained, tmp_path, capsys):
    _, _, _, _, _, train = trained
    prior.main(train + ["--epochs", "4", "--ckpt-dir", str(tmp_path / "p")])
    out = capsys.readouterr().out
    nll = [float(line.split("nll/code ")[1].split()[0])
           for line in out.splitlines() if line.startswith("prior epoch")]
    assert len(nll) == 4 and nll[-1] < nll[0]
    assert fa.launch_counts() == dict.fromkeys(fa.KERNELS, 0)  # the CPU ran the plain pair


def test_resume_from_the_artifact_alone(trained, tmp_path, capsys):
    _, _, _, ckpt, _, train = trained
    import shutil

    shutil.copytree(ckpt, tmp_path / "p")
    shutil.copytree(ckpt + "_ema", tmp_path / "p_ema")
    # one super-batch of the epoch's 3 code grids: the tensor stacking path
    prior.main(train + ["--epochs", "4", "--resume", "--multi-steps", "3",
                        "--ckpt-dir", str(tmp_path / "p")])
    assert "Adam moments restart" in capsys.readouterr().out
    assert checkpoint.latest_step(str(tmp_path / "p")) == 12
    full = torch.load(tmp_path / "p_train" / "step_12" / "state.pt", weights_only=True)
    assert int(full["step"]) == 12 and int(full["opt_state/count"]) == 3


def test_sample_writes_finite_wavs(trained, tmp_path):
    from scipy.io import wavfile

    _, _, vq_ckpt, ckpt, _, _ = trained
    out = tmp_path / "samples"
    prior.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpt + "_ema",
                "--output-dir", str(out), "--code-shape", "20", "3", "--num-samples", "2",
                "--label", "3", *PRIOR])
    names = sorted(os.listdir(out))
    assert names == ["prior_sample_000.wav", "prior_sample_001.wav"]
    for name in names:
        rate, wav = wavfile.read(out / name)
        # 20 x 3 codes decode to 80 mels x 12 frames; Griffin-Lim gives
        # (frames - 1) hops
        assert rate == SR and wav.shape == (11 * 256,) and np.abs(wav).max() > 0


def test_metadata_mismatch_refuses(trained, tmp_path):
    _, _, vq_ckpt, ckpt, _, _ = trained
    # the qkv weights have one shape for any head count: only the metadata
    # tells 2 heads from 4
    with pytest.raises(SystemExit, match="prior_heads=2"):
        prior.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpt,
                    "--output-dir", str(tmp_path), "--code-shape", "2", "2",
                    *PRIOR[:-6], "--prior-heads", "4", *PRIOR[-6:]])
    with pytest.raises(SystemExit, match="prior_heads=2"):
        serve.build_service(serve.parse_args([
            "--device", "cpu", "--dim", str(DIM), "--z-dim", str(Z_DIM), "--frames", "16",
            "--prior-ckpt", ckpt, "--prior-arch", "transformer", "--prior-dim", "32",
            "--prior-layers", "2"]))  # serve's --prior-heads defaults to 8
    with pytest.raises(SystemExit, match="arch"):
        serve.build_service(serve.parse_args([
            "--device", "cpu", "--dim", str(DIM), "--z-dim", str(Z_DIM), "--frames", "16",
            "--ckpt-dir", ckpt]))


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode())
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_sample_endpoint_over_http(trained):
    from scipy.io import wavfile

    _, _, vq_ckpt, ckpt, _, _ = trained
    service = serve.build_service(serve.parse_args([
        "--device", "cpu", "--dim", str(DIM), "--z-dim", str(Z_DIM), "--frames", "16",
        "--ckpt-dir", vq_ckpt, "--prior-ckpt", ckpt, "--prior-arch", "transformer",
        "--prior-dim", "32", "--prior-layers", "2", "--prior-heads", "2"]))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
    try:
        bodies = {}
        for n in (1, 2):
            status, body = _post(url, {"n": n, "label": 1, "seed": 5})
            assert status == 200, body[:200]
            rate, wav = wavfile.read(io.BytesIO(body))
            # a 20 x 4 code grid decodes to 16 frames per sample
            assert rate == SR and wav.shape == (n * 15 * 256,) and np.abs(wav).max() > 0
            bodies[n] = body
        assert _post(url, {"n": 1, "label": 1, "seed": 5})[1] == bodies[1]  # seeded
        for payload in ({"n": 0}, {"n": 17}, {"label": 10}, {"label": -1}, [1, 2]):
            status, body = _post(url, payload)
            assert status == 400, (payload, body)
    finally:
        httpd.shutdown()
        httpd.server_close()
    bare = serve.build_service(serve.parse_args(
        ["--device", "cpu", "--dim", str(DIM), "--z-dim", str(Z_DIM), "--frames", "16"]))
    with pytest.raises(ValueError, match="no prior loaded"):
        bare.sample({"n": 1})


@pytest.mark.parametrize("flags,match", [
    (["--arch", "transformer", "--mesh-pipe", "2"],
     "--prior-layers 15 does not stage evenly over --mesh-pipe 2"),
    (["--arch", "pixelcnn", "--mesh-model", "2", "--mesh-pipe", "2"],
     "--mesh-model 2 with --mesh-pipe 2: a mesh has a model axis or a pipe axis, not both"),
])
def test_flags_of_later_slices_refuse(flags, match):
    """The pipe path's refusals, before anything is read: layers that do not
    stage (the default 15 over 2 stages), and a model axis with a pipe
    axis."""
    common = ["--vqvae-ckpt", "/nonexistent", "--device", "cpu"]
    with pytest.raises(SystemExit, match=match):
        prior.main(["train", "--datadir", "/nonexistent", *common, *flags])


@pytest.mark.parametrize("flags", [["--arch", "pixelcnn"], ["--arch", "transformer", "--hier"],
                                   ["--arch", "transformer", "--moe-experts", "4"],
                                   ["--arch", "transformer", "--moe-experts", "4", "--bf16"],
                                   ["--arch", "pixelcnn", "--bf16"]])
def test_flags_of_this_slice_pass_the_refusals(flags):
    """The PixelCNN, the hierarchy, the routed transformer and bf16 run (end
    to end below and in tests/test_torch_hier_prior.py); no flag of theirs
    is refused."""
    common = ["--vqvae-ckpt", "/nonexistent", "--device", "cpu", *flags]
    for argv in (["train", "--datadir", "/nonexistent", *common],
                 ["sample", "--prior-ckpt", "/nonexistent", *common]):
        prior.check_pipe_flags(prior.parse_args(argv))


@pytest.fixture(scope="module")
def pixelcnn(trained):
    """The default-arch prior on the same VQ-VAE: two epochs, then
    ``--resume`` for a third."""
    tmp, datadir, vq_ckpt, _, _, _ = trained
    ckpt = str(tmp / "pixelcnn")
    train = ["train", "--datadir", datadir, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir", ckpt,
             "--batch-size", "4", "--max-batches-per-epoch", "3", "--lr", "3e-3", *PIXELCNN]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prior.main(train + ["--epochs", "2"])
        prior.main(train + ["--epochs", "3", "--resume"])
    return vq_ckpt, ckpt, out.getvalue()


def test_pixelcnn_trains_and_resumes(pixelcnn):
    _, ckpt, log = pixelcnn
    for d in (ckpt, ckpt + "_ema", ckpt + "_train"):
        assert checkpoint.latest_step(d) == 9, d
    assert checkpoint.read_extra(ckpt) == {
        "epoch": 3, "arch": "pixelcnn", "prior_dim": 16, "prior_layers": 3, "prior_heads": 0,
        "z_dim": Z_DIM, "n_classes": 10, "spatial_cond": False, "cond_dim": 0, "n_experts": 0}
    full = torch.load(os.path.join(ckpt + "_train", "step_9", "state.pt"), weights_only=True)
    assert int(full["opt_state/count"]) == 9
    assert full["params/layer_0.vert_kernel"].shape == (32, 16, 4, 7)
    assert "resumed train state from step 6, epoch 3" in log
    nll = [float(line.split("nll/code ")[1].split()[0])
           for line in log.splitlines() if line.startswith("prior epoch")]
    assert len(nll) == 3 and all(np.isfinite(nll)) and nll[-1] < nll[0]


def test_pixelcnn_sample_writes_finite_wavs(pixelcnn, tmp_path):
    from scipy.io import wavfile

    vq_ckpt, ckpt, _ = pixelcnn
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpt + "_ema",
                    "--output-dir", str(tmp_path), "--code-shape", "20", "3",
                    "--num-samples", "2", *PIXELCNN])
    for i in range(2):
        rate, wav = wavfile.read(tmp_path / f"prior_sample_{i:03d}.wav")
        assert rate == SR and wav.shape == (11 * 256,) and np.abs(wav).max() > 0


def test_serve_a_pixelcnn_prior(trained, pixelcnn):
    """``serve --prior-ckpt`` with the default ``--prior-arch pixelcnn``
    answers /sample; a transformer checkpoint under that flag refuses."""
    from scipy.io import wavfile

    _, _, _, transformer_ckpt, _, _ = trained
    vq_ckpt, ckpt, _ = pixelcnn
    base = ["--device", "cpu", "--dim", str(DIM), "--z-dim", str(Z_DIM), "--frames", "16",
            "--ckpt-dir", vq_ckpt, "--prior-dim", "16", "--prior-layers", "3"]
    with pytest.raises(SystemExit, match="arch='transformer'"):
        serve.build_service(serve.parse_args(base + ["--prior-ckpt", transformer_ckpt]))
    service = serve.build_service(serve.parse_args(base + ["--prior-ckpt", ckpt]))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
    try:
        for n in (1, 2):
            status, body = _post(url, {"n": n, "label": 2, "seed": 3})
            assert status == 200, body[:200]
            rate, wav = wavfile.read(io.BytesIO(body))
            assert rate == SR and wav.shape == (n * 15 * 256,) and np.abs(wav).max() > 0
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_long_t_warning():
    assert prior.long_t_warning("transformer", (1, 20, 7)) is None
    text = prior.long_t_warning("transformer", (1, 40, 56))
    # the card's own figures, with the card (no figure measured on another device)
    assert "T=2240" in text and "H100 80GB HBM3 at 700 W" in text and "TPU" not in text
    assert prior.long_t_warning("pixelcnn", (1, 40, 56)) is None


# ---------------------------------------------------------------------------
# The routed transformer (--moe-experts)
# ---------------------------------------------------------------------------

ROUTED = [*PRIOR[:-2], "--moe-experts", "2", *PRIOR[-2:]]


@pytest.fixture(scope="module")
def routed(trained):
    """``--moe-experts 2`` on the same VQ-VAE: two epochs, then ``--resume
    --multi-steps 3`` for a third."""
    tmp, datadir, vq_ckpt, _, _, _ = trained
    ckpt = str(tmp / "routed")
    train = ["train", "--datadir", datadir, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir", ckpt,
             "--batch-size", "4", "--max-batches-per-epoch", "3", "--lr", "3e-3", *ROUTED]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        prior.main(train + ["--epochs", "2"])
        prior.main(train + ["--epochs", "3", "--resume", "--multi-steps", "3"])
    return vq_ckpt, ckpt, out.getvalue()


def test_routed_prior_trains_and_resumes(routed):
    _, ckpt, log = routed
    for d in (ckpt, ckpt + "_ema", ckpt + "_train"):
        assert checkpoint.latest_step(d) == 9, d
    meta = checkpoint.read_extra(ckpt)
    assert meta["n_experts"] == 2 and meta["arch"] == "transformer" and meta["epoch"] == 3
    full = torch.load(os.path.join(ckpt + "_train", "step_9", "state.pt"), weights_only=True)
    assert int(full["opt_state/count"]) == 9
    assert full["params/block_1.moe.w_in"].shape == (2, 32, 128)
    assert "params/block_0.mlp_in.weight" not in full
    assert "resumed train state from step 6, epoch 3" in log
    epochs = [line for line in log.splitlines() if line.startswith("prior epoch")]
    assert len(epochs) == 3
    for line in epochs:
        assert np.isfinite(float(line.split("nll/code ")[1].split()[0]))
        assert np.isfinite(float(line.split("load_balance ")[1].split()[0]))


def test_routed_prior_samples(routed, tmp_path):
    from scipy.io import wavfile

    vq_ckpt, ckpt, _ = routed
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpt + "_ema",
                    "--output-dir", str(tmp_path), "--code-shape", "20", "3",
                    "--num-samples", "2", *ROUTED])
    for i in range(2):
        rate, wav = wavfile.read(tmp_path / f"prior_sample_{i:03d}.wav")
        assert rate == SR and wav.shape == (11 * 256,) and np.abs(wav).max() > 0


@pytest.mark.parametrize("direction", ["routed_as_dense", "dense_as_routed"])
def test_expert_metadata_refuses_both_ways(trained, routed, tmp_path, direction):
    _, _, vq_ckpt, dense_ckpt, _, _ = trained
    _, routed_ckpt, _ = routed
    ckpt, flags, match = ((routed_ckpt, PRIOR, "n_experts=2") if direction == "routed_as_dense"
                          else (dense_ckpt, ROUTED, "n_experts=0"))
    with pytest.raises(SystemExit, match=match):
        prior.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpt,
                    "--output-dir", str(tmp_path), "--code-shape", "2", "2", *flags])
    serve_flags = ["--prior-moe-experts", "2"] if direction == "dense_as_routed" else []
    with pytest.raises(SystemExit, match=match):
        serve.build_service(serve.parse_args([
            "--device", "cpu", "--dim", str(DIM), "--z-dim", str(Z_DIM), "--frames", "16",
            "--prior-ckpt", ckpt, "--prior-arch", "transformer", "--prior-dim", "32",
            "--prior-layers", "2", "--prior-heads", "2", *serve_flags]))
    # resuming a routed run with dense flags refuses too
    if direction == "routed_as_dense":
        _, datadir, _, _, _, _ = trained
        with pytest.raises(SystemExit, match=match):
            prior.main(["train", "--datadir", datadir, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir",
                        ckpt, "--epochs", "4", "--resume", *PRIOR])


def test_routed_sample_endpoint_over_http(routed):
    from scipy.io import wavfile

    vq_ckpt, ckpt, _ = routed
    service = serve.build_service(serve.parse_args([
        "--device", "cpu", "--dim", str(DIM), "--z-dim", str(Z_DIM), "--frames", "16",
        "--ckpt-dir", vq_ckpt, "--prior-ckpt", ckpt, "--prior-arch", "transformer",
        "--prior-dim", "32", "--prior-layers", "2", "--prior-heads", "2",
        "--prior-moe-experts", "2"]))
    assert service.prior.n_experts == 2
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/sample"
    try:
        bodies = {}
        for n in (1, 2):
            status, body = _post(url, {"n": n, "label": 1, "seed": 5})
            assert status == 200, body[:200]
            rate, wav = wavfile.read(io.BytesIO(body))
            assert rate == SR and wav.shape == (n * 15 * 256,) and np.abs(wav).max() > 0
            bodies[n] = body
        assert _post(url, {"n": 1, "label": 1, "seed": 5})[1] == bodies[1]  # seeded
    finally:
        httpd.shutdown()
        httpd.server_close()


# ---------------------------------------------------------------------------
# --bf16
# ---------------------------------------------------------------------------

BF16_FAMILIES = {"transformer": PRIOR, "routed": [*PRIOR[:-2], "--moe-experts", "4", *PRIOR[-2:]],
                 "pixelcnn": PIXELCNN}


@pytest.fixture(scope="module")
def bf16_runs(trained):
    """``train --bf16`` of each family on the same VQ-VAE, one epoch of 3
    steps: {family: (checkpoint, log)}."""
    tmp, datadir, vq_ckpt, _, _, _ = trained
    runs = {}
    for family, flags in BF16_FAMILIES.items():
        ckpt = str(tmp / f"bf16_{family}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            prior.main(["train", "--datadir", datadir, "--vqvae-ckpt", vq_ckpt, "--ckpt-dir",
                        ckpt, "--batch-size", "4", "--max-batches-per-epoch", "3", "--lr",
                        "3e-3", "--epochs", "1", "--bf16", *flags])
        runs[family] = (ckpt, out.getvalue())
    return vq_ckpt, runs


@pytest.mark.parametrize("family", BF16_FAMILIES)
def test_bf16_trains_float32_checkpoints(bf16_runs, family):
    """The compute dtype is not recorded: the metadata equals a float32
    run's, and every saved tensor is float32."""
    _, runs = bf16_runs
    ckpt, log = runs[family]
    assert checkpoint.latest_step(ckpt) == 3
    flags = BF16_FAMILIES[family]
    spec = prior.PriorSpec.from_args(prior.parse_args(
        ["sample", "--vqvae-ckpt", "x", "--prior-ckpt", "x", *flags]))
    assert checkpoint.read_extra(ckpt) == {"epoch": 1, **spec.metadata()}
    full = torch.load(os.path.join(ckpt + "_train", "step_3", "state.pt"), weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int32) for v in full.values())
    (line,) = [line for line in log.splitlines() if line.startswith("prior epoch")]
    assert np.isfinite(float(line.split("nll/code ")[1].split()[0]))
    if family == "routed":
        assert np.isfinite(float(line.split("load_balance ")[1].split()[0]))


@pytest.mark.parametrize("family", BF16_FAMILIES)
def test_bf16_samples(bf16_runs, family, tmp_path):
    from scipy.io import wavfile

    vq_ckpt, runs = bf16_runs
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", runs[family][0] + "_ema",
                    "--output-dir", str(tmp_path), "--code-shape", "20", "3",
                    "--num-samples", "2", "--bf16", *BF16_FAMILIES[family]])
    for i in range(2):
        rate, wav = wavfile.read(tmp_path / f"prior_sample_{i:03d}.wav")
        assert rate == SR and wav.shape == (11 * 256,) and np.abs(wav).max() > 0


@pytest.mark.parametrize("direction", ["bf16_trained_f32_sampled", "f32_trained_bf16_sampled"])
def test_the_dtype_is_not_checked_on_restore(trained, bf16_runs, direction, tmp_path):
    """As in JAX, whose checkpoints hold float32 parameters whatever the
    compute dtype: a --bf16 checkpoint samples without --bf16, and a float32
    one with it."""
    _, _, vq_ckpt, f32_ckpt, _, _ = trained
    _, runs = bf16_runs
    ckpt, extra = ((runs["transformer"][0], []) if direction == "bf16_trained_f32_sampled"
                   else (f32_ckpt, ["--bf16"]))
    with contextlib.redirect_stdout(io.StringIO()):
        prior.main(["sample", "--vqvae-ckpt", vq_ckpt, "--prior-ckpt", ckpt, "--output-dir",
                    str(tmp_path), "--code-shape", "20", "3", "--num-samples", "1", *PRIOR,
                    *extra])
    assert os.listdir(tmp_path) == ["prior_sample_000.wav"]
    model = prior.load_prior(ckpt, prior.PriorSpec.from_args(prior.parse_args(
        ["sample", "--vqvae-ckpt", "x", "--prior-ckpt", "x", *PRIOR])), "cpu",
        torch.bfloat16 if extra else torch.float32)
    assert model.compute_dtype == (torch.bfloat16 if extra else torch.float32)
    assert all(p.dtype == torch.float32 for p in model.parameters())

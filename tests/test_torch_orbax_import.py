"""``scripts/torch_import_orbax.py``: a JAX ``cli.main`` run's Orbax
checkpoint imported into the port's format, then continued by the port.

A flat mel VQ-VAE (dim 16, 16 codes) trains one epoch of two steps through
JAX's ``cli.main`` on a synthetic corpus; the importer writes the port's
checkpoint of the same arguments; JAX's ``cli.main --resume`` and the
port's ``cli.main --resume`` (on the CPU) then take the next two steps
from it on the same batches. Tolerance: each step's loss within 1e-5
relative (float32,
two frameworks' orders of sums); the imported state equals JAX's bit for
bit (every value is copied).
"""

import contextlib
import io
import os
import re
import sys

import numpy as np
import pytest
import torch

from neural_sound_generation_tpu.cli import main as jax_main
from neural_sound_generation_tpu_torch.cli import main as port_main
from neural_sound_generation_tpu_torch.data.manifest import ManifestEntry, write_manifest
from neural_sound_generation_tpu_torch.training import checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_import_orbax as importer  # noqa: E402

LOSS_RE = re.compile(r"\sloss=(\S+)")
LOSS_RTOL = 1e-5
DIM, Z_DIM, SR = 16, 16, 22050


def _corpus(root):
    from neural_sound_generation_tpu_torch.config import Config
    from neural_sound_generation_tpu_torch.ops import dsp

    rng = np.random.default_rng(0)
    entries = []
    for i in range(24):
        t = np.arange(int(SR * rng.uniform(0.3, 0.5))) / SR
        f = rng.uniform(100, 300) + rng.uniform(500, 2500) * t / t[-1]
        wav = (0.5 * np.sin(2 * np.pi * np.cumsum(f) / SR)).astype(np.float32)
        mel = dsp.melspectrogram(torch.from_numpy(wav), Config().audio).T.numpy()
        np.save(os.path.join(root, f"a{i}.npy"), wav)
        np.save(os.path.join(root, f"m{i}.npy"), mel.astype(np.float32))
        entries.append(ManifestEntry(f"a{i}.npy", f"m{i}.npy", len(wav), "chirp"))
    write_manifest(root, entries)
    return root


def _losses(fn, argv) -> list:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return [float(v) for v in LOSS_RE.findall(out.getvalue())]


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orbax")
    os.makedirs(tmp / "corpus")
    datadir = _corpus(str(tmp / "corpus"))
    common = ["--model", "vqvae", "--dataset", "ljspeech", "--datadir", datadir,
              "--dim", str(DIM), "--z-dim", str(Z_DIM), "--batch-size", "4",
              "--max-batches-per-epoch", "2", "--log-interval", "1",
              "--sampledir", str(tmp / "results")]
    jax_root, port_root = str(tmp / "jax_models"), str(tmp / "port_models")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_main.main(common + ["--ckpt-dir", jax_root, "--epochs", "1"])
        rc = importer.main(["--jax-ckpt-dir", jax_root, "--", *common,
                            "--ckpt-dir", port_root])
    assert rc == 0
    sub = os.path.join("vqvae", f"checkpoint_ljspeech_{DIM}_{Z_DIM}")
    return {"common": common, "jax": os.path.join(jax_root, sub),
            "port": os.path.join(port_root, sub), "jax_root": jax_root, "port_root": port_root}


def test_the_import_is_the_jax_state(imported):
    """Parameters, statistics, moments and the EMA equal JAX's values bit
    for bit; the step and the metadata carry over."""
    import orbax.checkpoint as ocp

    step = checkpoint.latest_step(imported["port"])
    assert step == 2
    assert checkpoint.read_extra(imported["port"]) == {
        "epoch": 1, "arch": "vqvae", "num_quantizers": 1, "num_downsample": 6}
    with ocp.PyTreeCheckpointer() as reader:
        raw = reader.restore(os.path.join(imported["jax"], f"step_{step}"))["state"]
    saved = torch.load(os.path.join(imported["port"], f"step_{step}", "state.pt"),
                       weights_only=True)
    np.testing.assert_array_equal(saved["params/codebook"].numpy(),
                                  np.asarray(raw["params"]["codebook"]))
    assert int(saved["step"]) == int(np.asarray(raw["step"])) == 2
    assert int(saved["opt_state/count"]) == 2
    # every leaf by name: JAX's flat vectors unravelled by JAX's own
    # ravel_pytree, then named (and transposed) as the port's parameters
    from jax.flatten_util import ravel_pytree

    from neural_sound_generation_tpu_torch import convert

    model = port_main.make_model(port_main.build_config(
        port_main.parse_args(imported["common"] + ["--device", "cpu"])))
    unravel = ravel_pytree(raw["params"])[1]
    names = [name for name, _ in model.named_parameters()]
    for prefix, flat in (("opt_state/m", raw["opt_state"]["m"]),
                         ("opt_state/v", raw["opt_state"]["v"]),
                         ("ema_params", raw["ema_params"])):
        want = convert.flax_to_state_dict({"params": unravel(np.asarray(flat))}, model)
        assert sorted(k for k in saved if k.startswith(prefix + "/")) == sorted(
            f"{prefix}/{n}" for n in names)
        for name in names:
            np.testing.assert_array_equal(saved[f"{prefix}/{name}"].numpy(),
                                          np.asarray(want[name]), err_msg=f"{prefix}/{name}")
    want = convert.flax_to_state_dict({"params": raw["params"],
                                       "batch_stats": raw["batch_stats"]}, model)
    for name in names:
        np.testing.assert_array_equal(saved[f"params/{name}"].numpy(), np.asarray(want[name]),
                                      err_msg=name)
    for name, _ in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_array_equal(saved[f"batch_stats/{name}"].numpy(),
                                          np.asarray(want[name]), err_msg=name)

def test_the_port_resume_takes_jax_next_step(imported):
    """The port's --resume from the import and JAX's --resume from its own
    checkpoint take the same two steps: each loss within 1e-5. The second
    step's loss follows an update made with the imported moments and EMA
    count."""
    common = imported["common"]
    want = _losses(jax_main.main, common + ["--ckpt-dir", imported["jax_root"],
                                            "--epochs", "2", "--resume"])
    got = _losses(port_main.main, common + ["--ckpt-dir", imported["port_root"],
                                            "--epochs", "2", "--resume", "--device", "cpu"])
    assert len(got) == len(want) == 2, (got, want)
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_RTOL * abs(w), (got, want)
    assert checkpoint.latest_step(imported["port"]) == 4


def test_a_parameters_artifact_imports_for_restore_params(imported, tmp_path):
    """``--params``: a JAX ``{"params": ...}`` artifact (as the prior and
    vocoder CLIs write) restores strictly into the port's module, bit for
    bit, with its metadata."""
    import orbax.checkpoint as ocp

    from neural_sound_generation_tpu.training import checkpoint as jax_checkpoint
    from neural_sound_generation_tpu_torch import convert

    with ocp.PyTreeCheckpointer() as reader:
        raw = reader.restore(os.path.join(imported["jax"], "step_2"))["state"]
    src, dst = str(tmp_path / "jax_artifact"), str(tmp_path / "port_artifact")
    jax_checkpoint.save(src, {"params": raw["params"]}, step=7, extra={"averaged": True})
    with contextlib.redirect_stdout(io.StringIO()):
        assert importer.main(["--params", src, dst]) == 0
    args = port_main.parse_args(imported["common"] + ["--device", "cpu"])
    model = port_main.make_model(port_main.build_config(args))
    assert checkpoint.restore_params(dst, model) == {"averaged": True}
    want = convert.flax_to_state_dict({"params": raw["params"]}, model)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], rtol=0, atol=0)


def test_the_importer_refuses_a_missing_mode():
    with pytest.raises(SystemExit):
        importer.main([])

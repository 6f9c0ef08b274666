"""Guards on the port as a package: it stands apart from JAX and from the
JAX package, and it never carries on quietly without a CUDA device."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest
import torch

import neural_sound_generation_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
             "neural_sound_generation_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
    )


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter: tests/conftest.py imports jax into this one."""
    modules = _port_modules()
    for name in ("cli.serve", "cli.main", "cli.evaluate", "cli.prior", "training.trainer",
                 "training.checkpoint", "data.pipeline", "ops.cuda.fused_adam",
                 "ops.cuda.flash_attention", "ops.attention", "models.transformer_prior",
                 "inference.audio", "models.wavenet", "ops.cuda.wavenet_gen", "cli.vocoder",
                 "serving.mux", "ops.cuda.conv3x3", "ops.lws", "data.corpora",
                 "data.corpora.engine", "data.corpora.ljspeech", "data.corpora.cmu_arctic",
                 "data.corpora.jsut", "data.corpora.librivox", "cli.preprocess",
                 "cli.invert"):
        assert f"neural_sound_generation_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _python_sources():
    root = os.path.dirname(port.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    scripts = os.path.join(REPO, "scripts")
    for f in sorted(os.listdir(scripts)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(scripts, f)


def test_sources_import_nothing_of_jax():
    offenders = []
    for path in _python_sources():
        tree = ast.parse(open(path, encoding="utf-8").read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not offenders


def test_entry_points_without_a_device_raise_when_cuda_is_absent(monkeypatch):
    from neural_sound_generation_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Here there is no CUDA device: the script must exit non-zero and
    print no result, from the repository and from a directory that holds
    the script alone."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    out = subprocess.run(
        [sys.executable, script], cwd=cwd, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout

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


#: the JAX package's modules with no counterpart at the same relative path
#: in the port, and why
JAX_ONLY = {
    "ops/pallas/__init__.py": "the Pallas kernels' port is ops/cuda/ with csrc/",
    "ops/pallas/attention.py": "ported as ops/cuda/flash_attention.py and csrc/flash_attention.cu",
    "ops/pallas/fused_adam.py": "ported as ops/cuda/fused_adam.py and csrc/fused_adam.cu",
    "ops/pallas/vq_kernel.py": "ported as ops/cuda/vq_kernel.py and csrc/vq_nearest.cu",
    "ops/pallas/wavenet_gen.py": "ported as ops/cuda/wavenet_gen.py and csrc/wavenet_gen.cu",
    "utils/compilation_cache.py": "XLA's persistent compilation cache: JAX only",
}
#: the modules the last JAX modules' port added
NEW_MODULES = ("parallel.sequence", "data.native_loader", "utils", "utils.augment",
               "utils.profiling", "utils.spectrogram_dataset", "utils.visualize",
               "config.tacotron")
JAX_PACKAGE = os.path.join(REPO, "neural_sound_generation_tpu")


def _jax_modules():
    return sorted(
        os.path.relpath(os.path.join(d, f), JAX_PACKAGE).replace(os.sep, "/")
        for d, _, files in os.walk(JAX_PACKAGE) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_jax_module_has_a_counterpart(module):
    """The port has a module of the same relative path, or the JAX module
    stands on ``JAX_ONLY`` with its reason (and then has no such module)."""
    ours = os.path.join(os.path.dirname(port.__file__), *module.split("/"))
    assert os.path.exists(ours) != (module in JAX_ONLY), (
        f"{module}: {'listed as JAX-only but ported' if module in JAX_ONLY else 'no counterpart'}")


def test_every_jax_only_entry_names_a_jax_module():
    assert set(JAX_ONLY) <= set(_jax_modules())


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
                 "models.pixelcnn",
                 "inference.audio", "models.wavenet", "ops.cuda.wavenet_gen", "cli.vocoder",
                 "serving.mux", "ops.cuda.conv3x3", "ops.lws", "data.corpora",
                 "data.corpora.engine", "data.corpora.ljspeech", "data.corpora.cmu_arctic",
                 "data.corpora.jsut", "data.corpora.librivox", "cli.preprocess",
                 "cli.invert", "motion", "motion.capture", "motion.pca",
                 "motion.inference", "cli.motion", "parallel", "parallel.distributed",
                 "parallel.mesh", "training.sharding", *NEW_MODULES):
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


@pytest.mark.parametrize("worker", ["torch_dp_worker.py", "torch_tp_worker.py",
                                    "torch_prior_tp_worker.py", "torch_ae_tp_worker.py",
                                    "torch_gated_tp_worker.py", "torch_pp_worker.py"])
def test_the_rank_workers_import_no_jax(worker):
    """The rank processes of the parallel tests run the port alone: no
    import of JAX or of the JAX package anywhere in their source."""
    tree = ast.parse(open(os.path.join(REPO, "tests", worker), encoding="utf-8").read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [n for n in names if _forbidden(n)]


def test_the_motion_package_loads_nothing_of_the_jax_package():
    """In a fresh interpreter: importing the motion path and running its
    native runtime loads no module, and maps no file, from the JAX
    package's directory."""
    jax_dir = os.path.join(REPO, "neural_sound_generation_tpu") + os.sep
    code = (
        "import sys\n"
        "import neural_sound_generation_tpu_torch.motion as m\n"
        "import neural_sound_generation_tpu_torch.motion.inference\n"
        "import neural_sound_generation_tpu_torch.cli.motion\n"
        "c = m.synthetic_controller(seed=0, n_frames=2)\n"
        "c.drain(2)\n"
        "c.close()\n"
        "files = [getattr(mod, '__file__', None) or '' for mod in list(sys.modules.values())]\n"
        "files += [l.split()[-1] for l in open('/proc/self/maps') if '/' in l]\n"
        f"print(sorted({{f for f in files if f.startswith({jax_dir!r})}}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


#: the port's scripts that bridge to the JAX package by design, and why
BRIDGES = {"torch_import_orbax.py": "reads Orbax checkpoints, and Orbax imports JAX"}


def _python_sources():
    root = os.path.dirname(port.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")
    scripts = os.path.join(REPO, "scripts")
    for f in sorted(os.listdir(scripts)):
        if f.startswith("torch_") and f.endswith(".py") and f not in BRIDGES:
            yield os.path.join(scripts, f)


def _imported_names(path: str) -> list[str]:
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    return names + [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]


def test_no_port_source_imports_a_bridge():
    """The bridges stand outside the port: no module of the package, no
    other script and not ``chip_smoke.py`` imports one."""
    offenders = [f"{path}: {name}" for path in _python_sources()
                 for name in _imported_names(path)
                 if name.split(".")[-1] in {b[:-3] for b in BRIDGES}]
    assert not offenders


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

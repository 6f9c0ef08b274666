"""No run loads JAX or the JAX package, and the references load nothing of
the port: checked in fresh interpreters, module names compared whole by
their top-level part (the port's name begins with the JAX package's)."""

import json
import subprocess
import sys

from portbench.harness import ROOT

RUN_MODULES = """
import sys, json
sys.path.insert(0, {root!r})
from portbench.harness import Cell, load_module, forbidden_modules
spec = json.load(open({root!r} + "/BENCHMARK.json"))
import portbench.run, portbench.calibrate
for w in spec["workloads"]:
    cell = Cell(w["name"])
    load_module("drivers", cell.traffic["driver"])
    family = load_module("families", cell.config["family"])
for m in spec["per_layer"]:
    load_module("metrics", m["name"])
# what the drivers import inside their run: the port's entry points
import neural_sound_generation_tpu_torch.cli.main
import neural_sound_generation_tpu_torch.cli.vocoder
import neural_sound_generation_tpu_torch.training.trainer
import neural_sound_generation_tpu_torch.ops.cuda.build
print(json.dumps(forbidden_modules()))
"""

REFERENCE_MODULES = """
import sys, json, pkgutil, importlib
sys.path.insert(0, {root!r})
import portbench.reference as ref
for info in pkgutil.iter_modules(ref.__path__):
    importlib.import_module("portbench.reference." + info.name)
tops = sorted({{m.split(".", 1)[0] for m in sys.modules}})
print(json.dumps([t for t in tops if t.startswith("neural_sound_generation_tpu") or t in ("jax", "jaxlib", "flax")]))
"""


def _fresh(code: str):
    env_free = {"PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True,
                         text=True, timeout=300, env={**__import__("os").environ, **env_free})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    assert _fresh(RUN_MODULES) == []


def test_the_references_load_nothing_of_the_port():
    assert _fresh(REFERENCE_MODULES) == []

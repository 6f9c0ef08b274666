"""``BENCHMARK.json`` against the rules of its format (keys, names, units,
bounds, the time a full check of 24 cells takes), and every file a cell
needs found by name."""

import inspect
import json
import re

import pytest

from portbench.harness import HERE, ROOT, Cell, load_module, read_json

SPEC = read_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["per_layer"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert all(not p.startswith("/") and ".." not in p for p in SPEC["command"] + SPEC["paths"])


def test_run_seconds_fits_a_full_check():
    t = SPEC["run_seconds"]
    assert isinstance(t, int) and 1 <= t <= 51
    cells = 24
    assert (2 + 14 * cells) * (t + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_metrics_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_file(name):
    entry = [c for c in SPEC["configs"] if c["name"] == name][0]
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"] == f"portbench/configs/{name}.json"
    assert _line(entry["source"]) and _line(entry["why"])
    config = read_json(ROOT / entry["file"])
    assert config["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    assert config["source"] == entry["source"]
    family = load_module("families", config["family"])
    for fn in ("param_table", "build_program", "make_pool", "reference_loss", "step_flops",
               "audio_seconds_per_step"):
        assert callable(getattr(family, fn)), fn
    assert any(w["config"] == name for w in SPEC["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    cell = Cell(name)
    assert cell.chips in (1, 4) and _line(cell.workload["why"])
    assert NAME.match(cell.workload["traffic"])
    driver = load_module("drivers", cell.traffic["driver"])
    assert list(inspect.signature(driver.run).parameters)[:6] == [
        "cell", "seed", "seconds", "trace", "device", "clock"]
    assert cell.limits and all(isinstance(v, float) for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer()
    for m in SPEC["per_layer"]:
        if name in m.get("workloads", []):
            assert m["moves"] in reported


def test_four_chip_cells_are_few():
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader(name):
    reader = load_module("metrics", name)
    assert reader.__doc__ and callable(reader.read)
    assert reader.read({}) is None  # nothing to read: the metric is left out


def test_every_file_is_named_from_names():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_traffic_files_parse():
    for path in (HERE / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()

"""``BENCHMARK.json`` and the files it names: every entry loads, keeps to
the benchmark's contract, and a new cell is found by its name alone."""

import ast
import json
import os
import re
import shutil

import pytest

from cellbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpukernels"}


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_loads_with_its_metrics(w):
    c = spec.cell(w["name"])
    assert c.chips == w["chips"] in (1, 4)
    for kind in ("inputs", "work", "reference"):
        assert spec.load_module(kind, c.kernel)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer and all(m["moves"] in e2e for m in c.per_layer)
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert c.traffic["limits"]


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_every_config_file_states_its_source_and_cuts(c):
    data = spec.load_json(os.path.join(spec.ROOT, c["file"]))
    assert c["file"] == f"cellbench/configs/{c['name']}.json"
    assert data["source"] == c["source"] and len(c["source"]) <= 200
    assert data["reduced"] == c["reduced"]
    assert data["kernel"] and data["dtype"] == "float32"


def test_the_file_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert not p.endswith("_torch") and os.path.isdir(
            os.path.join(spec.ROOT, p))
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(
        BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%" and m["source"] == "device_trace"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_cell_added_as_files_and_an_entry_is_found_by_name(tmp_path):
    """A new traffic mix is a data file and an entry: nothing of the
    harness is edited."""
    here = tmp_path / "cellbench"
    shutil.copytree(spec.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    traffic = spec.load_json(spec.traffic_file("steps10"))
    traffic.update(name="steps1", statics={"steps": 1})
    (here / "traffic" / "steps1.json").write_text(json.dumps(traffic))
    bench["workloads"].append({
        "name": "nbody-65536.steps1", "config": "nbody-65536",
        "traffic": "steps1", "chips": 1, "why": "one step a call"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("nbody-65536.steps1", root=str(tmp_path), here=str(here))
    assert c.traffic["statics"] == {"steps": 1}
    assert c.kernel == "nbody"
    per = {m["name"] for m in c.per_layer}
    assert {"canary_ms_per_call", "launches_per_call",
            "device_idle_pct"} <= per
    with pytest.raises(KeyError):
        spec.cell("nbody-65536.absent", root=str(tmp_path), here=str(here))


def test_a_metric_added_as_a_reader_file_is_read_by_name(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "calls_total.py").write_text(
        "def read(rec):\n    return rec.get('calls')\n")
    mod = spec.load_module("metrics", "calls_total", here=str(tmp_path))
    assert mod.read({"calls": 7}) == 7
    with pytest.raises(FileNotFoundError):
        spec.load_module("metrics", "absent", here=str(tmp_path))


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(spec.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``tpukernels_torch`` begins with
    ``tpukernels`` and is allowed."""
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        top = {m.split(".", 1)[0] for m in _imports(path)}
        assert not top & FORBIDDEN, (path, top & FORBIDDEN)


def test_the_references_import_nothing_of_the_program():
    for sub in ("reference", "work", "inputs", "metrics"):
        for path in _sources(sub):
            top = {m.split(".", 1)[0] for m in _imports(path)}
            assert top <= {"torch", "math", "cellbench"}, (path, top)

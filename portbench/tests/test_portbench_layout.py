"""BENCHMARK.json and the files it names: allowed names and units, every
cell's pieces found by name, a new cell picked up from new files alone,
and the isolation of the harness and the reference from JAX and from the
program."""

from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound", "layer", "moves",
               "workloads"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("section, keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries_have_exactly_their_keys(section, keys):
    for entry in BENCH[section]:
        assert set(entry) == keys
        for text in (entry["why"], entry.get("source", "-")):
            assert 1 <= len(text) <= 200
            assert "\n" not in text and "\t" not in text


def _names():
    for c in BENCH["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric) <= METRIC_KEYS
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    assert (harness.HERE / "metrics" / f"{metric['name']}.py").is_file()
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        assert set(metric["workloads"]) <= set(moves.get("workloads", cells))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = harness.Cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces_by_name(name):
    cell = harness.Cell(name)
    assert cell.chips == 1
    assert (harness.HERE / "drivers" / f"{cell.driver}.py").is_file()
    assert cell.limits and set(cell.limits) <= set(harness.load_module(
        harness.HERE / "drivers" / f"{cell.driver}.py").CHECKED)
    assert cell.config["name"] == cell.entry["config"]
    source = {c["name"]: c for c in BENCH["configs"]}[cell.entry["config"]]
    assert set(source["reduced"]) == set(cell.config["reduced"])
    assert source["source"] == cell.config["source"]


def test_a_new_cell_is_picked_up_from_new_files(tmp_path):
    """A cell added by data alone: a BENCHMARK.json entry, its traffic and
    its limits, with no edit to any file the benchmark had."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "v2-train-b64", "config": "v2",
                               "traffic": "train-b64-bf16", "chips": 1,
                               "why": "a made-up cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.loads((ROOT / "portbench/traffic/train-b32-bf16.json").read_text())
    traffic["batch_size"] = 64
    (root / "portbench/traffic/train-b64-bf16.json").write_text(json.dumps(traffic))
    limits = (ROOT / "portbench/workloads/v2-train-b32.json").read_text()
    (root / "portbench/workloads/v2-train-b64.json").write_text(limits)
    cell = harness.Cell("v2-train-b64", root=root)
    assert cell.traffic["batch_size"] == 64 and cell.config["name"] == "v2"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


SOURCES = sorted(harness.HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_nothing_imports_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "genome_minimizer_2_torch" not in tops
    assert tops <= {"__future__", "math", "statistics", "numpy", "torch"}


def test_forbidden_modules_are_matched_by_whole_top_level_name(monkeypatch):
    for name in ("genome_minimizer_2_torch_like", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "genome_minimizer_2_tpu.ops", sys)
    assert harness.loaded_forbidden() == ["genome_minimizer_2_tpu.ops", "jax.numpy"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "v0-train-b32", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"CUDA_VISIBLE_DEVICES": "",
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA device" in out.stderr

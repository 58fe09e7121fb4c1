"""BENCHMARK.json against the benchmark format's rules, and every piece it
names found by name in files of its own."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E = {m["name"]: m for m in SPEC["end_to_end"]}
CELLS = {w["name"]: w for w in SPEC["workloads"]}
WIDTHS = ("hidden", "intermediate", "latent", "state", "projection",
          "head", "expansion", "experts_per", "width", "channels")


def line_ok(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert PATH.match(path) and not path.startswith("/")
        assert ".." not in path.split("/")
        assert os.path.isdir(os.path.join(ROOT, path))
    assert len(SPEC["command"]) <= 32
    assert all(line_ok(w) for w in SPEC["command"])
    script = SPEC["command"][1]
    assert any(script.startswith(p + "/") for p in SPEC["paths"])


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"]) and line_ok(conf["source"])
    assert line_ok(conf["why"]) and len(conf["reduced"]) <= 16
    assert any(conf["file"].startswith(p + "/") for p in SPEC["paths"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        data = json.load(f)
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    for key in conf["reduced"]:
        assert NAME.match(key) and key in data
        assert not key.endswith(("_dim", "_rank"))
        assert not any(w in key for w in WIDTHS), key
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])


@pytest.mark.parametrize("work", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_pieces_exist(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(work["name"]) and NAME.match(work["traffic"])
    assert work["chips"] in (1, 4) and line_ok(work["why"])
    cell = harness.load_cell(work["name"])
    bench = harness.BENCH_DIR
    assert os.path.exists(os.path.join(
        bench, "drivers", cell.traffic["driver"] + ".py"))
    assert hasattr(harness.driver(cell.traffic["driver"]), "run")
    assert cell.limits, "every cell compares some number"
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_names_are_unique_and_pairs_once():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metric_names = list(E2E) + [m["name"] for m in SPEC["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("metric", SPEC["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    assert line_ok(metric["layer"])
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", list(CELLS)):
        assert cell in CELLS
        assert harness.applies(moved, cell), (metric["name"], cell)
    reader = harness.metric_reader(metric["name"])
    assert callable(reader.read)


def test_layer_names_are_consistent():
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())

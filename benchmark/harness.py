"""Finds a cell's pieces by name, runs its driver, judges and prints.

Everything a cell needs is found from `BENCHMARK.json` at the checkout's
root: the workload entry names a configuration (its file) and a traffic
mix (`benchmark/traffic/<traffic>.json`, which names the driver,
`benchmark/drivers/<driver>.py`); the limits of its comparisons are in
`benchmark/limits/<cell>.json`; each per-layer metric is read by
`benchmark/metrics/<metric>.py`. Adding a cell, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "deepvariant_tpu"})


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str = ROOT) -> Dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    spec = benchmark_spec(root)
    work = next((w for w in spec["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == work["config"])
    return make_cell(name, os.path.join(root, conf["file"]), work["traffic"],
                     work["chips"], spec)


def make_cell(name: str, config_file: str, traffic: str, chips: int = 1,
              spec: Optional[Dict] = None) -> Cell:
    """A cell from its files: the configuration's, the traffic mix's and
    its limits; its metrics are those of `spec` that name it."""
    spec = spec or {"end_to_end": [], "per_layer": []}
    return Cell(
        name=name,
        chips=chips,
        config=_load_json(config_file),
        traffic=_load_json(os.path.join(BENCH_DIR, "traffic",
                                        traffic + ".json")),
        limits=_load_json(os.path.join(BENCH_DIR, "limits", name + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if applies(m, name)],
    )


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return load_file_module(os.path.join(BENCH_DIR, "drivers", name + ".py"),
                            f"benchmark.drivers.{name}")


def metric_reader(name: str):
    return load_file_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                            f"benchmark.metrics.{name}")


@dataclasses.dataclass
class Check:
    """One number compared, with its limit: fine while value <= limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float
    # What a test plants in the timed path (see benchmark/tests/test_bench_faults.py).
    fault: Optional[str] = None


@dataclasses.dataclass
class Outcome:
    metrics: Dict[str, float]      # end-to-end values by name
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    facts: Dict = dataclasses.field(default_factory=dict)
    spans: object = None           # tracing.Spans
    reduced: object = None         # tracing.Reduced (traced runs)
    readings: Dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and self.failed == 0 and all(
            c.ok for c in self.checks)


def run(ctx: Context) -> Outcome:
    return driver(ctx.cell.traffic["driver"]).run(ctx)


def done_in_window(finished: List[float], start: float, end: float
                   ) -> float:
    """Units of work done in [start, end], from the sorted times at
    which units finished: the whole ones, and the share of the one in
    progress at `end` that lay inside the window."""
    whole = bisect.bisect_right(finished, end)
    if whole == len(finished):
        return float(whole)
    prev = finished[whole - 1] if whole else start
    return whole + (end - prev) / (finished[whole] - prev)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared as whole names."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def result_line(ctx: Context, out: Outcome, device: Dict) -> Dict:
    """The last line's object: the end-to-end metrics untraced, the
    per-layer ones traced; the numbers compared come last."""
    cell = ctx.cell
    metrics = {}
    if ctx.trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"]).read(out)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if ctx.trace and out.reduced is not None:
        line["breakdown"] = {"device_ops": out.reduced.top_ops(),
                             "idle_gaps": out.reduced.top_idle()}
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    return line

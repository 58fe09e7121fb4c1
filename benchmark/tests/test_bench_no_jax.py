"""Nothing the benchmark runs imports JAX or the JAX package, compared
by whole top-level module names (`deepvariant_tpu_torch` begins with
`deepvariant_tpu` and is allowed); the reference imports nothing of the
port either."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.BENCH_DIR
FILES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))
PORT = "deepvariant_tpu_torch"


def imported_tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import_in_source(path):
    assert not imported_tops(path) & harness.FORBIDDEN


@pytest.mark.parametrize("path", [
    p for p in FILES if os.sep + "reference" + os.sep in p],
    ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported_tops(path)


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_what_a_run_loads_holds_no_jax():
    mods = _loaded_after(
        "import benchmark.harness as h, benchmark.tracing, "
        "benchmark.calibrate\n"
        "import deepvariant_tpu_torch.training.train\n"
        "spec = h.benchmark_spec()\n"
        "[h.driver(h.load_cell(w['name']).traffic['driver']) "
        "for w in spec['workloads']]\n"
        "[h.metric_reader(m['name']) for m in spec['per_layer']]\n")
    assert PORT in mods
    assert not mods & harness.FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded_after(
        "import benchmark.reference.inception_v3, "
        "benchmark.reference.paint, benchmark.reference.train")
    assert not mods & (harness.FORBIDDEN | {PORT})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepvariant_tpu_torch_x", sys)
    assert "deepvariant_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()

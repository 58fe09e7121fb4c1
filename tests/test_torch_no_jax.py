"""The PyTorch port (deepvariant_tpu_torch) and chip_smoke.py import
nothing of JAX, flax, optax or the JAX package."""

import ast
import glob
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepvariant_tpu")

# Every module of the port; the subprocess below imports each and the
# scan reads each one's source.
MODULES = tuple("deepvariant_tpu_torch." + name for name in (
    "device",
    "calling.call_variants", "calling.cvo_writer", "calling.plan_predictor",
    "core.cigar", "core.distribution", "core.genomics_math",
    "core.protowire", "core.ranges",
    "core.sequence_utils", "core.sharded_files", "core.types",
    "io.bam", "io.bam_writer", "io.bgzf", "io.cram", "io.examples",
    "io.fasta",
    "io.flax_msgpack", "io.genomics_io", "io.gbz", "io.methylation", "io.tabix", "io.tfrecord",
    "io.vcf",
    "labeler.combined_labeler", "labeler.compare_labelers",
    "labeler.customized_classes_labeler", "labeler.haplotype_labeler",
    "labeler.labeled_examples_to_vcf", "labeler.soft_labeler",
    "labeler.variant_labeler",
    "make_examples.allele_counter", "make_examples.allele_frequency",
    "make_examples.alt_aligned",
    "make_examples.core", "make_examples.examples_builder",
    "make_examples.multisample",
    "make_examples.normalize",
    "make_examples.pileup", "make_examples.pileup_device",
    "make_examples.presets", "make_examples.shuffle",
    "make_examples.variant_caller", "make_examples.vcf_candidate_importer",
    "models.checkpoint", "models.inception_v3", "models.keras_import",
    "ops._build", "ops.batch_norm_relu", "ops.pileup_paint", "ops.pool",
    "parallel.distribute", "parallel.multihost", "parallel.stream_pipeline",
    "phasing.direct_phasing", "phasing.merge_phased_reads",
    "phasing.methylation_aware_phasing",
    "postprocess.genotype", "postprocess.haplotypes", "postprocess.merge",
    "postprocess.multiallelic_model", "postprocess.pipeline",
    "realign.config", "realign.debruijn_graph", "realign.fast_pass_aligner",
    "realign.realigner", "realign.ssw", "realign.window_selector",
    "scripts.accuracy_chr20", "scripts.accuracy_deeptrio",
    "scripts.accuracy_hybrid", "scripts.accuracy_longread",
    "scripts.accuracy_ont", "scripts.accuracy_sim",
    "scripts.accuracy_somatic", "scripts.accuracy_trio",
    "scripts.call_variants", "scripts.export_model",
    "scripts.import_keras_model", "scripts.make_examples",
    "scripts.multisample_make_examples",
    "scripts.postprocess_variants", "scripts.resume_somatic_eval",
    "scripts.run_deepsomatic",
    "scripts.run_deeptrio", "scripts.run_deepvariant",
    "scripts.run_pangenome_aware_deepvariant",
    "scripts.run_oracle_inference", "scripts.train",
    "scripts.train_small_model",
    "small_model.features", "small_model.model", "small_model.train",
    "testing.accuracy_inputs", "testing.cram_writer", "testing.synthetic",
    "tools.dashboard", "tools.fn_audit", "tools.preprocess_truth",
    "tools.print_f1", "tools.runtime_by_region_vis", "tools.show_examples",
    "tools.shuffle_tfrecords", "tools.vcf_eval", "tools.vcf_stats",
    "tools.vis",
    "training.config", "training.data", "training.metrics",
    "training.simulate", "training.simulate_family",
    "training.simulate_longread",
    "training.train", "training.train_resident",
    "utils.resources", "utils.trace",
))

_SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
import numpy as np
import deepvariant_tpu_torch
names = [info.name for info in pkgutil.walk_packages(
    deepvariant_tpu_torch.__path__, "deepvariant_tpu_torch.")]
for name in names:
    importlib.import_module(name)
missing = set(%r) - set(names)
assert not missing, missing
from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.io import examples
from deepvariant_tpu_torch.io.tfrecord import TFRecordWriter
from deepvariant_tpu_torch.make_examples.pileup import WGS_CHANNELS
from deepvariant_tpu_torch.scripts import call_variants as cli
import torch
torch.set_num_threads(2)
d = tempfile.mkdtemp()
path = os.path.join(d, "ex.tfrecord")
rng = np.random.RandomState(0)
with TFRecordWriter(path) as w:
    for i in range(2):
        v = Variant(reference_name="chr1", start=10 + i, end=11 + i,
                    reference_bases="A", alternate_bases=["C"])
        w.write(examples.make_example(
            v, rng.randint(0, 255, (100, 221, 7), np.uint8), [0],
            f"chr1:{11 + i}-{12 + i}"))
examples.write_example_info(path, (100, 221, 7), WGS_CHANNELS)
rc = cli.main(["--examples", path, "--outfile", os.path.join(d, "cvo.gz"),
               "--allow_uninitialized_model", "--device", "cpu",
               "--batch_size", "2"])
assert rc == 0, rc
# The train CLI on the CPU: labeled examples, one step, one tune batch.
from deepvariant_tpu_torch.scripts import train as train_cli
from deepvariant_tpu_torch.training.data import DatasetConfig
labeled = os.path.join(d, "train.tfrecord")
with TFRecordWriter(labeled) as w:
    for i in range(2):
        v = Variant(reference_name="chr1", start=10 + i, end=11 + i,
                    reference_bases="A", alternate_bases=["C"])
        w.write(examples.make_example(
            v, rng.randint(0, 255, (100, 221, 7), np.uint8), [0],
            f"chr1:{11 + i}-{12 + i}", label=i))
examples.write_example_info(labeled, (100, 221, 7), WGS_CHANNELS)
DatasetConfig(tfrecord_path=labeled, num_examples=2).write(
    os.path.join(d, "ds.pbtxt"))
rc = train_cli.main([
    "--config", "wgs_test", "--train_dataset_config",
    os.path.join(d, "ds.pbtxt"), "--tune_dataset_config",
    os.path.join(d, "ds.pbtxt"), "--experiment_dir", os.path.join(d, "exp"),
    "--batch_size", "2", "--num_epochs", "1", "--device", "cpu"])
assert rc == 0, rc
assert os.path.exists(os.path.join(d, "exp", "checkpoints", "best.msgpack"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in %r)
assert not bad, bad
print("clean")
""" % (MODULES, FORBIDDEN)


def test_port_runs_without_importing_jax(tmp_path):
    # The script's temporary files (a full-width checkpoint, 0.5 GB) go
    # under tmp_path, which pytest removes with its old base directories.
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout


_STREAM_SCRIPT = r"""
import os, sys, tempfile
import torch
torch.set_num_threads(2)
from deepvariant_tpu_torch.core import types
from deepvariant_tpu_torch.io import bam, bam_writer
from deepvariant_tpu_torch.make_examples import core, presets
from deepvariant_tpu_torch.models.inception_v3 import InceptionV3
from deepvariant_tpu_torch.parallel.stream_pipeline import (
    stream_examples_to_cvos)
from deepvariant_tpu_torch.testing import synthetic
sample = synthetic.synthetic_sample(3, (("chr1", 2500),))
paths = synthetic.write_inputs(sample, tempfile.mkdtemp(), types, bam,
                               bam_writer)
options = core.MakeExamplesOptions(
    reads_filename=paths["reads"], ref_filename=paths["ref"],
    regions=["chr1:200-700"])   # realigner on, the preset's default
presets.apply_model_preset(options, "WGS")
torch.manual_seed(0)
cvos, stats, _ = stream_examples_to_cvos(
    options, 1, model=InceptionV3(7), batch_size=4, device_encode=True,
    device="cpu", dtype=torch.float32)
assert stats.num_cvos == len(cvos) > 0, stats
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
print("clean", len(cvos))
""" % (FORBIDDEN,)


def test_stream_worker_runs_without_jax(tmp_path):
    """The stream path from files, one spawned worker, on the CPU. The
    worker is a process of its own, so `sys.modules` of this process says
    nothing about it: stand-ins for the forbidden packages that raise
    on import come first on the path the worker inherits, and a worker
    that fails fails the stream."""
    for name in FORBIDDEN:
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"raise ImportError('the port must not import {name}')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}",
               TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _STREAM_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout


_TRAINING_SCRIPT = r"""
import json, os, sys, tempfile
from deepvariant_tpu_torch.core import types
from deepvariant_tpu_torch.io import bam, bam_writer
from deepvariant_tpu_torch.make_examples import core, presets
from deepvariant_tpu_torch.testing import cram_writer, synthetic
d = tempfile.mkdtemp()
sample = synthetic.synthetic_sample(3, (("chr1", 2000),))
paths = synthetic.write_inputs(sample, d, types, bam, bam_writer)
paths.update(synthetic.write_truth_inputs(sample, d, seed=1))
cram = cram_writer.write_cram(sample, os.path.join(d, "reads.cram"))
options = core.MakeExamplesOptions(
    mode="training", reads_filename=cram, ref_filename=paths["ref"],
    truth_variants_filename=paths["truth"],
    confident_regions_filename=paths["confident"],
    examples_filename=os.path.join(d, "ex.tfrecord"),
    realigner_enabled=False, regions=["chr1:100-900"])
presets.apply_model_preset(options, "WGS")
counts = core.make_examples_runner(options)
with open(os.path.join(d, "ex.tfrecord.labeling_metrics.json")) as f:
    metrics = json.load(f)
assert counts["examples"] > 0 and metrics["n_true_positive_sites"] > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
print("clean", counts["examples"])
""" % (FORBIDDEN,)


def test_cram_training_run_without_jax(tmp_path):
    """A training-mode run of the runner on a CRAM (the haplotype
    labeler, the labeling metrics) with the forbidden packages made
    unimportable."""
    for name in FORBIDDEN:
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"raise ImportError('the port must not import {name}')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}",
               TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _TRAINING_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout


_SIMULATE_SCRIPT = r"""
import os, sys, tempfile
import numpy as np
from deepvariant_tpu_torch.core import types
from deepvariant_tpu_torch.io import bam, bam_writer
from deepvariant_tpu_torch.testing import synthetic
from deepvariant_tpu_torch.tools import show_examples, vcf_eval, vis
from deepvariant_tpu_torch.training import simulate
d = tempfile.mkdtemp()
paths = synthetic.write_inputs(synthetic.synthetic_sample(
    3, (("chr1", 8000),)), d, types, bam, bam_writer)
out = simulate.simulate_corpus(simulate.SimConfig(
    paths["ref"], "chr1", [(1000, 7000)], seed=1,
    template_bam=paths["reads"], template_region=("chr1", 0, 8000)),
    os.path.join(d, "sim"))
metrics = vcf_eval.evaluate(out["truth_vcf"], out["truth_vcf"],
                            out["confident_bed"])
assert out["n_variants"] > 0 and metrics["all"]["f1"] == 1.0, metrics
vis.save_to_png(np.arange(12.0).reshape(3, 4), os.path.join(d, "a.png"))
show_examples.save_example_png(np.zeros((5, 4, 3), np.uint8),
                               os.path.join(d, "b.png"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
assert not bad, bad
print("clean", out["n_variants"])
""" % (FORBIDDEN + ("PIL",),)


def test_simulate_and_score_without_jax(tmp_path):
    """A corpus simulated from a seeded template and scored by vcf_eval,
    and PNGs without a header written, with the forbidden packages and
    Pillow made unimportable, as on a machine without Pillow."""
    for name in FORBIDDEN + ("PIL",):
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"raise ImportError('the port must not import {name}')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}",
               TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", _SIMULATE_SCRIPT],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout


@pytest.mark.parametrize("script", [
    "make_examples", "run_deepvariant", "train", "train_small_model",
    "run_oracle_inference", "export_model", "import_keras_model",
    "accuracy_sim", "accuracy_trio", "accuracy_somatic",
    "resume_somatic_eval", "accuracy_hybrid", "accuracy_longread",
    "accuracy_chr20", "accuracy_ont", "accuracy_deeptrio"])
def test_clis_answer_help_without_jax(script, tmp_path):
    """`python -m deepvariant_tpu_torch.scripts.<script> --help` with the
    forbidden packages made unimportable (stand-ins that raise on import
    come first on the path)."""
    for name in FORBIDDEN:
        pkg = tmp_path / name
        pkg.mkdir()
        (pkg / "__init__.py").write_text(
            f"raise ImportError('the port must not import {name}')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}",
               TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", f"deepvariant_tpu_torch.scripts.{script}",
         "--help"], cwd=str(tmp_path), env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith(f"usage: {script}")


def _tree_imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _code_strings(tree):
    """The string constants of a module that are Python source with an
    import in it: the code a module hands to `python -c` (the accuracy
    drivers' make_examples workers, chip_smoke's child processes)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "import" in node.value:
            try:
                code = ast.parse(node.value)
            except SyntaxError:
                continue
            if any(True for _ in _tree_imports(code)):
                yield code


def _imports(path):
    """Every module `path` imports, in its own code and in the code it
    passes to child Pythons as strings."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    yield from _tree_imports(tree)
    for code in _code_strings(tree):
        yield from _tree_imports(code)


def test_module_list_is_complete():
    files = glob.glob(os.path.join(REPO, "deepvariant_tpu_torch", "**",
                                   "*.py"), recursive=True)
    found = {os.path.relpath(f, REPO)[:-3].replace(os.sep, ".")
             for f in files if not f.endswith("__init__.py")}
    assert found == set(MODULES)


@pytest.mark.parametrize("module", MODULES + ("chip_smoke",))
def test_no_source_file_names_a_forbidden_module(module):
    path = os.path.join(REPO, *module.split(".")) + ".py"
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)


@pytest.mark.parametrize("module,name", [
    ("scripts.accuracy_sim", "_WORKER_CODE"),
    ("scripts.accuracy_trio", "_MULTI_WORKER_CODE")])
def test_worker_strings_are_scanned(module, name):
    """The drivers' `python -c` worker code imports the port, and the
    scan sees it: the same code importing the JAX package fails it."""
    import importlib

    code = getattr(importlib.import_module(
        "deepvariant_tpu_torch." + module), name)
    assert "deepvariant_tpu_torch.make_examples" in code
    path = os.path.join(REPO, "deepvariant_tpu_torch",
                        *module.split(".")) + ".py"
    names = set(_imports(path))
    assert "deepvariant_tpu_torch.make_examples.core" in names
    bad = code.replace("deepvariant_tpu_torch.", "deepvariant_tpu.")
    tree = ast.parse(f"{name} = {bad!r}\n")
    found = {n for c in _code_strings(tree) for n in _tree_imports(c)}
    assert "deepvariant_tpu.make_examples.core" in found
    assert any(n.split(".")[0] in FORBIDDEN for n in found)

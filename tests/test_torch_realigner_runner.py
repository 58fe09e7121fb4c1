"""Stage 1 with the realigner on, the WGS preset's default: the port's
`make_examples_runner` against the JAX package's on a seeded sample whose
windows assemble (`torch_port_util.sparse_sample`: a variant every
400-500 bases; at the 70 of the other stage-1 tests the selector's
windows merge into ones too wide to assemble).

The JAX side runs as its users run it, with its native library loaded,
and the port must give its plans bit for bit, in its order. One option
set also runs the JAX package's Python path (the library's realigner
functions switched off): the two agree except in windows that reach a run
of N, where the tests pin the differing locus and hold the port to the
native run.
"""

import json

import numpy as np
import pytest
import torch

from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    assert_batches_equal,
    assert_planned_equal,
    preset_options,
    realigner_natives_off,
    sparse_sample,
    to_package,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"


@pytest.fixture(scope="module")
def sparse_paths(tmp_path_factory):
    return write_stage1_inputs(sparse_sample(),
                               tmp_path_factory.mktemp("sparse"))


@pytest.fixture(scope="module")
def mixed_paths(tmp_path_factory):
    """Reads of 100, 150 and 250 bases, 15% of them with a skip (N)."""
    return write_stage1_inputs(
        sparse_sample(read_length=(150, 100, 250), skip_fraction=0.15),
        tmp_path_factory.mktemp("mixed"))


def run(package, paths, tsv=None, realigner=None, **overrides):
    """(counts, plans, options) of one runner call with a plan sink."""
    core = jcore if package == JAX else tcore
    options = preset_options(package, paths, **overrides)
    for key, value in (realigner or {}).items():
        setattr(options.realigner_options, key, value)
    plans = []
    counts = core.make_examples_runner(options, runtime_by_region_path=tsv,
                                       plan_sink=plans.append)
    return counts, plans, options


def differing(a, b):
    """Loci of the plans that differ between two runs of equal length."""
    assert len(a) == len(b)
    return [(x.variant.reference_name, x.variant.start,
             x.variant.reference_bases, tuple(x.variant.alternate_bases))
            for x, y in zip(a, b)
            if x.variant.encode() != y.variant.encode() or any(
                not np.array_equal(x.plan[k], y.plan[k]) for k in x.plan)]


RUNS = {
    "defaults": ("sparse", dict(), dict()),
    # The 250-base reads keep their alignment and go to the batch's end.
    "read-length-cap": ("mixed", dict(max_read_length_to_realign=200),
                        dict()),
    "split-skip-reads": ("mixed", dict(), dict(split_skip_reads=True)),
    "two-shards-sampled": ("sparse", dict(task_id=1, num_shards=2,
                                          max_reads_per_partition=120,
                                          partition_size=800), dict()),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_with_realigner_matches_jax(name, sparse_paths, mixed_paths,
                                           tmp_path):
    which, overrides, realigner = RUNS[name]
    paths = sparse_paths if which == "sparse" else mixed_paths
    tsvs = [str(tmp_path / f"{p}.tsv") for p in (JAX, PORT)]
    want_counts, want, want_options = run(JAX, paths, tsvs[0], realigner,
                                          **overrides)
    counts, got, options = run(PORT, paths, tsvs[1], realigner, **overrides)
    assert counts == want_counts and len(got) >= 7
    assert_planned_equal(got, want)
    # The realigner writes read_size into the options it was handed.
    assert options.realigner_enabled and want_options.realigner_enabled
    assert repr(options) == repr(want_options).replace(JAX + ".", PORT + ".")
    assert tcore.serialize_options(options) == json.loads(json.dumps(
        jcore.serialize_options(want_options)).replace(JAX + ".", PORT + "."))
    assert options.realigner_options.aln_config.read_size != 250 or \
        which == "mixed"
    # The runtime table: the same regions and columns, realignment timed.
    rows = [[line.split("\t") for line in open(t).read().splitlines()]
            for t in tsvs]
    assert rows[1][0] == rows[0][0] == [
        "region", "get reads", "realignment", "find candidates",
        "make pileup images", "total"]
    assert [r[0] for r in rows[1]] == [r[0] for r in rows[0]]
    assert sum(float(r[2]) for r in rows[1][1:]) > 0.05
    # And the realigner matters: without it the plans differ.
    _, off, _ = run(PORT, paths, realigner_enabled=False, **overrides)
    assert len(off) != len(got) or differing(off, got)


def test_jax_python_path_differs_next_to_the_n_run(sparse_paths, monkeypatch):
    """chr2 holds its run of N at 1500-1600. Away from it the JAX
    package's Python path gives the native path's plans; in the window
    beside it one plan differs, and the port has the native one."""
    regions = dict(regions=["chr2"])
    _, want, _ = run(JAX, sparse_paths, **regions)
    _, got, _ = run(PORT, sparse_paths, **regions)
    assert_planned_equal(got, want)
    realigner_natives_off(monkeypatch)
    _, python, _ = run(JAX, sparse_paths, **regions)
    assert differing(want, python) == [("chr2", 1439, "T", ("TAG",))]


def test_n_run_window(tmp_path, monkeypatch):
    """Eightfold depth over the reference's run of N, at the default
    variant spacing: the window over the run assembles haplotypes that
    hold N, and reads with N fall back to SSW against them. The JAX
    package's native and Python paths then differ in one plan (its score
    kernel never matches N to N, its aligner does; ROADMAP Queue 3), and
    the port gives the native run's plans."""
    sample = synthetic.synthetic_sample(7, (("chr1", 6000),), depth=8)
    paths = write_stage1_inputs(sample, tmp_path)
    regions = dict(regions=["chr1:4001-5000"])
    _, want, _ = run(JAX, paths, **regions)
    _, got, _ = run(PORT, paths, **regions)
    assert len(got) == 9
    assert_planned_equal(got, want)
    realigner_natives_off(monkeypatch)
    _, python, _ = run(JAX, paths, **regions)
    assert differing(want, python) == [("chr1", 4460, "T", ("A",))]


def test_realign_region_reads_order_and_shortcuts(mixed_paths):
    """The returned batch: realigned reads first (unassigned ones, then
    each assembled region's), reads over the cap last; the same batch
    object when there is nothing to do."""
    out = []
    for package, core in ((JAX, jcore), (PORT, tcore)):
        types = __import__(f"{package}.core.types", fromlist=["x"])
        options = preset_options(package, mixed_paths,
                                 max_read_length_to_realign=200)
        processor = core.RegionProcessor(options)
        region = types.Range("chr1", 1000, 2000)
        batch = processor.region_reads(region)
        out.append((batch, processor.realign_region_reads(batch, region)))
        empty = processor.region_reads(types.Range("chr2", 1999, 2000)) \
            .subset(np.arange(0))
        assert processor.realign_region_reads(empty, region) is empty
        options.realigner_enabled = False
        assert core.RegionProcessor(options).realign_region_reads(
            batch, region) is batch
    (want_in, want), (got_in, got) = out
    assert_batches_equal(got_in, want_in)
    assert_batches_equal(got, want)
    lengths = got.read_lengths()
    n_long = int((lengths > 200).sum())
    assert 0 < n_long < len(got) and (lengths[-n_long:] > 200).all()
    assert got.name != got_in.name            # the order changed
    assert sorted(got.name) == sorted(got_in.name)


def test_rnaseq_preset_splits_skip_reads(mixed_paths):
    """The RNASEQ preset turns split_skip_reads on; split reads get a
    _p<n> name and change the batch the candidates are called from."""
    kw = dict(model_type="RNASEQ", regions=["chr1:1001-2000"])
    _, want, want_options = run(JAX, mixed_paths, **kw)
    _, got, options = run(PORT, mixed_paths, **kw)
    assert options.realigner_options.split_skip_reads and len(got) > 1
    assert_planned_equal(got, want)
    processor = tcore.RegionProcessor(
        preset_options(PORT, mixed_paths, model_type="RNASEQ"))
    region = tt.Range("chr1", 1000, 2000)
    batch = processor.realign_region_reads(processor.region_reads(region),
                                           region)
    assert any(name.endswith("_p1") for name in batch.name)
    assert not (batch.cigar_ops == 4).any()


def test_options_with_realigner_round_trip(sparse_paths):
    options = preset_options(PORT, sparse_paths)
    assert options.realigner_enabled
    assert to_package(to_package(options, JAX), PORT) == options
    tcore.RegionProcessor(options)            # no longer refused
    assert wgs_options(PORT, sparse_paths).realigner_enabled is False

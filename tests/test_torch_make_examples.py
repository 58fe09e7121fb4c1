"""Stage 1 of the port against the JAX package: options, runner, plans.

The same synthetic FASTA and BAM (`tests/torch_port_util.py`, numpy
seed) go through `make_examples_runner` of both packages. Everything
here is exact: counts, candidates TFRecord bytes, plans key by key.
"""

import dataclasses

import torch

torch.set_num_threads(2)


def test_planned_example_lives_in_examples_builder():
    """As in the JAX package: `PlannedExample` is defined by
    `make_examples.examples_builder` and the predictor imports it."""
    from deepvariant_tpu.make_examples import examples_builder as jeb
    from deepvariant_tpu_torch.calling import plan_predictor
    from deepvariant_tpu_torch.make_examples import examples_builder as teb

    assert plan_predictor.PlannedExample is teb.PlannedExample
    assert teb.PlannedExample.__module__ == teb.__name__
    assert [f.name for f in dataclasses.fields(teb.PlannedExample)] == [
        f.name for f in dataclasses.fields(jeb.PlannedExample)]


import filecmp
import json
import pickle

import numpy as np
import pytest

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io import fasta as jfasta
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.make_examples import presets as jpresets
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io import fasta as tfasta
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.make_examples import presets as tpresets
from torch_port_util import (
    assert_calls_equal,
    assert_planned_equal,
    stage1_sample,
    to_package,
    wgs_options,
    write_stage1_inputs,
)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_stage1_inputs(stage1_sample(),
                               tmp_path_factory.mktemp("jax_in"))


def run(package, paths, out_dir, tag, **overrides):
    """(counts, plans, options, candidates path) of one runner call with
    a plan sink."""
    core = jcore if package == JAX else tcore
    candidates = str(out_dir / f"{tag}.{package}.candidates.tfrecord")
    options = wgs_options(package, paths, candidates_filename=candidates,
                          **overrides)
    plans = []
    counts = core.make_examples_runner(options, plan_sink=plans.append)
    return counts, plans, options, candidates


RUNS = {
    "one-shard": dict(),
    "shard-0-of-2": dict(task_id=0, num_shards=2),
    "shard-1-of-2": dict(task_id=1, num_shards=2),
    "sampled-reads": dict(max_reads_per_partition=60),
    "other-options": dict(
        select_variant_types="snps multi-allelics", keep_duplicates=True,
        min_mapping_quality=20, min_base_quality=15, partition_size=700,
        parse_sam_aux_fields=True, create_complex_alleles=True,
        track_ref_reads=True, regions=["chr1:500-4,000", "chr2"],
        exclude_regions=["chr1:1000-1500"], sample_name="given"),
    # The CLI's default: the caller fills each candidate's context VAFs,
    # which the plans and candidates do not carry.
    "vaf-context-window": dict(small_model_vaf_context_window_size=51),
    "downsampled-keep-all": dict(
        downsample_fraction=0.6, keep_secondary_alignments=True,
        keep_supplementary_alignments=True, discard_non_dna_regions=True,
        sample_mean_coverage_on_calling_regions=True, hts_io_threads=2),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_plans_are_bit_identical_to_jax(paths, tmp_path, name):
    """Counts, the candidates TFRecord's bytes, and the plans key by
    key, in the same order."""
    want_counts, want, want_options, want_file = run(
        JAX, paths, tmp_path, name, **RUNS[name])
    counts, got, options, got_file = run(
        PORT, paths, tmp_path, name, **RUNS[name])
    assert counts == want_counts
    assert counts["examples"] == len(got) > 20
    assert counts["candidates"] > 15
    assert filecmp.cmp(got_file, want_file, shallow=False)
    assert_planned_equal(got, want)
    # The runner takes the sample name from @RG SM unless one is given,
    # and writes it into the options it was handed.
    expected_name = RUNS[name].get("sample_name", "synthetic")
    assert options.sample_name == want_options.sample_name == expected_name
    # (A name that is given reaches the caller's options only through
    # the command line, in both packages.)
    caller_name = "synthetic" if expected_name == "synthetic" else "default"
    assert options.variant_caller_options.sample_name == \
        want_options.variant_caller_options.sample_name == caller_name
    assert got[0].variant.calls[0].call_set_name == caller_name
    assert options.pileup_options.mean_coverage == \
        want_options.pileup_options.mean_coverage
    # What both runners did to their options, compared as JSON.
    assert tcore.serialize_options(options) == json.loads(json.dumps(
        jcore.serialize_options(want_options)).replace(JAX + ".", PORT + "."))


def test_two_shards_make_the_one_shard_run(paths, tmp_path):
    _, whole, _, _ = run(PORT, paths, tmp_path, "whole")
    parts = []
    for task in (0, 1):
        parts += run(PORT, paths, tmp_path, f"part{task}", task_id=task,
                     num_shards=2)[1]
    key = lambda p: (p.variant.reference_name, p.variant.start,  # noqa: E731
                     p.alt_indices)
    assert_planned_equal(sorted(parts, key=key), sorted(whole, key=key))
    assert any(len(p.alt_indices) == 2 for p in whole)


def test_sampling_changes_the_plans(paths, tmp_path):
    """max_reads_per_partition=60 is below the 30x depth of a 1000-base
    partition, so the reservoir sampler really drops reads."""
    _, sampled, _, _ = run(PORT, paths, tmp_path, "s",
                           max_reads_per_partition=60)
    _, full, _, _ = run(PORT, paths, tmp_path, "f")
    assert len(sampled) < len(full)


def test_sidecars_and_runtime_tsv(paths, tmp_path):
    """With a plan sink an examples path only anchors the sidecars."""
    out = {}
    for package, core in ((JAX, jcore), (PORT, tcore)):
        examples = str(tmp_path / f"{package}.examples.tfrecord")
        options = wgs_options(package, paths, examples_filename=examples,
                              output_sitelist=True, regions=["chr2"])
        tsv = str(tmp_path / f"{package}.runtime.tsv")
        core.make_examples_runner(options, runtime_by_region_path=tsv,
                                  plan_sink=lambda plan: None)
        with open(tsv) as f:
            rows = [line.split("\t") for line in f.read().splitlines()]
        with open(examples + ".run_info.json") as f:
            info = json.load(f)
        out[package] = (
            open(examples + ".example_info.json").read(),
            open(examples + ".sitelist.tsv").read(),
            [r[0] for r in rows], rows[0], info["counts"],
            info["num_regions"], sorted(info))
    assert out[PORT] == out[JAX]
    assert out[PORT][2][1:] == ["chr2:1-1000", "chr2:1001-2000",
                                "chr2:2001-3000"]


def test_run_info_without_the_io_counters(paths, tmp_path, monkeypatch):
    """A kernel whose /proc/<pid>/io lacks the fields psutil parses makes
    `io_counters` raise ValueError (the card's machine writes `char` for
    `rchar`); the run_info sidecar is written without the byte counts."""
    import psutil

    from deepvariant_tpu_torch.utils.resources import ResourceMonitor

    def unreadable(self):
        raise ValueError("b'rchar' field was not found in /proc/1/io")

    monkeypatch.setattr(psutil.Process, "io_counters", unreadable)
    metrics = ResourceMonitor().start().metrics()
    assert "read_bytes" not in metrics and metrics["wall_time_seconds"] >= 0
    examples = str(tmp_path / "e.tfrecord")
    tcore.make_examples_runner(wgs_options(PORT, paths, regions=["chr2:1-900"],
                                           examples_filename=examples))
    with open(examples + ".run_info.json") as f:
        assert "write_bytes" not in json.load(f)["resource_metrics"]


# -- options ------------------------------------------------------------------

def test_options_have_every_field_and_print_alike(paths):
    import dataclasses

    def fields(cls):
        return [(f.name, f.type) for f in dataclasses.fields(cls)]

    assert fields(tcore.MakeExamplesOptions) == \
        fields(jcore.MakeExamplesOptions)
    want, got = jcore.MakeExamplesOptions(), tcore.MakeExamplesOptions()
    assert repr(got) == repr(want)
    assert tcore.serialize_options(got) == jcore.serialize_options(want)
    got = wgs_options(PORT, paths, regions=["chr1"], num_shards=4)
    back = pickle.loads(pickle.dumps(got))
    assert back == got and repr(back) == repr(got)
    assert repr(to_package(got, JAX)) == repr(got)
    assert to_package(to_package(got, JAX), PORT) == got
    assert type(to_package(got, JAX)) is jcore.MakeExamplesOptions
    for name in ("DEFAULT_PARTITION_SIZE", "DEFAULT_MAX_READS_PER_PARTITION",
                 "DEFAULT_RANDOM_SEED", "DEFAULT_SAMPLE_NAME",
                 "MIN_NON_DNA_REGION", "EXCLUDED_HUMAN_CONTIGS"):
        assert getattr(tcore, name) == getattr(jcore, name)


@pytest.mark.parametrize("model_type", tpresets.MODEL_TYPES)
def test_model_presets_match_jax(model_type):
    want = jpresets.apply_model_preset(jcore.MakeExamplesOptions(),
                                       model_type.lower())
    got = tpresets.apply_model_preset(tcore.MakeExamplesOptions(),
                                      model_type.lower())
    assert repr(got) == repr(want)
    assert to_package(got, JAX) == want
    with pytest.raises(ValueError, match="unknown model type"):
        tpresets.apply_model_preset(tcore.MakeExamplesOptions(), "nanopore9")


UNPORTED = {
    "small-model": dict(call_small_model_examples=True),
    "small-model-train": dict(write_small_model_examples=True,
                              small_model_examples_filename="e.tfrecord"),
    "small-model-path": dict(call_small_model_examples=True,
                             trained_small_model_path="m"),
    "small-model-cvos": dict(call_small_model_examples=True,
                             small_model_cvo_filename="c.tfrecord"),
    "small-model-examples": dict(small_model_examples_filename="e.tfrecord"),
    "denovo": dict(denovo_regions=["chr1:1-10"]),
}


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_options_raise(paths, tmp_path, name):
    """The small model is ported: each of its options runs, and the port's
    counts, plans and small-model files equal the JAX runner's (a file
    name is placed in the test's directory, one per package; "m" is a
    bundle of seeded weights). `--denovo_regions`, which neither package
    reads, still raises, naming its ROADMAP item."""
    from deepvariant_tpu_torch.io import flax_msgpack
    from deepvariant_tpu_torch.small_model.model import create_small_model

    if name == "denovo":
        options = wgs_options(PORT, paths, **UNPORTED[name])
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md Queue 1"):
            tcore.RegionProcessor(options)
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md Queue 1"):
            tcore.make_examples_runner(options, plan_sink=lambda plan: None)
        return
    bundle = tmp_path / "m"
    bundle.mkdir()
    _, variables = create_small_model(19, seed=3)
    rng = np.random.RandomState(3)
    (bundle / "small_model.msgpack").write_bytes(flax_msgpack.pack({
        "params": variables,
        "mean": rng.uniform(0, 3, 19).astype(np.float32),
        "scale": rng.uniform(0.5, 1, 19).astype(np.float32)}))
    results = []
    for package in (JAX, PORT):
        overrides = {}
        for key, value in UNPORTED[name].items():
            if value == "m":
                value = str(bundle)
            elif isinstance(value, str):
                value = str(tmp_path / f"{package}.{value}")
            overrides[key] = value
        counts, plans, _, candidates = run(
            package, paths, tmp_path, name, regions=["chr1:1-3,000"],
            **overrides)
        files = [open(p, "rb").read() for p in overrides.values()
                 if isinstance(p, str) and p.endswith(".tfrecord")]
        results.append((counts, plans, files,
                        open(candidates, "rb").read()))
    (want_counts, want_plans, want_files, want_cands), \
        (counts, plans, files, cands) = results
    assert counts == want_counts and files == want_files
    assert cands == want_cands
    assert_planned_equal(plans, want_plans)
    assert counts["candidates"] > 10
    if UNPORTED[name].get("call_small_model_examples"):
        # The gate kept some candidates from the CNN.
        ungated = run(PORT, paths, tmp_path, "ungated",
                      regions=["chr1:1-3,000"])[0]
        assert counts["examples"] < ungated["examples"]


@pytest.mark.parametrize("mode", ["base_channels", "rows", "single_row"])
def test_alt_aligned_pileups_raise(paths, tmp_path, mode):
    """The alt modes that compose whole host-painted alt images are
    ported: the runner writes the JAX runner's examples TFRecord and
    example_info.json, byte for byte."""
    written = []
    for package, core in ((JAX, jcore), (PORT, tcore)):
        options = wgs_options(
            package, paths, regions=["chr1:1,000-3,000"],
            examples_filename=str(tmp_path / f"{package}.tfrecord"))
        options.pileup_options.alt_aligned_pileup = mode
        counts = core.make_examples_runner(options)
        assert counts["examples"] > 10
        written.append(options.examples_filename)
    for suffix in ("", ".example_info.json"):
        assert filecmp.cmp(written[0] + suffix, written[1] + suffix,
                           shallow=False)


@pytest.mark.parametrize("preset", ["PACBIO", "MASSEQ", "ONT_R104"])
def test_long_read_presets_raise_until_phasing_is_ported(paths, preset):
    """Direct phasing is ported: a long-read preset with its defaults
    (phase_reads on) no longer raises, and one region of this short-read
    sample goes through the phasing branch to the JAX processor's
    candidates and plans."""
    outs = []
    for package, core, presets in ((JAX, jcore, jpresets),
                                   (PORT, tcore, tpresets)):
        options = presets.apply_model_preset(wgs_options(package, paths),
                                             preset)
        assert options.phase_reads
        processor = core.RegionProcessor(options)
        processor.plan_mode = True
        types = jt if package == JAX else tt
        outs.append(processor.process(types.Range("chr1", 1000, 2000)))
    want, got = outs
    assert [c.variant.encode() for c in got.candidates] == \
        [c.variant.encode() for c in want.candidates]
    assert_planned_equal(got.plans, want.plans)
    assert len(got.plans) > 5 and "phase reads" in got.runtimes


def test_sinks_without_ported_code_raise(paths, tmp_path):
    sink = lambda item: None  # noqa: E731
    # The small model's sink is ported: it receives the CVOs the JAX
    # runner's sink receives.
    sunk = {}
    for package, core in ((JAX, jcore), (PORT, tcore)):
        cvos = sunk[package] = []
        core.make_examples_runner(
            wgs_options(package, paths, regions=["chr1:1-2,000"],
                        call_small_model_examples=True),
            plan_sink=sink, small_model_cvo_sink=cvos.append)
    assert [c.encode() for c in sunk[PORT]] == \
        [c.encode() for c in sunk[JAX]] and sunk[PORT]
    with pytest.raises(ValueError, match="not both"):
        tcore.make_examples_runner(wgs_options(PORT, paths),
                                   example_sink=sink, plan_sink=sink)
    # The host painter is ported: an examples file without a plan sink
    # and an example sink receive the JAX runner's examples.
    region = dict(regions=["chr1:1,001-2,000"])
    path = str(tmp_path / "e.tfrecord")
    counts = tcore.make_examples_runner(
        wgs_options(PORT, paths, examples_filename=path, **region))
    jpath = str(tmp_path / "jax.tfrecord")
    jcore.make_examples_runner(
        wgs_options(JAX, paths, examples_filename=jpath, **region))
    assert filecmp.cmp(path, jpath, shallow=False)
    sunk = []
    assert tcore.make_examples_runner(
        wgs_options(PORT, paths, **region), example_sink=sunk.append) == \
        counts
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader

    with TFRecordReader(path) as reader:
        assert sunk == list(reader) and len(sunk) > 10
    # Outside plan mode a region's examples are host-painted, as the
    # JAX processor paints them.
    processor = tcore.RegionProcessor(wgs_options(PORT, paths))
    outputs = processor.process(tt.Range("chr1", 1000, 2000))
    want = jcore.RegionProcessor(wgs_options(JAX, paths)).process(
        jt.Range("chr1", 1000, 2000))
    assert outputs.examples == want.examples and not outputs.plans
    assert len(outputs.examples) == len(sunk)
    # The gVCF is ported: a gVCF sink receives the reference blocks, and
    # candidates_in_region returns them, as in the JAX package.
    region = tt.Range("chr1", 1000, 2000)
    blocks = []
    counts = tcore.make_examples_runner(
        wgs_options(PORT, paths, regions=["chr1:1,001-2,000"]),
        plan_sink=sink, gvcf_sink=blocks.append)
    assert counts["gvcfs"] == len(blocks) > 10
    candidates, gvcfs, _ = processor.candidates_in_region(
        region, processor.region_reads(region), True)
    # (The runner names the sample from the BAM, this processor does not.)
    assert [(v.start, v.end, v.calls[0].info) for v in gvcfs] == \
        [(v.start, v.end, v.calls[0].info) for v in blocks]
    assert candidates


def test_channels_the_painter_lacks_raise_as_in_jax(paths):
    for package, core in ((JAX, jcore), (PORT, tcore)):
        options = wgs_options(package, paths)
        options.pileup_options.channels = (1, 2, 3, 4, 5, 6, 25)
        with pytest.raises(ValueError, match="not device-encodable"):
            core.make_examples_runner(options, plan_sink=lambda plan: None)


# -- the runner's helpers -----------------------------------------------------

def _contigs(types, spec):
    return [types.ContigInfo(n, length, i)
            for i, (n, length) in enumerate(spec)]


def _plain(ranges):
    return [(r.reference_name, r.start, r.end) for r in ranges]


def test_contig_helpers_match_jax():
    ref = [("chr1", 1000), ("chr2", 500), ("hs37d5", 900), ("chrM", 16)]
    sam = [("chr1", 1000), ("chr2", 499), ("chrM", 16), ("extra", 5)]
    want = jcore.common_contigs([_contigs(jt, ref), _contigs(jt, sam)])
    got = tcore.common_contigs([_contigs(tt, ref), _contigs(tt, sam)])
    assert [c.name for c in got] == [c.name for c in want] == ["chr1", "chrM"]
    assert tcore.common_contigs([]) == []
    good = [("chr1", 1000), ("chr2", 500), ("chrM", 16)]
    want = jcore.ensure_consistent_contigs(_contigs(jt, ref),
                                           _contigs(jt, good), ["chr1", "chr2"])
    got = tcore.ensure_consistent_contigs(_contigs(tt, ref),
                                          _contigs(tt, good), ["chr1", "chr2"])
    assert [c.name for c in got] == [c.name for c in want]
    messages = []
    for core, types in ((jcore, jt), (tcore, tt)):
        with pytest.raises(ValueError, match="IS MISSING") as err:
            core.ensure_consistent_contigs(
                _contigs(types, ref), _contigs(types, [("1", 1000)]))
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("shards", [None, 3])
def test_regions_to_process_match_jax(shards):
    spec = [("chr1", 10_500), ("chr2", 999), ("chr3", 2000)]
    calling = ["chr1:2,001-7,000", "chr3"]
    for task in range(shards or 1):
        args = (task, shards) if shards else (None, None)
        want = jcore.regions_to_process(
            _contigs(jt, spec), 1000,
            jcore.RangeSet.from_regions(calling, _contigs(jt, spec)), *args)
        got = tcore.regions_to_process(
            _contigs(tt, spec), 1000,
            tcore.RangeSet.from_regions(calling, _contigs(tt, spec)), *args)
        assert _plain(got) == _plain(want) and got
    assert _plain(tcore.regions_to_process(_contigs(tt, spec), 3000)) == \
        _plain(jcore.regions_to_process(_contigs(jt, spec), 3000))
    for bad in ((0, None), (None, 2), (2, 2), (0, -1)):
        with pytest.raises(ValueError):
            tcore.regions_to_process(_contigs(tt, spec), 1000, None, *bad)


def test_calling_regions_from_options_match_jax(paths):
    spec = [("chr1", 6000), ("chr2", 3000)]
    for kwargs in (dict(), dict(regions=["chr2", "chr1:100-900"]),
                   dict(exclude_regions=["chr1:1-5,000"]),
                   dict(regions=["chr1"], exclude_regions=["chr1:50-60"])):
        want = jcore.calling_regions_from_options(
            wgs_options(JAX, paths, **kwargs), _contigs(jt, spec))
        got = tcore.calling_regions_from_options(
            wgs_options(PORT, paths, **kwargs), _contigs(tt, spec))
        assert (got is None) == (want is None)
        if want is not None:
            assert _plain(got) == _plain(want)


def test_find_ref_n_regions_match_jax(paths):
    want = jcore.find_ref_n_regions(jfasta.FastaReader(paths["ref"]), 100)
    got = tcore.find_ref_n_regions(tfasta.FastaReader(paths["ref"]), 100)
    assert _plain(got) == _plain(want) == [("chr1", 4500, 4800),
                                           ("chr2", 2250, 2400)]
    assert tcore.find_ref_n_regions(tfasta.FastaReader(paths["ref"]),
                                    301) == []


@pytest.mark.parametrize("n,k,seed", [(10, 20, 1), (100, 10, 2101079370),
                                      (2000, 60, 5), (61, 60, 9)])
def test_reservoir_sampling_keeps_the_draw_order(n, k, seed):
    want = jcore.reservoir_sample_indices(n, k, np.random.RandomState(seed))
    got = tcore.reservoir_sample_indices(n, k, np.random.RandomState(seed))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and len(got) == min(n, k)


def test_sample_name_from_header():
    from deepvariant_tpu_torch.io.bam import BamHeader

    def header(text):
        return BamHeader(text, [])

    assert tcore.extract_sample_name_from_bam_header(header(
        "@HD\tVN:1.6\n@RG\tID:a\tSM:\n@RG\tID:b\tSM:NA12878\tPL:x\n"
        "@RG\tID:c\tSM:other\n")) == "NA12878"
    assert tcore.extract_sample_name_from_bam_header(
        header("@HD\tVN:1.6\n")) == "default"


@pytest.mark.parametrize("changes", [
    dict(), dict(ref_filename=""), dict(examples_filename=""),
    dict(reads_filename=""), dict(variant_caller="other"),
    dict(downsample_fraction=1.5), dict(mode="nonsense"),
    dict(mode="training"), dict(truth_variants_filename="t.vcf"),
    dict(select_variant_types="snps svs"),
    dict(downsample_classes=[0.5, 2.0]),
], ids=lambda c: ",".join(c) or "valid")
def test_check_options_are_valid_matches_jax(paths, changes):
    outcomes = []
    for package, core in ((JAX, jcore), (PORT, tcore)):
        options = wgs_options(package, paths, examples_filename="e.tfrecord")
        for key, value in changes.items():
            setattr(options, key, value)
        try:
            core.check_options_are_valid(options)
            outcomes.append(None)
        except core.OptionsError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[0] is None) == (not changes)
    pileup_checks = []
    for package, core in ((JAX, jcore), (PORT, tcore)):
        options = wgs_options(package, paths, examples_filename="e.tfrecord")
        options.pileup_options.width = 220
        with pytest.raises(core.OptionsError) as err:
            core.check_options_are_valid(options)
        pileup_checks.append(str(err.value))
    assert pileup_checks[0] == pileup_checks[1]


def test_region_processor_steps_match_jax(paths):
    """The processor's own steps on one region: reads, candidates,
    plans, and a PlannedExample carried across the packages."""
    jp = jcore.RegionProcessor(wgs_options(JAX, paths))
    tp = tcore.RegionProcessor(wgs_options(PORT, paths))
    jp.plan_mode = tp.plan_mode = True
    region = ("chr1", 2000, 3000)
    from torch_port_util import assert_batches_equal

    want_reads = jp.region_reads(jt.Range(*region))
    got_reads = tp.region_reads(tt.Range(*region))
    assert_batches_equal(got_reads, want_reads)
    want, gvcfs, _ = jp.candidates_in_region(jt.Range(*region), want_reads,
                                             False)
    got, got_gvcfs, _ = tp.candidates_in_region(tt.Range(*region), got_reads,
                                                False)
    assert gvcfs == got_gvcfs == []
    assert_calls_equal(got, want)
    want_out = jp.process(jt.Range(*region))
    got_out = tp.process(tt.Range(*region))
    assert_planned_equal(got_out.plans, want_out.plans)
    assert_calls_equal(got_out.candidates, want_out.candidates)
    assert list(got_out.runtimes) == list(want_out.runtimes)
    assert got_out.examples == [] and got_out.gvcfs == []
    there = to_package(want_out.plans, PORT)
    assert type(there[0]).__module__.startswith(PORT + ".")
    assert_planned_equal(there, got_out.plans)
    assert_planned_equal(to_package(there, JAX), want_out.plans)
    # The pieces of ExamplesBuilder.
    tb, jb = tp.examples_builder, jp.examples_builder
    assert tb.example_shape() == jb.example_shape() == (100, 221, 7)
    assert tb.channel_enums() == jb.channel_enums()
    assert tb.supports_device_encode() and jb.supports_device_encode()
    for call_t, call_j in zip(got, want):
        assert tb.need_alt_alignment(call_t.variant) == \
            jb.need_alt_alignment(call_j.variant) is False
    edge_t = tt.Variant(reference_name="chr1", start=20, end=21)
    edge_j = jt.Variant(reference_name="chr1", start=20, end=21)
    np.testing.assert_array_equal(tb.reference_window(edge_t),
                                  jb.reference_window(edge_j))
    far = tt.Variant(reference_name="chr1", start=7000, end=7001)
    assert tb.reference_window(far) is None

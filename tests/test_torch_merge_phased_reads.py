"""merge_phased_reads and the candidate sweep in the PyTorch port
against the JAX package.

Both are host code in both packages (Python and numpy), so everything
here is exact: the Merger's switches and merged phases on hand cases and
on seeded random shards, the command line's merged and switches TSVs
from the runner's per-shard `--output_local_read_phasing` files, the
candidate sweep's positions file, its merge across shards, and
`partition_by_candidates`.
"""

import os

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.phasing import merge_phased_reads as jmpr
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.core.sharded_files import sharded_filename
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.phasing import merge_phased_reads as tmpr
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import preset_options, write_stage1_inputs

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CORES = {JAX: jcore, PORT: tcore}


@pytest.fixture(scope="module")
def long_paths(tmp_path_factory):
    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    return write_stage1_inputs(sample, tmp_path_factory.mktemp("long"))


def shard_phases(package, paths, directory, spec, num_shards=2):
    """Run the PACBIO runner once per shard with the read-phase TSV at
    `spec`; returns the runner's options of the last shard."""
    for task in range(num_shards):
        options = preset_options(
            package, paths, "PACBIO", partition_size=1500,
            task_id=task, num_shards=num_shards,
            output_local_read_phasing_filename=os.path.join(directory,
                                                            spec))
        CORES[package].make_examples_runner(options,
                                            plan_sink=lambda plan: None)


def test_read_phase_tsv_is_written_per_shard(long_paths, tmp_path):
    """A 'name@N.tsv' spec gives each shard its own file, the spec that
    merge_phased_reads reads back; each file equals the JAX runner's
    TSV written to that shard's path. (The JAX runner writes the spec
    literally, so two shards overwrite one file: ROADMAP Queue 3.)"""
    shard_phases(PORT, long_paths, str(tmp_path), "phase@2.tsv")
    assert not os.path.exists(tmp_path / "phase@2.tsv")
    for task in range(2):
        name = sharded_filename("phase", task, 2, ".tsv")
        jcore.make_examples_runner(preset_options(
            JAX, long_paths, "PACBIO", partition_size=1500, task_id=task,
            num_shards=2, output_local_read_phasing_filename=str(
                tmp_path / f"jax-{name}")), plan_sink=lambda plan: None)
        with open(tmp_path / name) as got, \
                open(tmp_path / f"jax-{name}") as want:
            text = got.read()
            assert text == want.read()
        assert text.count("\n") > 20 and "\t1\t" in text


# -- the Merger ----------------------------------------------------------------

def merger_run(module, groups, correct=True):
    """Merge `groups` [(shard, region, [(name, phase), ...])] with one
    package's Merger; returns (switches, merged reads, corrected)."""
    merger = module.Merger()
    merger.add_reads([module.UnmergedRead(name, phase, region, shard)
                      for shard, region, phased in groups
                      for name, phase in phased])
    merger.merge_reads()
    corrected = merger.correct_phasing() if correct else None
    return ([(s, r, c.value) for s, r, c in merger.switches],
            [(m.fragment_name, m.phase, dict(m.phase_dist))
             for m in merger.merged_reads], corrected)


# The scenarios of tests/test_merge_phased_reads.py (the reference's
# merge_phased_reads_test.cc corpus).
HAND_CASES = {
    "consistent": [(0, 1, [("r1", 1), ("r2", 2), ("r3", 1)]),
                   (0, 2, [("r2", 2), ("r3", 1), ("r4", 2)])],
    "switched": [(0, 1, [("r1", 1), ("r2", 2), ("r3", 1)]),
                 (0, 2, [("r1", 2), ("r2", 1), ("r3", 2), ("r4", 1)])],
    "not-enough-overlap": [(0, 1, [("r1", 1)]),
                           (0, 2, [("r1", 2), ("r9", 1)])],
    "majority": [(0, 1, [("r1", 1)]), (0, 2, [("r1", 1)]),
                 (0, 3, [("r1", 2), ("r2", 1), ("rX", 1), ("rY", 2),
                         ("rZ", 1)])],
    "round-robin": [(0, 1, [("a", 1), ("b", 2), ("c", 1)]),
                    (1, 1, [("b", 2), ("c", 1), ("d", 2), ("e", 1)]),
                    (0, 2, [("d", 1), ("e", 2), ("f", 1), ("g", 2)])],
    "one-read": [(0, 1, [("read_1", 1)]), (1, 1, [("read_1", 1)])],
    "reverse-twice": [
        (0, 1, [("read_1", 1), ("read_2", 1), ("read_3", 2),
                ("read_4", 1)]),
        (1, 1, [("read_1", 2), ("read_2", 2), ("read_3", 2),
                ("read_4", 2)]),
        (2, 1, [("read_2", 1), ("read_3", 1), ("read_4", 1),
                ("read_5", 2)])],
    "full-cycle": [(0, 1, [("read_1", 1), ("read_2", 1), ("read_3", 2)]),
                   (1, 1, [("read_1", 2), ("read_2", 2), ("read_3", 1)]),
                   (0, 2, [("read_2", 1), ("read_3", 1), ("read_4", 2)])],
    "disconnected": [(0, 1, [("read_1", 1), ("read_2", 1), ("read_3", 2)]),
                     (1, 1, [("read_4", 1), ("read_5", 2), ("read_6", 2)])],
    "skipped-group": [
        (0, 1, [("read_1", 1), ("read_2", 1), ("read_3", 2),
                ("read_4", 2)]),
        (2, 1, [("read_1", 2), ("read_2", 2), ("read_3", 2),
                ("read_4", 1)])],
    "empty": [],
}


@pytest.mark.parametrize("name", list(HAND_CASES))
def test_merger_hand_cases_match_jax(name):
    got = merger_run(tmpr, HAND_CASES[name])
    assert got == merger_run(jmpr, HAND_CASES[name])
    if name == "switched":
        assert (0, 2, tmpr.ComparisonResult.SWITCH.value) in got[0]
    if name == "majority":
        assert got[1][0] == ("r1", 1, {1: 2, 2: 1})


def random_groups(seed, shards=3, regions=6, names=60):
    """Seeded groups: each (shard, region) phases a window of shared
    read names, some groups with the haplotypes swapped, some reads 0."""
    rng = np.random.RandomState(seed)
    truth = rng.randint(1, 3, names)
    groups = []
    for region in range(1, regions + 1):
        for shard in range(shards):
            if rng.rand() < 0.15:
                continue
            lo = int(rng.randint(0, names - 15))
            ids = sorted(set(rng.randint(lo, lo + 15, 12).tolist()))
            swap = rng.rand() < 0.4
            phased = []
            for i in ids:
                phase = int(truth[i])
                if swap:
                    phase = 3 - phase
                if rng.rand() < 0.1:
                    phase = 0
                elif rng.rand() < 0.05:
                    phase = 3 - phase
                phased.append((f"read{i:03d}/0", phase))
            groups.append((shard, region, phased))
    return groups


@pytest.mark.parametrize("seed", range(6))
def test_merger_seeded_groups_match_jax(seed):
    groups = random_groups(seed)
    got = merger_run(tmpr, groups)
    assert got == merger_run(jmpr, groups)
    kinds = {c for _, _, c in got[0]}
    assert tmpr.ComparisonResult.SWITCH.value in kinds or seed > 2


def test_comparison_values_match_jax():
    assert [(c.name, c.value) for c in tmpr.ComparisonResult] == \
        [(c.name, c.value) for c in jmpr.ComparisonResult]


# -- the command line on the runner's shards ----------------------------------

def test_cli_merges_the_runner_shards_as_jax(long_paths, tmp_path, capsys):
    """The per-shard read-phase TSVs of a two-shard PACBIO run, merged by
    each package's command line: the merged and the switches TSVs are
    byte-identical, and the switches TSV holds one row per (shard,
    region) group, as postprocess_variants reads it."""
    shard_phases(PORT, long_paths, str(tmp_path), "phase@2.tsv")
    outputs = []
    for module, tag in ((jmpr, "jax"), (tmpr, "port")):
        merged = tmp_path / f"{tag}.merged.tsv"
        switches = tmp_path / f"{tag}.switches.tsv"
        assert module.main([
            "--input_path", str(tmp_path / "phase@2.tsv"),
            "--output_path", str(merged),
            "--switches_output_path", str(switches)]) == 0
        outputs.append((merged.read_bytes(), switches.read_bytes()))
    assert outputs[0] == outputs[1]
    merged, switches = outputs[1]
    assert merged.count(b"\n") > 20 and b"\t2\n" in merged
    rows = [line.split(b"\t") for line in switches.splitlines()]
    assert {row[0] for row in rows} == {b"0", b"1"} and len(rows) >= 4
    out = capsys.readouterr().out
    assert "reads merged" in out

    from deepvariant_tpu_torch.postprocess import pipeline as tpipe
    from deepvariant_tpu.postprocess import pipeline as jpipe

    path = str(tmp_path / "port.switches.tsv")
    assert tpipe.load_phase_switches(path) == \
        jpipe.load_phase_switches(path)


# -- the candidate sweep -------------------------------------------------------

SWEEPS = {
    "one-shard": dict(),
    "two-shards-task-0": dict(num_shards=2, task_id=0),
    "two-shards-task-1": dict(num_shards=2, task_id=1),
    "regions": dict(regions=["chr1:1-2,500", "chr2:500-2,900"],
                    partition_size=700),
    "small-partitions": dict(partition_size=400),
}


def sweep(package, paths, out, **overrides):
    options = preset_options(package, paths, "PACBIO",
                             mode="candidate_sweep", **overrides)
    n = CORES[package].candidate_sweep_runner(options, str(out))
    return n, np.fromfile(str(out), np.int32)


@pytest.mark.parametrize("name", list(SWEEPS))
def test_candidate_sweep_positions_match_jax(name, long_paths, tmp_path):
    """The positions file (int32 positions, END_OF_PARTITION after each
    partition, END_OF_REGION where a calling region closes) is
    byte-identical to the JAX runner's."""
    got_n, got = sweep(PORT, long_paths, tmp_path / "port.pos",
                       **SWEEPS[name])
    want_n, want = sweep(JAX, long_paths, tmp_path / "jax.pos",
                         **SWEEPS[name])
    assert (tmp_path / "port.pos").read_bytes() == \
        (tmp_path / "jax.pos").read_bytes()
    assert got_n == want_n > 3
    assert (got == tcore.END_OF_PARTITION).sum() >= 1
    if name != "two-shards-task-1":
        assert (got == tcore.END_OF_REGION).sum() >= 1


def test_merged_positions_and_partitions_match_jax(long_paths, tmp_path):
    """The two shards' files merged (round robin, the separators dropped)
    and partitioned by candidate count, as the JAX package does."""
    paths = []
    for task in range(2):
        out = tmp_path / f"pos-{task}"
        sweep(PORT, long_paths, out, num_shards=2, task_id=task,
              partition_size=900)
        paths.append(str(out))
    got = tcore.load_candidate_positions(paths)
    want = jcore.load_candidate_positions(paths)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and (got == tcore.END_OF_REGION).sum() == 2
    assert not (got == tcore.END_OF_PARTITION).any()
    arrays = [np.fromfile(p, np.int32) for p in paths]
    np.testing.assert_array_equal(tcore.merge_candidate_positions(arrays),
                                  jcore.merge_candidate_positions(arrays))
    regions = [tt.Range("chr1", 0, 6000), tt.Range("chr2", 0, 3000)]
    jregions = [jt.Range("chr1", 0, 6000), jt.Range("chr2", 0, 3000)]
    for size in (1, 3, 10, 200):
        parts = tcore.partition_by_candidates(regions, got, size)
        assert [(r.reference_name, r.start, r.end) for r in parts] == [
            (r.reference_name, r.start, r.end)
            for r in jcore.partition_by_candidates(jregions, want, size)]
        if size == 3:
            assert len(parts) > 4


PARTITION_CASES = {
    "splits-at-max-size": ([("chr1", 0, 1000)],
                           [10, 20, 30, 40, 50, -1], 2),
    "no-candidates": ([("chr1", 0, 2 * 1000000 + 5)], [-1], 200),
    "two-regions": ([("chr1", 0, 500), ("chr2", 100, 900)],
                    [5, 6, 7, 8, 9, -1, 100, 400, 899, -1], 3),
    "truncated": ([("chr1", 0, 100)], [10], 2),
    "outside": ([("chr1", 0, 100)], [150, -1], 2),
    "bad-size": ([], [], 0),
}


@pytest.mark.parametrize("name", list(PARTITION_CASES))
def test_partition_by_candidates_matches_jax(name):
    specs, positions, size = PARTITION_CASES[name]
    results = []
    for core, types in ((jcore, jt), (tcore, tt)):
        try:
            parts = core.partition_by_candidates(
                [types.Range(*s) for s in specs], positions, size)
            results.append([(r.reference_name, r.start, r.end)
                            for r in parts])
        except ValueError as e:
            results.append(("ValueError", str(e)))
    assert results[0] == results[1]
    assert (results[1][0] == "ValueError") == (
        name in ("truncated", "outside", "bad-size"))


def test_sweep_constants_match_jax():
    for name in ("END_OF_REGION", "END_OF_PARTITION", "MAX_PARTITION_LEN",
                 "DEFAULT_CANDIDATES_PER_PARTITION"):
        assert getattr(tcore, name) == getattr(jcore, name)

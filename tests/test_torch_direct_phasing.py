"""Direct read phasing in the PyTorch port against the JAX package.

`phasing/direct_phasing.py` is host code in both packages (Python over
`DeepVariantCall`s), so everything here is exact: the same read phases,
phased variants, vertex phases and DP scores from the same candidates,
on the hand cases of `tests/test_direct_phasing_port.py`, on seeded
random candidate sets, and on the candidates of the seeded long-read
sample. Then the runner with the PACBIO and ONT_R104 presets at their
defaults (`phase_reads=True`): plans bit-identical to the JAX runner's,
the phasing-error and read-phase TSVs and the candidates' phase info
equal, the padded region cropped back, and the `phase_max_candidates`
gate.
"""

import os

import numpy as np
import pytest
import torch

from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.phasing import direct_phasing as jdp
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.phasing import direct_phasing as tdp
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    assert_calls_equal,
    assert_planned_equal,
    package_module,
    preset_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
PHASING = {JAX: jdp, PORT: tdp}
CORES = {JAX: jcore, PORT: tcore}


def cand(package, start, end, support, ref_support=()):
    """A DeepVariantCall of one package: `support` maps alt bases to
    1-based read ids, stored 0-based (test_direct_phasing_port.cand)."""
    types = package_module(package, "core.types")
    caller = package_module(package, "make_examples.variant_caller")
    return caller.DeepVariantCall(
        variant=types.Variant(
            reference_name="chr1", start=start, end=end,
            reference_bases="A" * (end - start),
            alternate_bases=list(support)),
        allele_support={alt: [r - 1 for r in reads]
                        for alt, reads in support.items()},
        ref_support=[r - 1 for r in ref_support])


# (start, end, support, ref_support) lists of the reference's
# direct_phasing_test.cc corpus, as test_direct_phasing_port.py has them.
HAND_CASES = {
    "simple": [(100, 101, {"A": [1, 2, 3], "C": [4, 5]}),
               (105, 106, {"C": [1, 2, 4, 5]}),
               (110, 111, {"T": [1, 2, 3], "G": [4, 5]})],
    "error-correction": [(100, 101, {"A": [1, 2, 3], "C": [4, 5]}),
                         (105, 106, {"C": [1, 2, 3, 4, 5]}),
                         (110, 111, {"T": [1, 2], "G": [3, 4, 5]}),
                         (120, 121, {"T": [1, 2, 3], "G": [4, 5]})],
    "changed-order": [(100, 101, {"A": [1, 2, 3], "C": [4, 5]}),
                      (105, 106, {"C": [1, 2, 3, 4, 5]}),
                      (110, 111, {"T": [4, 5], "G": [1, 2, 3]}),
                      (120, 121, {"G": [4, 5], "T": [1, 2, 3]})],
    "unphased-read": [(100, 101, {"A": [1, 2, 3], "C": [4, 5]}),
                      (105, 106, {"C": [1, 2, 3, 4, 5]}),
                      (110, 111, {"T": [1, 2], "G": [4, 5, 3]})],
    "broken-path": [(100, 101, {"A": [1, 2, 3], "C": [4, 5]}),
                    (105, 106, {"C": [4, 5], "G": [6, 7]}),
                    (110, 111, {"T": [6, 7], "G": [4, 5]})],
    "no-connection": [(100, 101, {"A": [1, 2, 3], "C": [4, 5]}),
                      (105, 106, {"C": [1, 2, 3], "G": [4, 5]}),
                      (110, 111, {"C": [6, 7], "G": [8, 9]}),
                      (120, 121, {"T": [6, 7], "G": [8, 9]})],
    "fully-connected": [(100, 101, {"A": [1, 2, 3], "C": [4, 5, 6]}),
                        (105, 106, {"C": [4, 5, 1], "G": [2, 3, 6]}),
                        (110, 111, {"T": [1, 2, 3], "G": [4, 5, 6]})],
    "score-tie": [(100, 101, {"A": [1, 2], "C": [3, 4]}),
                  (110, 111, {"G": [1, 2], "T": [3, 4]}),
                  (120, 121, {"A": [5, 6, 7, 8], "C": [9, 10, 11, 12]})],
    "one-allele": [(100, 101, {"A": [1, 2, 3], "C": [4, 5]}),
                   (105, 106, {"C": [4, 5, 6]}, [7]),
                   (110, 111, {"T": [1, 2, 3], "G": [4, 5]})],
    "ref-vertex": [(100, 101, {"A": [1, 2, 3], "C": [4, 5]}),
                   (105, 106, {"C": [1, 2, 4, 5]}, [6, 7, 8]),
                   (110, 111, {"T": [1, 2, 3], "G": [4, 5]})],
    "not-phasable": [(100, 101, {"A": [1, 2, 3, 10], "C": [4, 5]}),
                     (105, 106, {"C": [1, 2, 3, 10, 11],
                                 "G": [4, 5, 12, 13]}),
                     (110, 111, {"C": [10, 13], "G": [11, 12]}),
                     (120, 121, {"T": [6, 7], "G": [8, 9]}),
                     (125, 126, {"A": [6, 7], "T": [8, 9]})],
    "indel": [(100, 102, {"CC": [4, 5, 6], "A": [1, 2]}, [7]),
              (110, 111, {"T": [1, 2, 3], "G": [4, 5, 6]})],
    "broken-no-connection": [(100, 101, {"A": [1, 2, 3], "C": [4, 5, 6]}),
                             (105, 106, {"C": [4, 5, 1], "G": [2, 3, 6]}),
                             (110, 111, {"C": [7, 8, 9], "G": [10, 11, 12]}),
                             (120, 121, {"T": [10, 11, 9],
                                         "G": [7, 8, 12]})],
}


def build(package, specs):
    return [cand(package, *spec) for spec in specs]


def n_reads(specs):
    ids = [r for spec in specs for reads in spec[2].values() for r in reads]
    ids += [r for spec in specs if len(spec) > 3 for r in spec[3]]
    return max(ids)


def phasing_state(package, candidates, num_reads, min_alleles):
    """Everything DirectPhasing computes, as plain values."""
    module = PHASING[package]
    dp = module.DirectPhasing(module.DirectPhasingOptions(
        min_alleles_to_phase=min_alleles))
    phases = dp.phase_reads(candidates, num_reads)
    return {
        "phases": phases,
        "phased_variants": [
            (p.position, p.phase_1_bases, p.phase_2_bases,
             p.is_first_in_block) for p in dp.phased_variants()],
        "vertices": [(v.position, v.bases, v.read_support, v.phase,
                      v.is_first_in_block, sorted(v.first_allele_reads))
                     for v in dp.vertices],
        "positions": dp.positions,
        "edges": list(dp.edges.items()),
        "in_edges": list(dp.in_edges.items()),
        "scores": [(k, s.score, s.from_pair,
                    [sorted(x) for x in s.read_support])
                   for k, s in dp.scores.items()],
    }


@pytest.mark.parametrize("min_alleles", [1, 2])
@pytest.mark.parametrize("name", list(HAND_CASES))
def test_hand_cases_match_jax(name, min_alleles):
    specs = HAND_CASES[name]
    want = phasing_state(JAX, build(JAX, specs), n_reads(specs), min_alleles)
    got = phasing_state(PORT, build(PORT, specs), n_reads(specs), min_alleles)
    assert got == want


def random_specs(seed):
    """A seeded candidate set: 3-14 sites in position order, SNP alleles
    and now and then an indel, a multi-allelic or an uncalled allele,
    reads drawn from two haplotypes with errors, REF support of 0-6
    reads."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(6, 30))
    hap = rng.randint(0, 2, n)
    specs, start = [], 100
    for _ in range(int(rng.randint(3, 15))):
        start += int(rng.randint(1, 40))
        alleles = list(rng.permutation(list("ACGT"))[:int(rng.randint(1, 4))])
        end = start + 1
        if rng.rand() < 0.15:
            alleles[0] = alleles[0] * int(rng.randint(2, 4))
        if rng.rand() < 0.1:
            end = start + 2
            alleles = [a * 2 for a in alleles]
        if rng.rand() < 0.1:
            alleles.append("UNCALLED_ALLELE")
        covered = np.flatnonzero(rng.rand(n) < 0.7)
        support = {a: [] for a in alleles}
        ref = []
        for r in covered:
            pick = int(hap[r]) if rng.rand() < 0.85 else int(rng.randint(3))
            if pick < len(alleles):
                support[alleles[pick]].append(int(r) + 1)
            elif rng.rand() < 0.5:
                ref.append(int(r) + 1)
        specs.append((start, end, support, ref))
        start = end
    return specs


@pytest.mark.parametrize("min_alleles", [1, 2])
@pytest.mark.parametrize("seed", range(24))
def test_seeded_candidate_sets_match_jax(seed, min_alleles):
    specs = random_specs(seed)
    num = max(n_reads(specs), 1) + 2
    want = phasing_state(JAX, build(JAX, specs), num, min_alleles)
    got = phasing_state(PORT, build(PORT, specs), num, min_alleles)
    assert got == want


@pytest.mark.parametrize("name", ["helpers"])
def test_helpers_and_constants_match_jax(name):
    for const in ("MIN_REF_ALLELE_DEPTH", "REF_BASES", "NUM_PHASES",
                  "SUBSTITUTION", "INSERTION", "DELETION"):
        assert getattr(tdp, const) == getattr(jdp, const)
    assert tdp.DirectPhasingOptions() == tdp.DirectPhasingOptions(1, 100)
    for specs in HAND_CASES.values():
        for jc, tc in zip(build(JAX, specs), build(PORT, specs)):
            for bases in list(jc.allele_support) + ["A", "AAA", ""]:
                assert tdp.allele_type_from_candidate(bases, tc) == \
                    jdp.allele_type_from_candidate(bases, jc)
            for fn in ("num_of_substitution_alleles", "num_of_indel_alleles",
                       "substitution_alleles_depth"):
                assert getattr(tdp, fn)(tc) == getattr(jdp, fn)(jc)
    for ordered in (HAND_CASES["simple"][::-1],
                    [HAND_CASES["simple"][0]] * 2):
        for module, package in ((jdp, JAX), (tdp, PORT)):
            with pytest.raises(ValueError, match="ordered by position"):
                module.DirectPhasing().phase_reads(build(package, ordered), 5)
    for name_, value in vars(tcore).items():
        if name_ in ("MIN_DIFF_READS_FOR_ALLELE_PHASE",
                     "MAX_NUM_READS_FOR_OPPOSITE_PHASE",
                     "PHASING_ERROR_STATS_OUTPUT_COLUMNS"):
            assert getattr(jcore, name_) == value
    for a in range(9):
        for b in range(9):
            assert tcore._phased_genotype_from_counts(a, b) == \
                jcore._phased_genotype_from_counts(a, b)


# -- the seeded long-read sample ----------------------------------------------

@pytest.fixture(scope="module")
def long_paths(tmp_path_factory):
    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    return write_stage1_inputs(sample, tmp_path_factory.mktemp("long"))


REGIONS = [("chr1", 0, 3000), ("chr1", 3000, 6000), ("chr2", 0, 3000),
           ("chr1", 1500, 2500)]


@pytest.mark.parametrize("region", REGIONS)
def test_phasing_of_sample_candidates_matches_jax(long_paths, region):
    """Candidates of the long-read sample over a padded region, called by
    each package from the files; DirectPhasing on each package's own
    candidates."""
    got_state = []
    for package in (JAX, PORT):
        types = package_module(package, "core.types")
        options = preset_options(package, long_paths, "PACBIO")
        processor = CORES[package].RegionProcessor(options)
        name, start, end = region
        batch = processor.region_reads(types.Range(name, start, end))
        padded = types.Range(name, max(0, start - 200),
                             min(processor.ref_reader.contig_length(name),
                                 end + 200))
        candidates, _, _ = processor.candidates_in_region(padded, batch,
                                                          False)
        got_state.append((candidates, phasing_state(
            package, candidates, len(batch), 1)))
    (jcands, want), (tcands, got) = got_state
    assert_calls_equal(tcands, jcands)
    assert got == want


# -- the runner with the long-read presets at their defaults -------------------

def run(package, paths, tmp, model_type, **overrides):
    """The runner with a preset's defaults, phase info and both phasing
    TSVs on, and the candidates TFRecord. Returns (counts, plans,
    {output name: bytes}, processor runtimes)."""
    tag = f"{package}-{model_type}"
    outputs = {
        "phasing_stats": os.path.join(tmp, f"{tag}.phasing.tsv"),
        "read_phases": os.path.join(tmp, f"{tag}.read_phases.tsv"),
        "candidates": os.path.join(tmp, f"{tag}.candidates.tfrecord"),
        "runtime": os.path.join(tmp, f"{tag}.runtime.tsv"),
    }
    options = preset_options(
        package, paths, model_type, output_phase_info=True,
        output_phasing_error_stats_filename=outputs["phasing_stats"],
        output_local_read_phasing_filename=outputs["read_phases"],
        candidates_filename=outputs["candidates"], **overrides)
    plans = []
    counts = CORES[package].make_examples_runner(
        options, runtime_by_region_path=outputs["runtime"],
        plan_sink=plans.append)
    files = {}
    for key, path in outputs.items():
        with open(path, "rb") as f:
            files[key] = f.read()
    return counts, plans, files


RUNS = {
    "pacbio": ("PACBIO", dict(partition_size=3000)),
    "pacbio-hp-tags": ("PACBIO", dict(partition_size=2000,
                                      parse_sam_aux_fields=True,
                                      aux_fields_to_keep=["HP"])),
    "ont": ("ONT_R104", dict(regions=["chr1:1-4,500", "chr2"])),
    "pacbio-min-alleles": ("PACBIO", dict(min_alleles_to_phase=2,
                                          regions=["chr1"])),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_with_long_read_presets_matches_jax(name, long_paths,
                                                   tmp_path):
    model_type, overrides = RUNS[name]
    want_counts, want, want_files = run(JAX, long_paths, str(tmp_path),
                                        model_type, **overrides)
    counts, got, files = run(PORT, long_paths, str(tmp_path), model_type,
                             **overrides)
    assert counts == want_counts and len(got) >= 5
    assert_planned_equal(got, want)
    for key in ("phasing_stats", "read_phases", "candidates"):
        assert files[key] == want_files[key], key
    # The runtime TSV has the same rows and columns (its seconds differ).
    assert [line.split(b"\t")[0] for line in files["runtime"].splitlines()] \
        == [line.split(b"\t")[0]
            for line in want_files["runtime"].splitlines()]
    # The reads got phases, the HP plane paints them, and the candidates
    # carry the phase info the VCF's PS fields come from.
    assert any(p.plan["hp"].any() for p in got)
    assert len(files["phasing_stats"].splitlines()) > 1
    assert b"\t1\t" in files["read_phases"] and \
        b"\t2\t" in files["read_phases"]
    assert b"PS_CONTIG" in files["candidates"]


def test_padded_region_is_cropped_back(long_paths):
    """process() calls candidates over the region padded by
    phase_reads_region_padding_pct, phases with them, and returns only
    the candidates that start inside the region; the padding changes
    the phases, and so the plans."""
    region = ("chr2", 1000, 2000)
    outs = {}
    for package in (JAX, PORT):
        types = package_module(package, "core.types")
        for pct in (20, 0):
            options = preset_options(package, long_paths, "PACBIO",
                                     phase_reads_region_padding_pct=pct)
            processor = CORES[package].RegionProcessor(options)
            processor.plan_mode = True
            outs[package, pct] = processor.process(types.Range(*region))
    for pct in (20, 0):
        got, want = outs[PORT, pct], outs[JAX, pct]
        assert_calls_equal(got.candidates, want.candidates)
        assert_planned_equal(got.plans, want.plans)
        assert all(region[1] <= c.variant.start < region[2]
                   for c in got.candidates)
        assert "phase reads" in got.runtimes
    assert any(not np.array_equal(a.plan["hp"], b.plan["hp"])
               for a, b in zip(outs[PORT, 20].plans, outs[PORT, 0].plans))
    # The padded region holds candidates outside the region.
    processor = tcore.RegionProcessor(preset_options(PORT, long_paths,
                                                     "PACBIO"))
    types = package_module(PORT, "core.types")
    batch = processor.region_reads(types.Range(*region))
    padded, _, _ = processor.candidates_in_region(
        types.Range("chr2", 800, 2200), batch, False)
    assert any(not region[1] <= c.variant.start < region[2] for c in padded)


@pytest.mark.parametrize("limit", [1, 5])
def test_phase_max_candidates_gate(long_paths, tmp_path, limit):
    """A region with more candidates than phase_max_candidates is not
    phased: no "phase reads" time, no TSV rows, no phase info, and the
    plans are still the JAX runner's."""
    want_counts, want, want_files = run(
        JAX, long_paths, str(tmp_path), "PACBIO", phase_max_candidates=limit,
        regions=["chr2:1-3,000"])
    counts, got, files = run(PORT, long_paths, str(tmp_path), "PACBIO",
                             phase_max_candidates=limit,
                             regions=["chr2:1-3,000"])
    assert counts == want_counts and counts["candidates"] > limit
    assert_planned_equal(got, want)
    for key in ("phasing_stats", "read_phases", "candidates"):
        assert files[key] == want_files[key], key
    assert files["phasing_stats"].count(b"\n") == 1   # the header alone
    assert files["read_phases"].count(b"\n") == 1
    assert b"PS_CONTIG" not in files["candidates"]
    processor = tcore.RegionProcessor(preset_options(
        PORT, long_paths, "PACBIO", phase_max_candidates=limit))
    processor.plan_mode = True
    types = package_module(PORT, "core.types")
    assert "phase reads" not in processor.process(
        types.Range("chr2", 0, 3000)).runtimes

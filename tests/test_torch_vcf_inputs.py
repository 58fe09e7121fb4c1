"""The VCF inputs of stage 1 in the PyTorch port against the JAX package:
the population VCF (`make_examples/allele_frequency.py`, the
allele_frequency channel), the proposed variants
(`make_examples/vcf_candidate_importer.py`, the region skip) and the
excluded variants (`RegionProcessor._apply_candidate_filters`), and the
option checks that go with them.

Host code in both packages, so everything is exact: the frequency dicts
with their key orders, candidates' wire bytes, plans key by key, the
candidates TFRecord, and the allele-frequency plane of the painted
images. The VCFs come from the planted variants of the seeded sample
(`synthetic.write_vcf_inputs`, the port's own VCF and tabix writers);
the population VCF gives every branch of the haplotype matching
something to match: the same alleles, the same haplotypes written
longer, an extra alt, another alt at the site (a REF-only match), and
no record.
"""

import os

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import types as jt
from deepvariant_tpu.io.fasta import FastaReader as JaxFastaReader
from deepvariant_tpu.make_examples import allele_frequency as jaf
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.make_examples import variant_caller as jvc
from deepvariant_tpu.make_examples import vcf_candidate_importer as jvci
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io.fasta import FastaReader as PortFastaReader
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.io.vcf import VcfReader as PortVcfReader
from deepvariant_tpu_torch.make_examples import allele_frequency as taf
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.make_examples import variant_caller as tvc
from deepvariant_tpu_torch.make_examples import vcf_candidate_importer as tvci
from deepvariant_tpu_torch.make_examples.pileup_device import (
    PLAN_KEYS,
    make_longread_encode_fn,
)
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    STAGE1_REGIONS,
    assert_calls_equal,
    assert_planned_equal,
    jax_images,
    region_counters,
    stage1_sample,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
CORE = {JAX: jcore, PORT: tcore}
AF = {JAX: jaf, PORT: taf}
TYPES = {JAX: jt, PORT: tt}
FASTA = {JAX: JaxFastaReader, PORT: PortFastaReader}
CH_ALLELE_FREQUENCY = 8


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded sample's FASTA and BAM and its three VCFs."""
    tmp = tmp_path_factory.mktemp("vcf_inputs")
    sample = stage1_sample()
    files = dict(write_stage1_inputs(sample, tmp))
    files.update(synthetic.write_vcf_inputs(
        sample, str(tmp / "vcfs"), population=True,
        population_by_contig=True, proposed=True, exclude=True))
    files["tmp"] = str(tmp)
    return files


def records(path):
    return [(v.reference_name, v.start, v.reference_bases,
             tuple(v.alternate_bases), tuple(v.info.get("AF", ())))
            for v in PortVcfReader(path)]


def test_write_vcf_inputs_is_seeded_and_writes_what_is_asked(inputs,
                                                              tmp_path):
    sample = stage1_sample()
    again = synthetic.write_vcf_inputs(sample, str(tmp_path), proposed=True)
    assert list(again) == ["proposed"]
    assert sorted(os.listdir(tmp_path)) == ["proposed.vcf.gz",
                                            "proposed.vcf.gz.tbi"]
    with open(again["proposed"], "rb") as a, \
            open(inputs["proposed"], "rb") as b:
        assert a.read() == b.read()
    # The sample keeps its bytes: its draws are not touched.
    assert stage1_sample()["reads"]["pos"].tobytes() == \
        sample["reads"]["pos"].tobytes()
    cohort = records(inputs["population"])
    assert cohort and all(len(af) == len(alts)
                          for _, _, _, alts, af in cohort)
    by_contig = [r for path in inputs["population_by_contig"]
                 for r in records(path)]
    assert by_contig == cohort
    for path in [inputs["population"], inputs["proposed"],
                 inputs["exclude"]] + inputs["population_by_contig"]:
        assert os.path.exists(path + ".tbi")
    planted = sum(len(v) for v in sample["variants"].values())
    assert planted // 2 < len(cohort) < planted


# -- allele_frequency.py on crafted cohorts -----------------------------------------

class ListReader:
    """A cohort in memory with the reader's `query`."""

    def __init__(self, variants):
        self.variants = variants

    def query(self, region):
        return [v for v in self.variants
                if v.reference_name == region.reference_name
                and v.start < region.end and v.end > region.start]


def crafted(package, ref):
    """(candidate, cohort) pairs of one package over the sample's chr1,
    one for each branch of the matching."""
    types = TYPES[package]

    def var(start, ref_bases, alts, af=None):
        info = {"AF": list(af)} if af is not None else {}
        return types.Variant(reference_name="chr1", start=start,
                             end=start + len(ref_bases),
                             reference_bases=ref_bases,
                             alternate_bases=list(alts), info=info)

    def base(pos, n=1):
        return ref.query(types.Range("chr1", pos, pos + n))

    b = base(2000)
    snp = [x for x in "ACGT" if x != b]
    dele = base(3000, 3)
    return {
        "exact": (var(2000, b, snp[:1]), [var(2000, b, snp[:1], [0.2])]),
        "ref-only": (var(2000, b, snp[:1]), [var(2000, b, snp[1:2], [0.3])]),
        "multi-alt": (var(2000, b, snp[:2]),
                      [var(2000, b, snp, [0.1, 0.2, 0.05])]),
        "longer-form": (var(3000, dele, dele[0]),
                        [var(3000, dele + base(3003), dele[0] + base(3003),
                             [0.15])]),
        "unmatched": (var(2000, b, snp[:1]), [var(2003, "A", "C", [0.4])]),
        "no-af": (var(2000, b, snp[:1]), [var(2000, b, snp[:1])]),
        "empty": (var(2000, b, snp[:1]), []),
        "past-the-contig": (var(5990, base(5990), "T"),
                            [var(5995, "A" * 20, "A", [0.1])]),
        "zero-af": (var(2000, b, snp[:1]), [var(2000, b, snp[1:2], [0.0]),
                                            var(2000, b, snp[:1], [0.0])]),
    }


CRAFTED = ["exact", "ref-only", "multi-alt", "longer-form", "unmatched",
           "no-af", "empty", "past-the-contig", "zero-af"]


@pytest.mark.parametrize("name", CRAFTED)
def test_find_matching_allele_frequency_matches_jax(inputs, name):
    got = {}
    for package in (JAX, PORT):
        ref = FASTA[package](inputs["ref"])
        candidate, cohort = crafted(package, ref)[name]
        result = AF[package].find_matching_allele_frequency(
            candidate, ListReader(cohort), ref)
        got[package] = list(result.items())
        calls = list(AF[package].add_allele_frequencies_to_candidates(
            [tvc.DeepVariantCall(candidate, {}) if package == PORT
             else jvc.DeepVariantCall(candidate, {})],
            ListReader(cohort), ref))
        assert list(calls[0].allele_frequencies.items()) == got[package]
    assert got[PORT] == got[JAX]
    assert all(type(a) is type(b) for (_, a), (_, b) in zip(got[PORT],
                                                           got[JAX]))


def test_allele_frequency_raises_as_jax(inputs, tmp_path):
    for package in (JAX, PORT):
        af = AF[package]
        types = TYPES[package]
        ref = FASTA[package](inputs["ref"])
        v = types.Variant(reference_name="chr1", start=100, end=101,
                          reference_bases="A", alternate_bases=["C"],
                          info={"AF": [0.5]})
        with pytest.raises(ValueError, match="AF field"):
            af.get_allele_frequency(types.Variant(alternate_bases=["C"]), 0)
        with pytest.raises(ValueError, match="Invalid index 1"):
            af.get_allele_frequency(v, 1)
        with pytest.raises(ValueError, match="offset"):
            af.update_haplotype(v, "ACGT", 101)
        past = types.Variant(reference_name="chr1", start=5995, end=6010,
                             reference_bases="A" * 15, alternate_bases=["A"])
        with pytest.raises(ValueError, match="Invalid reference region"):
            af.get_ref_haplotype_and_offset(past, [past], ref)
        assert af.get_ref_allele_frequency(types.Variant(
            alternate_bases=["C", "G"], info={"AF": [0.25, 0.5]})) == 0.25
        # One file per contig: a contig in two files raises.
        with pytest.raises(ValueError, match="multiple VCFs"):
            af.make_population_vcf_readers(
                [inputs["population_by_contig"][0]] * 2)
        no_reader = list(af.add_allele_frequencies_to_candidates(
            [(jvc if package == JAX else tvc).DeepVariantCall(v, {})],
            None, ref))
        assert list(no_reader[0].allele_frequencies.items()) == \
            [("A", 1), ("C", 0)]


def test_population_readers_match_jax(inputs):
    for files in ([inputs["population"]], inputs["population_by_contig"]):
        readers = {p: AF[p].make_population_vcf_readers(files)
                   for p in (JAX, PORT)}
        for contig in ("chr1", "chr2", "chr3"):
            got, want = readers[PORT][contig], readers[JAX][contig]
            assert (got is None) == (want is None)
            if got is None:
                continue
            region = (TYPES[PORT].Range(contig, 0, 10_000),
                      TYPES[JAX].Range(contig, 0, 10_000))
            assert [v.encode() for v in got.query(region[0])] == \
                [v.encode() for v in want.query(region[1])]
        if len(files) > 1:
            assert readers[PORT]["chr3"] is None


# -- the runner with a population VCF ------------------------------------------------

def af_options(package, paths, **overrides):
    """The WGS options with channel 8 appended, as --use_allele_frequency
    appends it."""
    options = wgs_options(package, paths, **overrides)
    options.pileup_options.channels = tuple(
        options.pileup_options.channels) + (CH_ALLELE_FREQUENCY,)
    return options


@pytest.mark.parametrize("files", ["population", "population_by_contig"])
def test_population_plans_match_jax(inputs, tmp_path, files):
    population = inputs[files] if files != "population" \
        else [inputs[files]]
    out = {}
    for package in (JAX, PORT):
        candidates = str(tmp_path / f"{package}.candidates.tfrecord")
        plans = []
        counts = CORE[package].make_examples_runner(
            af_options(package, inputs, population_vcf_filenames=population,
                       candidates_filename=candidates),
            plan_sink=plans.append)
        with open(candidates, "rb") as f:
            out[package] = (counts, plans, f.read())
    assert out[PORT][0] == out[JAX][0] and out[PORT][2] == out[JAX][2]
    assert_planned_equal(out[PORT][1], out[JAX][1])
    plans = out[PORT][1]
    assert len(plans) > 50
    assert sum(bool(p.plan["af"].any()) for p in plans) > len(plans) // 4


def test_candidate_frequencies_match_jax(inputs):
    """Every branch of the matching fires on the sample's cohort: alts
    with a cohort frequency, REF-only matches and unmatched sites."""
    kinds = {"exact": 0, "ref-only": 0, "unmatched": 0}
    for region in STAGE1_REGIONS:
        got = {}
        for package in (JAX, PORT):
            processor = CORE[package].RegionProcessor(af_options(
                package, inputs,
                population_vcf_filenames=[inputs["population"]]))
            processor.plan_mode = True
            outputs = processor.process(TYPES[package].Range(*region))
            got[package] = outputs
        assert_calls_equal(got[PORT].candidates, got[JAX].candidates)
        assert_planned_equal(got[PORT].plans, got[JAX].plans)
        for g, w in zip(got[PORT].candidates, got[JAX].candidates):
            freqs = list(g.allele_frequencies.items())
            assert freqs == list(w.allele_frequencies.items())
            ref_af = g.allele_frequencies[g.variant.reference_bases]
            alts = [g.allele_frequencies[a]
                    for a in g.variant.alternate_bases]
            if any(alts):
                kinds["exact"] += 1
            elif ref_af < 1:
                kinds["ref-only"] += 1
            else:
                kinds["unmatched"] += 1
    assert all(n > 0 for n in kinds.values()), kinds


def test_af_plane_of_painted_images_matches_jax(inputs):
    plans = []
    tcore.make_examples_runner(
        af_options(PORT, inputs, population_vcf_filenames=[
            inputs["population"]], regions=["chr1:1-2,500"]),
        plan_sink=plans.append)
    stacked = {k: np.stack([p.plan[k] for p in plans]) for k in PLAN_KEYS}
    port_options = af_options(PORT, inputs).pileup_options
    jax_options = af_options(JAX, inputs).pileup_options
    got = make_longread_encode_fn(port_options)(
        *[torch.from_numpy(stacked[k]) for k in PLAN_KEYS]).numpy()
    want = jax_images(stacked, jax_options)
    assert got.shape == want.shape and got.shape[-1] == 8
    np.testing.assert_array_equal(got, want)
    plane = list(port_options.channels).index(CH_ALLELE_FREQUENCY)
    assert (got[..., plane] != 0).sum() > 0
    # The plane is the frequency of the allele each read supports: rows
    # whose reads support an alt with a cohort frequency are lit.
    assert len(np.unique(got[..., plane])) > 2


# -- the importer ---------------------------------------------------------------------

def importer_options(package, paths, proposed, **overrides):
    return wgs_options(package, paths, proposed_variants_filename=proposed,
                       variant_caller="vcf_candidate_importer", **overrides)


@pytest.mark.parametrize("gvcf", [False, True], ids=["plans", "plans+gvcf"])
def test_importer_runner_matches_jax(inputs, tmp_path, gvcf):
    out = {}
    for package in (JAX, PORT):
        candidates = str(tmp_path / f"{package}.candidates.tfrecord")
        tsv = str(tmp_path / f"{package}.runtime.tsv")
        plans = []
        options = importer_options(
            package, inputs, inputs["proposed"],
            candidates_filename=candidates,
            gvcf_filename=str(tmp_path / f"{package}.gvcf.tfrecord")
            if gvcf else "")
        counts = CORE[package].make_examples_runner(
            options, runtime_by_region_path=tsv, plan_sink=plans.append)
        with open(candidates, "rb") as f, open(tsv) as g:
            out[package] = (counts, plans, f.read(), len(g.readlines()) - 1)
        if gvcf:
            with open(options.gvcf_filename, "rb") as f:
                out[package] += (f.read(),)
    assert out[PORT][0] == out[JAX][0]
    assert out[PORT][2:] == out[JAX][2:]
    assert_planned_equal(out[PORT][1], out[JAX][1])
    # The region skip: regions of an odd kilobase hold no proposed
    # variant and are not processed (9 kb: 9 regions, 5 of them even).
    assert out[PORT][3] == 5
    proposed = {(c, s, r, a) for c, s, r, a, _ in records(inputs["proposed"])}
    got = [tt.Variant.decode(buf) for buf in TFRecordReader(
        str(tmp_path / f"{PORT}.candidates.tfrecord"))]
    assert len(got) == len(proposed)
    for v in got:
        assert (v.reference_name, v.start, v.reference_bases,
                tuple(v.alternate_bases)) in proposed


def test_importer_calls_in_region_match_jax(inputs):
    want_caller = jvci.VcfCandidateImporter(jvc.VariantCallerOptions(),
                                            inputs["proposed"])
    got_caller = tvci.VcfCandidateImporter(tvc.VariantCallerOptions(),
                                           inputs["proposed"])
    n = unsupported = 0
    for region in STAGE1_REGIONS:
        want_counter, got_counter = region_counters(inputs, region)
        want = want_caller.calls_in_region(want_counter)
        got = got_caller.calls_in_region(got_counter)
        assert_calls_equal(got, want)
        n += len(got)
        unsupported += sum(c.variant.calls[0].info["AD"][1:] == [0]
                           for c in got)
    assert n > 10 and unsupported > 0


def test_proposed_region_filter_matches_jax(inputs):
    contigs = {p: FASTA[p](inputs["ref"]).contigs for p in (JAX, PORT)}
    positions = {p: CORE[p].fetch_vcf_positions(
        [inputs["proposed"]], contigs[p], None) for p in (JAX, PORT)}
    assert [(r.reference_name, r.start, r.end) for r in positions[PORT]] == \
        [(r.reference_name, r.start, r.end) for r in positions[JAX]]
    regions = {p: CORE[p].regions_to_process(contigs[p], 700, None, None,
                                             None) for p in (JAX, PORT)}
    kept = {p: CORE[p].filter_regions_by_vcf(regions[p], positions[p])
            for p in (JAX, PORT)}
    assert [(r.reference_name, r.start, r.end) for r in kept[PORT]] == \
        [(r.reference_name, r.start, r.end) for r in kept[JAX]]
    assert 0 < len(kept[PORT]) < len(regions[PORT])


# -- excluded variants ---------------------------------------------------------------

@pytest.fixture(scope="module")
def plain_run(inputs):
    plans = []
    tcore.make_examples_runner(wgs_options(PORT, inputs),
                               plan_sink=plans.append)
    return plans


@pytest.mark.parametrize("threshold", [0.05, 0.5])
def test_exclude_matches_jax(inputs, plain_run, tmp_path, threshold):
    out = {}
    for package in (JAX, PORT):
        candidates = str(tmp_path / f"{package}.candidates.tfrecord")
        plans = []
        counts = CORE[package].make_examples_runner(
            wgs_options(package, inputs,
                        exclude_variants_vcf_filename=inputs["exclude"],
                        exclude_variants_af_threshold=threshold,
                        candidates_filename=candidates),
            plan_sink=plans.append)
        with open(candidates, "rb") as f:
            out[package] = (counts, plans, f.read())
    assert out[PORT][0] == out[JAX][0] and out[PORT][2] == out[JAX][2]
    assert_planned_equal(out[PORT][1], out[JAX][1])
    kept = {(p.variant.reference_name, p.variant.start) for p in out[PORT][1]}
    before = {(p.variant.reference_name, p.variant.start) for p in plain_run}
    dropped = before - kept
    assert kept <= before and dropped
    for contig, start, ref, alts, afs in records(inputs["exclude"]):
        if (contig, start) in dropped:
            assert max(afs) >= threshold
    # A higher threshold drops fewer sites.
    assert len(dropped) < len(before) // 2 if threshold == 0.5 \
        else len(dropped) > 5


# -- option checks ---------------------------------------------------------------------

OPTION_CHECKS = {
    "importer-without-proposed": dict(variant_caller="vcf_candidate_importer"),
    "unknown-caller": dict(variant_caller="bogus_caller"),
    "gvcf-binsize": dict(gvcf_filename="g.tfrecord"),
    "gvcf-in-training": dict(mode="training", gvcf_filename="g.tfrecord",
                             truth_variants_filename="t.vcf",
                             confident_regions_filename="c.bed"),
    "proposed-in-training": dict(mode="training",
                                 variant_caller="vcf_candidate_importer",
                                 proposed_variants_filename="p.vcf",
                                 truth_variants_filename="t.vcf"),
}


@pytest.mark.parametrize("name", list(OPTION_CHECKS))
def test_option_checks_match_jax(inputs, name):
    messages = []
    for package in (JAX, PORT):
        options = wgs_options(package, inputs, examples_filename="e.tfrecord",
                              **OPTION_CHECKS[name])
        if name == "gvcf-binsize":
            options.variant_caller_options.gq_resolution = 0
        with pytest.raises(CORE[package].OptionsError) as info:
            CORE[package].check_options_are_valid(options)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_ported_inputs_pass_the_checks(inputs):
    for package in (JAX, PORT):
        options = importer_options(
            package, inputs, inputs["proposed"],
            examples_filename="e.tfrecord", gvcf_filename="g.tfrecord",
            exclude_variants_vcf_filename=inputs["exclude"],
            population_vcf_filenames=[inputs["population"]])
        CORE[package].check_options_are_valid(options)
    tcore.RegionProcessor(options)

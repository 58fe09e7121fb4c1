"""`deepvariant_tpu_torch.make_examples.variant_caller` against the JAX
package's, on allele counters filled from the shared synthetic BAM: the
candidates' `variant.encode()` bytes and their support lists (with their
dict orders) are equal, at the default thresholds and at others, with
`create_complex_alleles` on and off. Everything is exact."""

import dataclasses

import pytest
import torch

from deepvariant_tpu.make_examples import allele_counter as jac
from deepvariant_tpu.make_examples import variant_caller as jvc
from deepvariant_tpu_torch.make_examples import allele_counter as tac
from deepvariant_tpu_torch.make_examples import variant_caller as tvc
from torch_port_util import (
    STAGE1_REGIONS as REGIONS,
    assert_calls_equal,
    region_counters as counters,
    stage1_sample,
    to_package,
    write_stage1_inputs,
)

torch.set_num_threads(2)

THRESHOLDS = {
    "default": dict(),
    "strict": dict(min_count_snps=4, min_count_indels=5,
                   min_fraction_snps=0.3, min_fraction_indels=0.25),
    "loose": dict(min_count_snps=1, min_count_indels=1,
                  min_fraction_snps=0.02, min_fraction_indels=0.02,
                  sample_name="loose"),
    "indel-sizes": dict(min_indel_fraction_for_small_indels=0.1,
                        min_indel_fraction_for_large_indels=0.4,
                        small_indel_threshold=2),
    "rejected+context": dict(use_rejected_alleles=True,
                             small_model_vaf_context_window_size=11),
}


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    return write_stage1_inputs(stage1_sample(),
                               tmp_path_factory.mktemp("jax_in"))


@pytest.fixture(scope="module")
def region_counters(paths):
    return [counters(paths, region, track_ref_reads=i % 2 == 0)
            for i, region in enumerate(REGIONS)]


@pytest.mark.parametrize("complex_alleles", [False, True],
                         ids=["simple", "complex"])
@pytest.mark.parametrize("name", list(THRESHOLDS))
def test_calls_in_region_match_jax(region_counters, name, complex_alleles):
    options = dict(THRESHOLDS[name], create_complex_alleles=complex_alleles)
    n = multi = indels = 0
    for want_counter, got_counter in region_counters:
        want = jvc.VerySensitiveCaller(
            jvc.VariantCallerOptions(**options)).calls_in_region(want_counter)
        got = tvc.VerySensitiveCaller(
            tvc.VariantCallerOptions(**options)).calls_in_region(got_counter)
        assert_calls_equal(got, want)
        n += len(got)
        multi += sum(len(c.variant.alternate_bases) > 1 for c in got)
        indels += sum(len(c.variant.reference_bases) > 1 for c in got)
    assert n > 30 and indels > 2
    if name != "strict":
        assert multi > 2


def test_reference_sites_follow_the_same_draws(region_counters):
    """fraction_reference_sites_to_emit draws from a Philox generator:
    the same sites come out, '.'-alt records included."""
    options = dict(fraction_reference_sites_to_emit=0.05, random_seed=99)
    want_counter, got_counter = region_counters[-1]
    want = jvc.VerySensitiveCaller(
        jvc.VariantCallerOptions(**options)).calls_in_region(want_counter)
    got = tvc.VerySensitiveCaller(
        tvc.VariantCallerOptions(**options)).calls_in_region(got_counter)
    assert_calls_equal(got, want)
    assert any(c.variant.alternate_bases == [tvc.NO_ALT_ALLELE] for c in got)


def test_call_position_and_support_from_counter(region_counters):
    want_counter, got_counter = region_counters[1]
    jcaller = jvc.VerySensitiveCaller()
    tcaller = tvc.VerySensitiveCaller()
    called = 0
    for pos in want_counter.positions_with_alleles():
        want = jcaller.call_position(want_counter, pos)
        got = tcaller.call_position(got_counter, pos)
        assert (got is None) == (want is None)
        if want is None:
            continue
        called += 1
        last = got
        assert_calls_equal([got], [want])
        assert tcaller.support_from_counter(got_counter, got) == \
            jcaller.support_from_counter(want_counter, want)
    assert called > 5
    # A candidate outside the counter's interval has no support there.
    other = region_counters[4][1]
    assert tcaller.support_from_counter(other, last) == ({}, [])


def test_allele_helpers_match_jax():
    alleles = [("A", "SUBSTITUTION", 3), ("ACG", "INSERTION", 2),
               ("ACGT", "DELETION", 4), ("AC", "DELETION", 2),
               ("AG", "SUBSTITUTION", 2), ("AAA", "SOFT_CLIP", 9)]

    def build(ac):
        return [ac.Allele(b, getattr(ac, t), c, list(range(c)))
                for b, t, c in alleles]

    for subset in (slice(None), slice(0, 2), slice(3, 4), slice(0, 0),
                   slice(4, 6)):
        j, t = build(jac)[subset], build(tac)[subset]
        ref = tvc.calc_ref_bases("A", t)
        assert ref == jvc.calc_ref_bases("A", j)
        got = [(dataclasses.astuple(a), alt)
               for a, alt in tvc.build_allele_map(t, ref)]
        want = [(dataclasses.astuple(a), alt)
                for a, alt in jvc.build_allele_map(j, ref)]
        assert got == want
    for args in (("A", "ACGT", 1), ("A", "ACGT", 4), ("AC", "A", 2)):
        assert tvc.make_alt_allele(*args) == jvc.make_alt_allele(*args)
    caller, jcaller = tvc.VerySensitiveCaller(), jvc.VerySensitiveCaller()
    for total in (0, 5, 40):
        assert [caller.is_good_alt_allele(a, total) for a in build(tac)] == \
            [jcaller.is_good_alt_allele(a, total) for a in build(jac)]


def test_complex_allele_helpers_match_jax(region_counters):
    hits = 0
    for want_counter, got_counter in region_counters:
        for pos in want_counter.positions_with_alleles():
            dels = [a for a in want_counter.sum_allele_counts(pos)
                    if a.type == jac.DELETION]
            if not dels:
                continue
            start = want_counter.interval.start + pos
            length = len(dels[0].bases)
            want = jvc.create_combined_alleles_support(
                want_counter, start, length)
            got = tvc.create_combined_alleles_support(
                got_counter, start, length)
            assert list(got) == list(want)
            for rid in want:
                assert [dataclasses.astuple(a) for a in got[rid]] == \
                    [dataclasses.astuple(a) for a in want[rid]]
            ref = "".join(chr(b) for b in
                          want_counter.ref[pos:pos + length]).ljust(length, "A")
            assert tvc.create_complex_alleles_support(
                got, start, length, ref) == \
                jvc.create_complex_alleles_support(want, start, length, ref)
            hits += bool(want)
    assert hits > 0


def test_options_and_call_round_trip(region_counters):
    assert [(f.name, f.default) for f in
            dataclasses.fields(tvc.VariantCallerOptions)] == \
        [(f.name, f.default) for f in
         dataclasses.fields(jvc.VariantCallerOptions)]
    want_counter, _ = region_counters[0]
    calls = jvc.VerySensitiveCaller().calls_in_region(want_counter)
    there = to_package(calls, "deepvariant_tpu_torch")
    assert type(there[0]) is tvc.DeepVariantCall
    assert_calls_equal(there, calls)
    assert_calls_equal(to_package(there, "deepvariant_tpu"), calls)

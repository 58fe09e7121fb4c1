"""The port's row planners and their host types against the JAX
package's, on seeded synthetic reads.

`build_region_tensors`, `plan_candidate`, `gather_plan_rows` and
`encode_region_candidates` of deepvariant_tpu_torch.make_examples.
pileup_device must equal those of deepvariant_tpu.make_examples.
pileup_jax field for field (integers and bytes: tolerance 0), on the
same reads built as `ReadBatch.from_reads` in both packages; so must the
in-memory ReadBatch, the CIGAR helpers, DeepVariantCall and the
crowded-window shuffle."""

import dataclasses

import numpy as np
import pytest
import torch

from deepvariant_tpu.core import cigar as jax_cigar
from deepvariant_tpu.core import types as jax_types
from deepvariant_tpu.io import bam as jax_bam
from deepvariant_tpu.io import native as jax_native
from deepvariant_tpu.make_examples import pileup as jax_pileup
from deepvariant_tpu.make_examples import pileup_jax
from deepvariant_tpu.make_examples import variant_caller as jax_caller
from deepvariant_tpu_torch.core import cigar, types
from deepvariant_tpu_torch.io import bam
from deepvariant_tpu_torch.make_examples import (
    pileup,
    pileup_device,
    variant_caller,
)
from deepvariant_tpu_torch.make_examples.shuffle import (
    Mt19937_64,
    shuffle_indices,
)
from torch_port_util import (
    ODD_COLORS,
    build_region,
    reference_window,
    synthetic_region,
)

torch.set_num_threads(2)

BATCH_COLUMNS = ("flag", "ref_id", "pos", "mapq", "seq", "qual",
                 "seq_offsets", "cigar_ops", "cigar_lens", "cigar_offsets",
                 "mate_ref_id", "mate_pos", "tlen", "hp")
ALL_CHANNELS = tuple(sorted(pileup_device.DEVICE_CHANNELS))

# name -> (PileupOptions fields, reads in the region): a roomy pileup; one
# with fewer rows than reads at its candidates, so the shuffle runs; the
# two sort options with haplotype tags; polishing and reversed haplotypes.
PLANNER_CASES = {
    "roomy": (dict(channels=ALL_CHANNELS, width=99, height=60), 80),
    "crowded": (dict(channels=ALL_CHANNELS, width=99, height=30), 240),
    "sorted": (dict(channels=ALL_CHANNELS, width=77, height=50,
                    sort_by_haplotypes=True,
                    sort_by_alt_allele_support=True), 120),
    "polishing": (dict(channels=(1, 7, 5), width=77, height=50,
                       sort_by_haplotypes=True, reverse_haplotypes=True,
                       hp_tag_for_assembly_polishing=2,
                       min_mapping_quality=30, min_base_quality=25,
                       read_overlap_buffer_bp=40, random_seed=7), 120),
}


def both_regions(seed, n_reads):
    reference, reads, candidates = synthetic_region(seed, n_reads)
    return (reference, build_region("deepvariant_tpu", reads, candidates),
            build_region("deepvariant_tpu_torch", reads, candidates))


def assert_same_fields(got, want):
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name


def test_cigar_constants_and_helpers_match_jax():
    for name in ("CHAR_TO_PROTO_OP", "PROTO_OP_TO_CHAR", "OPS_CONSUME_READ",
                 "OPS_CONSUME_REF", "BAM_OP_TO_PROTO"):
        assert getattr(types, name) == getattr(jax_types, name)
    for text in ("10M2I5D", "3H57M2S", "30M40N30M", "5=1X4P2M"):
        units = cigar.parse_cigar_string(text)
        assert units == jax_cigar.parse_cigar_string(text)
        assert cigar.format_cigar(units) == text
        assert cigar.ref_span(units) == jax_cigar.ref_span(units)
        assert cigar.read_span(units) == jax_cigar.read_span(units)
        ops = np.array([u[0] for u in units])
        lens = np.array([u[1] for u in units])
        assert cigar.ref_span_array(ops, lens) == cigar.ref_span(units)
        assert cigar.read_span_array(ops, lens) == cigar.read_span(units)


@pytest.mark.parametrize("text", ["", "M", "10", "0M", "5Q", "3M4"])
def test_malformed_cigars_raise_as_jax(text):
    with pytest.raises(ValueError):
        jax_cigar.parse_cigar_string(text)
    with pytest.raises(ValueError):
        cigar.parse_cigar_string(text)


def test_range_and_read_match_jax():
    a, b = types.Range("chr1", 5, 20), jax_types.Range("chr1", 5, 20)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.encode() == b.encode() and len(a) == len(b) == 15
    assert types.Range.decode(b.encode()) == a
    assert a.to_region_string() == b.to_region_string()
    assert types.Range.from_region_string("chr2:1,001-2,000") == \
        types.Range("chr2", 1000, 2000)
    assert a.overlaps(types.Range("chr1", 19, 30))
    assert not a.contains(types.Range("chr1", 19, 30))
    kw = dict(fragment_name="r", aligned_sequence="ACGT", position=7,
              cigar=[(1, 2), (3, 5), (1, 2)])
    assert dataclasses.asdict(types.Read(**kw)) == \
        dataclasses.asdict(jax_types.Read(**kw))
    assert types.Read(**kw).end() == jax_types.Read(**kw).end() == 16
    assert types.Read(**kw).cigar_string() == "2M5D2M"
    assert [f.name for f in dataclasses.fields(variant_caller.DeepVariantCall)
            ] == [f.name for f in dataclasses.fields(
                jax_caller.DeepVariantCall)]


def test_flag_constants_match_jax():
    names = [n for n in dir(jax_bam) if n.startswith("FLAG_")]
    assert len(names) == 12
    for name in names:
        assert getattr(bam, name) == getattr(jax_bam, name)


@pytest.mark.parametrize("seed", [0, 1])
def test_read_batch_from_reads_matches_jax(seed):
    _, (jax_batch, _, _), (batch, _, _) = both_regions(seed, 40)
    assert len(batch) == len(jax_batch) == 40
    assert batch.name == jax_batch.name and batch.aux == jax_batch.aux
    assert batch.ref_names == jax_batch.ref_names
    for column in BATCH_COLUMNS:
        a, b = getattr(batch, column), getattr(jax_batch, column)
        assert a.dtype == b.dtype, column
        np.testing.assert_array_equal(a, b, err_msg=column)
    np.testing.assert_array_equal(batch.reference_ends(),
                                  jax_batch.reference_ends())
    np.testing.assert_array_equal(batch.read_lengths(),
                                  jax_batch.read_lengths())
    np.testing.assert_array_equal(batch.is_reverse(), jax_batch.is_reverse())
    for i in (0, 7, 39):
        np.testing.assert_array_equal(batch.seq_of(i), jax_batch.seq_of(i))
        np.testing.assert_array_equal(batch.qual_of(i), jax_batch.qual_of(i))
        for a, b in zip(batch.cigar_of(i), jax_batch.cigar_of(i)):
            np.testing.assert_array_equal(a, b)


def test_read_batch_subset_and_round_trip_match_jax():
    _, (jax_batch, _, _), (batch, _, _) = both_regions(2, 40)
    picked = np.array([31, 2, 2, 17, 0])
    sub, jax_sub = batch.subset(picked), jax_batch.subset(picked)
    assert sub.name == jax_sub.name
    for column in BATCH_COLUMNS:
        np.testing.assert_array_equal(getattr(sub, column),
                                      getattr(jax_sub, column), err_msg=column)
    reads, jax_reads = batch.to_reads(), jax_batch.to_reads()
    assert [dataclasses.asdict(r) for r in reads] == \
        [dataclasses.asdict(r) for r in jax_reads]
    again = bam.ReadBatch.from_reads(reads, batch.ref_names)
    for column in BATCH_COLUMNS:
        np.testing.assert_array_equal(getattr(again, column),
                                      getattr(batch, column), err_msg=column)
    assert len(bam.ReadBatch(["chr1"])) == 0
    assert bam.ReadBatch(["chr1"]).reference_ends().shape == (0,)


def test_mt19937_64_is_the_standard_engine():
    """The C++ standard fixes the 10000th output of a default-seeded
    std::mt19937_64."""
    engine = Mt19937_64(5489)
    for _ in range(9999):
        engine()
    assert engine() == 9981545732273789042


@pytest.mark.parametrize("n,seed", [
    (0, 1), (1, 5), (2, 7), (3, 7), (64, 0), (65, 99), (96, 2101079370),
    (257, 1), (600, 2101079370), (1000, 2**40 + 3)])
def test_shuffle_matches_the_native_libcxx_shuffle(n, seed):
    assert jax_native.has_shuffle()
    got = shuffle_indices(n, seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_native.shuffle_indices(n, seed))
    assert sorted(got.tolist()) == list(range(n))


def planned(case, seed=3):
    """Both packages' encoders, region tensors, plans and inputs."""
    kw, n_reads = PLANNER_CASES[case]
    reference, (jax_batch, jax_calls, combos), (batch, calls, _) = \
        both_regions(seed, n_reads)
    options, jax_options = pileup.PileupOptions(**kw), \
        jax_pileup.PileupOptions(**kw)
    encoder, jax_encoder = pileup.PileupEncoder(options), \
        jax_pileup.PileupEncoder(jax_options)
    span_start = min(c.variant.start for c in calls) - options.half_width
    span_end = max(c.variant.start for c in calls) - options.half_width + \
        options.width
    tensors = pileup_device.build_region_tensors(
        encoder, batch, span_start, span_end)
    jax_tensors = pileup_jax.build_region_tensors(
        jax_encoder, jax_batch, span_start, span_end)
    plans, jax_plans = [], []
    for call, jax_call, combo in zip(calls, jax_calls, combos):
        window = reference_window(reference, options, call.variant)
        plans.append(pileup_device.plan_candidate(
            encoder, tensors, call, batch, combo, window))
        jax_plans.append(pileup_jax.plan_candidate(
            jax_encoder, jax_tensors, jax_call, jax_batch, combo, window))
    return dict(options=options, batch=batch, calls=calls, combos=combos,
                tensors=tensors, jax_tensors=jax_tensors, plans=plans,
                jax_plans=jax_plans, encoder=encoder)


@pytest.mark.parametrize("case", PLANNER_CASES)
def test_build_region_tensors_matches_jax(case):
    p = planned(case)
    assert_same_fields(p["tensors"], p["jax_tensors"])
    assert p["tensors"].bases.any() and (p["tensors"].bases == ord("*")).any()
    # The walk is memoized on the batch and a second span slices it.
    cache = p["batch"]._plan_walk_cache
    assert cache and p["batch"]._plan_ref_ends is not None
    again = pileup_device.build_region_tensors(
        p["encoder"], p["batch"], p["tensors"].span_start,
        p["tensors"].span_start + p["tensors"].bases.shape[1])
    assert p["batch"]._plan_walk_cache is cache
    assert_same_fields(again, p["tensors"])


@pytest.mark.parametrize("case", PLANNER_CASES)
def test_plan_candidate_matches_jax(case):
    p = planned(case)
    options = p["options"]
    for plan, jax_plan in zip(p["plans"], p["jax_plans"]):
        assert_same_fields(plan, jax_plan)
    rows = np.stack([plan.row_reads for plan in p["plans"]])
    assert (rows >= 0).any()
    overlapping = [len(pileup.reads_overlapping_variant(
        p["batch"], c.variant, options.read_overlap_buffer_bp))
        for c in p["calls"]]
    if case == "crowded":   # more reads than rows: the shuffle decided
        assert max(overlapping) > options.max_reads
        assert (rows >= 0).all(axis=1).any()
    if case == "roomy":
        assert max(overlapping) <= options.max_reads
    if case != "polishing":
        assert any(plan.af_colors.any() for plan in p["plans"])
        assert {0, 1, 2} <= set(np.concatenate(
            [plan.support_codes for plan in p["plans"]]).tolist())


def test_plan_candidate_overrides_match_jax():
    """`read_indices` and `sort_positions`, as the alt-aligned and
    trimmed pileups pass them."""
    kw, n_reads = PLANNER_CASES["sorted"]
    reference, (jax_batch, jax_calls, combos), (batch, calls, _) = \
        both_regions(4, n_reads)
    options = pileup.PileupOptions(**kw)
    start = calls[1].variant.start - options.half_width
    encoder = pileup.PileupEncoder(options)
    jax_encoder = jax_pileup.PileupEncoder(jax_pileup.PileupOptions(**kw))
    tensors = pileup_device.build_region_tensors(
        encoder, batch, start, start + options.width)
    jax_tensors = pileup_jax.build_region_tensors(
        jax_encoder, jax_batch, start, start + options.width)
    window = reference_window(reference, options, calls[1].variant)
    positions = np.random.RandomState(0).permutation(n_reads)
    plan = pileup_device.plan_candidate(
        encoder, tensors, calls[1], batch, combos[1], window,
        read_indices=np.arange(n_reads), sort_positions=positions)
    jax_plan = pileup_jax.plan_candidate(
        jax_encoder, jax_tensors, jax_calls[1], jax_batch, combos[1], window,
        read_indices=np.arange(n_reads), sort_positions=positions)
    assert_same_fields(plan, jax_plan)
    got = pileup_device.gather_plan_rows(tensors, plan, options.width)
    want = pileup_jax.gather_plan_rows(jax_tensors, jax_plan, options.width)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["row_valid"].any()


def test_gather_plan_rows_refuses_a_wider_span_as_jax():
    p = planned("roomy")
    width = p["options"].width
    with pytest.raises(ValueError, match="exactly the pileup window") as info:
        pileup_device.gather_plan_rows(p["tensors"], p["plans"][1], width)
    with pytest.raises(ValueError) as jax_info:
        pileup_jax.gather_plan_rows(p["jax_tensors"], p["jax_plans"][1],
                                    width)
    assert str(info.value) == str(jax_info.value)


@pytest.mark.parametrize("case,colors", [
    ("roomy", {}), ("crowded", ODD_COLORS), ("sorted", {}),
    ("polishing", {})])
def test_encode_region_candidates_matches_jax(case, colors):
    """Host prep and the device encoder end to end, the windows of the
    first and last candidate hanging off the span's reads."""
    kw, n_reads = PLANNER_CASES[case]
    kw = dict(kw, **colors)
    reference, (jax_batch, jax_calls, combos), (batch, calls, _) = \
        both_regions(5, n_reads)
    options = pileup.PileupOptions(**kw)

    def ref_query(variant):
        return reference_window(reference, options, variant)

    want = pileup_jax.encode_region_candidates(
        jax_pileup.PileupEncoder(jax_pileup.PileupOptions(**kw)),
        jax_calls, combos, jax_batch, ref_query)
    got = pileup_device.encode_region_candidates(
        pileup.PileupEncoder(options), calls, combos, batch, ref_query,
        device="cpu")
    assert got.dtype == np.uint8 and got.shape == want.shape == (
        4, options.height, options.width, len(options.channels))
    np.testing.assert_array_equal(got, want)
    assert got[:, options.reference_band_height:].any()


def test_empty_inputs_match_jax():
    options = pileup.PileupOptions(channels=(1, 2, 7), width=33,
                                   alt_aligned_pileup="diff_channels")
    encoder = pileup.PileupEncoder(options)
    assert pileup_device.encode_region_candidates(
        encoder, [], [], bam.ReadBatch(["chr1"]), None,
        device="cpu").shape == (0, 100, 33, 3)

    class Holder:
        pass

    holder = Holder()
    holder.encoder = encoder
    assert pileup_device.encode_longread_examples(
        holder, [], device="cpu").shape == (0, 100, 33, 5)


def test_encode_longread_examples_matches_jax():
    """Plans made by the port's planners, with alt tensors made from a
    second planned candidate, through both packages' batch encoders."""
    kw = dict(channels=(1, 2, 3, 4, 5, 6, 7, 26), width=99, height=50,
              alt_aligned_pileup="diff_channels", sort_by_haplotypes=True)
    reference, (jax_batch, jax_calls, combos), (batch, calls, _) = \
        both_regions(6, 120)
    options = pileup.PileupOptions(**kw)
    encoder = pileup.PileupEncoder(options)

    def rows_of(call, combo):
        start = call.variant.start - options.half_width
        tensors = pileup_device.build_region_tensors(
            encoder, batch, start, start + options.width)
        window = reference_window(reference, options, call.variant)
        plan = pileup_device.plan_candidate(encoder, tensors, call, batch,
                                            combo, window)
        rows = pileup_device.gather_plan_rows(tensors, plan, options.width)
        rows["ref_window"] = window
        return rows

    gathered = [rows_of(call, combo) for call, combo in zip(calls, combos)]
    planned_examples = []
    for i, rows in enumerate(gathered):
        other = gathered[(i + 1) % len(gathered)]
        rows = dict(rows)
        rows["alt_bases"] = np.stack([other["bases"], rows["bases"]])
        rows["alt_row_valid"] = np.stack([other["row_valid"],
                                          rows["row_valid"]])
        rows["alt_ref"] = np.stack([other["ref_window"], rows["ref_window"]])
        rows["alt_present"] = np.array([i % 2 == 0, i < 2])
        planned_examples.append(rows)

    class Holder:
        pass

    holder, jax_holder = Holder(), Holder()
    holder.encoder = encoder
    jax_holder.encoder = jax_pileup.PileupEncoder(
        jax_pileup.PileupOptions(**kw))
    want = pileup_jax.encode_longread_examples(jax_holder, planned_examples)
    got = pileup_device.encode_longread_examples(holder, planned_examples,
                                                 device="cpu")
    assert got.shape == want.shape == (4, 50, 99, 10)
    np.testing.assert_array_equal(got, want)
    assert got[..., 8:].any()


def test_entry_points_default_to_the_card():
    """Without a card the encoders raise; they do not run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = planned("roomy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pileup_device.encode_region_candidates(
            p["encoder"], p["calls"], p["combos"], p["batch"],
            lambda variant: None)

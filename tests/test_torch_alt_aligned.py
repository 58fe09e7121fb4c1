"""Alt-aligned pileups of the port against the JAX package:
`make_examples.alt_aligned` (read trimming, alt haplotypes, reads
force-aligned to a haplotype), `ExamplesBuilder.prepare_candidate_batch`
and `iter_alt_batches`, and the `diff_channels` branch of
`pileup_device.plan_longread_example`, on reads decoded from the shared
synthetic BAMs (150-base pairs, and the long-read sample).

Everything is exact: reads field by field, plans bit for bit, and the
images the CPU paints from the port's plans equal the JAX package's
`encode_longread_examples` on its own plans.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepvariant_tpu.make_examples import alt_aligned as jaa
from deepvariant_tpu.make_examples import core as jcore
from deepvariant_tpu.make_examples import pileup_jax
from deepvariant_tpu.core import types as jt
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.make_examples import alt_aligned as taa
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.make_examples import pileup_device
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    assert_batches_equal,
    assert_calls_equal,
    assert_planned_equal,
    assert_reads_equal,
    make_reads,
    preset_options,
    region_reads,
    sparse_sample,
    to_package,
    write_stage1_inputs,
)

torch.set_num_threads(2)

JAX, PORT = "deepvariant_tpu", "deepvariant_tpu_torch"
PLAN_MODULES = {JAX: pileup_jax, PORT: pileup_device}
CORES = {JAX: jcore, PORT: tcore}
TYPES = {JAX: jt, PORT: tt}


@pytest.fixture(scope="module")
def short_paths(tmp_path_factory):
    return write_stage1_inputs(sparse_sample(),
                               tmp_path_factory.mktemp("short"))


@pytest.fixture(scope="module")
def long_paths(tmp_path_factory):
    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    return write_stage1_inputs(sample, tmp_path_factory.mktemp("long"))


# -- trimming -----------------------------------------------------------------

def random_cigar(rng):
    """Units over every CIGAR op, clips only at the ends."""
    inner = [int(op) for op in rng.choice([1, 2, 3, 4, 7, 8, 9],
                                          rng.randint(1, 8))]
    units = [(op, int(rng.randint(1, 30))) for op in inner]
    if rng.rand() < 0.5:
        units.insert(0, (5, int(rng.randint(1, 10))))
    if rng.rand() < 0.5:
        units.append((5, int(rng.randint(1, 10))))
    if rng.rand() < 0.3:
        units.insert(0, (6, 4))
    if rng.rand() < 0.3:
        units.append((6, 7))
    return units


def test_trim_cigar_matches_jax():
    rng = np.random.RandomState(2)
    seen_ops = set()
    for _ in range(500):
        units = random_cigar(rng)
        seen_ops.update(op for op, _ in units)
        span = sum(n for op, n in units if op in (1, 3, 4, 8, 9))
        ref_start = int(rng.randint(0, span + 3))
        ref_length = int(rng.randint(0, span + 5))
        assert taa.trim_cigar(units, ref_start, ref_length) == \
            jaa.trim_cigar(units, ref_start, ref_length)
    assert seen_ops == {1, 2, 3, 4, 5, 6, 7, 8, 9}
    # Both edges inside one op, and a window past the read's end.
    assert taa.trim_cigar([(1, 50)], 10, 20) == ([(1, 20)], 10, 20)
    assert taa.trim_cigar([(5, 3), (1, 10), (2, 2), (1, 10)], 5, 100) == \
        ([(1, 5), (2, 2), (1, 10)], 8, 17)
    assert taa.DEFAULT_MIN_OVERLAP == jaa.DEFAULT_MIN_OVERLAP == 15


def test_trim_reads_matches_jax(short_paths, long_paths):
    """Reads of both samples trimmed to windows at a contig's start, its
    end and in its middle, with the default and a smaller overlap."""
    moved = 0
    for paths, region in ((short_paths, ("chr1", 1000, 2000)),
                          (long_paths, ("chr1", 0, 6000))):
        _, want_reads, _, _ = region_reads(JAX, paths, region)
        _, got_reads, _, _ = region_reads(PORT, paths, region)
        lo, hi = region[1], region[2]
        for start, end in ((lo, lo + 40), (lo + 400, lo + 621),
                           (hi - 60, hi), (lo + 500, lo + 510)):
            for overlap in (15, 1):
                want, want_idx = jaa.trim_reads(
                    want_reads, jt.Range("chr1", start, end), overlap)
                got, got_idx = taa.trim_reads(
                    got_reads, tt.Range("chr1", start, end), overlap)
                assert got_idx == want_idx
                assert_reads_equal(got, want)
                moved += sum(r.position == start for r in got)
                assert all(r.position >= start and r.end() <= end
                           for r in got)
    assert moved > 20
    read = make_reads(PORT, [("ACGTACGTAC", 100, "10M", 60, 30)])[0]
    with pytest.raises(AssertionError, match="overlap"):
        taa.trim_read(read, tt.Range("chr1", 50, 90))
    trimmed = taa.trim_read(read, tt.Range("chr1", 90, 104))
    assert (trimmed.position, trimmed.aligned_sequence, trimmed.cigar) == \
        (100, "ACGT", [(1, 4)])


# -- haplotypes ---------------------------------------------------------------

def test_haplotypes_and_alignment_regions_match_jax(short_paths):
    _, _, jref, _ = region_reads(JAX, short_paths, ("chr1", 0, 10))
    _, _, tref, _ = region_reads(PORT, short_paths, ("chr1", 0, 10))
    n = tref.contig_length("chr1")
    for start, ref_bases, alt in ((0, "A", "AGG"), (30, "ACG", "A"),
                                  (2000, "T", "TCATCAT"), (n - 2, "GC", "G"),
                                  (n - 1, "A", "C"), (n - 40, "A", "ATT")):
        for half in (110, 73, 5):
            want_v = jt.Variant(reference_name="chr1", start=start,
                                end=start + len(ref_bases),
                                reference_bases=ref_bases,
                                alternate_bases=[alt])
            got_v = to_package(want_v, PORT)
            want = jaa.create_haplotype(want_v, alt, half, jref.query, n)
            got = taa.create_haplotype(got_v, alt, half, tref.query, n)
            assert got == want
            assert dataclasses.astuple(
                taa.calculate_alignment_region(got_v, half, n)) == \
                dataclasses.astuple(
                    jaa.calculate_alignment_region(want_v, half, n))
            hap, ref_start, ref_end = got
            assert ref_start == max(0, start - half) and ref_end <= n
            assert alt in hap


@pytest.mark.parametrize("sample", ["short", "long"])
def test_realign_reads_to_haplotype_matches_jax(sample, short_paths,
                                                long_paths):
    """Trimmed reads force-aligned to an insertion and a deletion
    haplotype: unalignable reads come back empty, the others with their
    new position and CIGAR; the caller's options are left alone."""
    paths = short_paths if sample == "short" else long_paths
    region = ("chr1", 1000, 2000) if sample == "short" else ("chr1", 0, 6000)
    out = []
    for package, aa in ((JAX, jaa), (PORT, taa)):
        types = TYPES[package]
        _, reads, ref, _ = region_reads(package, paths, region)
        n = ref.contig_length("chr1")
        results = []
        for start, ref_bases, alt in ((1500, "", "GATTACA"), (1620, "x" * 6,
                                                              "")):
            anchor = ref.query(types.Range("chr1", start, start + 1))
            deleted = ref.query(types.Range("chr1", start + 1,
                                            start + 1 + len(ref_bases)))
            variant = types.Variant(
                reference_name="chr1", start=start,
                end=start + 1 + len(deleted),
                reference_bases=anchor + deleted,
                alternate_bases=[anchor + alt])
            window = aa.calculate_alignment_region(variant, 73, n)
            trimmed, _ = aa.trim_reads(reads, window)
            hap, ref_start, ref_end = aa.create_haplotype(
                variant, anchor + alt, 73, ref.query, n)
            options = __import__(f"{package}.realign.config",
                                 fromlist=["x"]).AlignerOptions()
            realigned = aa.realign_reads_to_haplotype(
                hap, trimmed, "chr1", ref_start, ref_end, ref.query, n,
                options)
            assert options.read_size == 250 and not options.force_alignment
            results.append((trimmed, realigned))
        out.append(results)
    for (want_in, want), (got_in, got) in zip(*out):
        assert_reads_equal(got_in, want_in)
        assert_reads_equal(got, want)
        assert len(got) == len(got_in) > 5
        assert any(r.aligned_sequence for r in got)
        assert any(len(r.cigar) > 1 for r in got if r.aligned_sequence)
    assert taa.realign_reads_to_haplotype(
        "ACGT" * 40, [], "chr1", 0, 160, None, 1000) == []


@pytest.mark.parametrize("mode", ["none", "diff_channels", "base_channels",
                                  "rows", "single_row"])
def test_compose_alt_aligned_matches_jax(mode):
    rng = np.random.RandomState(9)
    image = rng.randint(0, 255, (20, 31, 7)).astype(np.uint8)
    alts = [rng.randint(0, 255, (20, 31, 7)).astype(np.uint8)
            for _ in range(2)]
    for alt_images in ([alts[0], alts[1]], [alts[0], None], [None, alts[1]],
                       [None, None], [alts[0]]):
        for combo in (["AC"], ["A", "ACGT"], ["ACGT", "A"]):
            np.testing.assert_array_equal(
                taa.compose_alt_aligned(image, alt_images, mode, combo),
                jaa.compose_alt_aligned(image, alt_images, mode, combo))
    assert taa.ALT_CHANNEL_INDEX == jaa.ALT_CHANNEL_INDEX
    with pytest.raises(ValueError, match="unknown alt_aligned_pileup"):
        taa.compose_alt_aligned(image, alts, "columns", ["A"])


# -- ExamplesBuilder and the planner -----------------------------------------

def candidates_of(package, paths, region, model_type="WGS", pileup=None,
                  **overrides):
    """(processor, batch, candidates) of one package over one region."""
    options = preset_options(package, paths, model_type, **overrides)
    for key, value in (pileup or {}).items():
        setattr(options.pileup_options, key, value)
    processor = CORES[package].RegionProcessor(options)
    rng = TYPES[package].Range(*region)
    batch = processor.realign_region_reads(processor.region_reads(rng), rng)
    candidates, _, _ = processor.candidates_in_region(rng, batch, False)
    return processor, batch, candidates


DIFF = dict(alt_aligned_pileup="diff_channels")


@pytest.mark.parametrize("case", [
    ("short", ("chr1", 1000, 2000), "WGS",
     dict(DIFF, types_to_alt_align="all"), dict()),
    ("short", ("chr2", 0, 1000), "WGS", dict(),
     dict(trim_reads_for_pileup=True)),
    ("long", ("chr1", 0, 6000), "PACBIO", dict(),
     dict(phase_reads=False, parse_sam_aux_fields=True,
          aux_fields_to_keep=["HP"])),
], ids=["short-diff-all", "short-trim-only", "long-pacbio"])
def test_prepare_candidate_batch_and_alt_batches_match_jax(
        case, short_paths, long_paths):
    sample, region, model_type, pileup, overrides = case
    paths = short_paths if sample == "short" else long_paths
    out = []
    for package in (JAX, PORT):
        processor, batch, candidates = candidates_of(
            package, paths, region, model_type, pileup, **overrides)
        builder = processor.examples_builder
        rows = []
        for call in candidates:
            prepared = builder.prepare_candidate_batch(call, batch)
            items = []
            if builder.need_alt_alignment(call.variant):
                combo = list(call.variant.alternate_bases)[:2]
                items = list(builder.iter_alt_batches(
                    prepared[0], prepared[1], combo,
                    sort_positions=prepared[3]))
            rows.append((call, prepared, items))
        out.append(rows)
    want_rows, got_rows = out
    assert len(got_rows) == len(want_rows) >= 2
    n_items = n_trimmed = 0
    for (want_call, want, want_items), (got_call, got, got_items) in zip(
            want_rows, got_rows):
        assert_calls_equal([got[0]], [want[0]])
        assert_batches_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert (got[3] is None) == (want[3] is None)
        if got[3] is not None:      # trimmed: the original positions
            n_trimmed += 1
            assert got[3].dtype == np.int64
            np.testing.assert_array_equal(got[3], want[3])
        assert len(got_items) == len(want_items)
        for g, w in zip(got_items, want_items):
            assert (g is None) == (w is None)
            if g is None:
                continue
            n_items += 1
            assert_calls_equal([g[0]], [w[0]])
            assert_batches_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_array_equal(g[3], w[3])
    assert n_trimmed > 0
    assert n_items > 0 or not pileup and model_type == "WGS"


def plans_of(package, paths, region, model_type, pileup, extra_calls=(),
             **overrides):
    processor, batch, candidates = candidates_of(
        package, paths, region, model_type, pileup, **overrides)
    calls = list(candidates) + [to_package(c, package) for c in extra_calls]
    builder = processor.examples_builder
    module = PLAN_MODULES[package]
    plans = []
    for call in calls:
        alts = list(call.variant.alternate_bases)
        combos = [[a] for a in alts] + ([alts[:2], alts[1::-1]]
                                        if len(alts) > 1 else [])
        for combo in combos:
            plan = module.plan_longread_example(builder, call, batch, combo)
            if plan is not None:
                plans.append(plan)
    return builder, plans


def edge_calls(paths):
    """Hand-made candidates 20 bases into chr1, where a haplotype is
    shorter than the 99-column window unless its alt is long: alt_present
    (False, True) when only the second alt is long enough, both True by
    the alt2-falls-back-to-alt1 rule when only the first is, both False
    when neither is. Supported by whatever reads start there."""
    from deepvariant_tpu_torch.io import fasta
    from deepvariant_tpu_torch.make_examples.variant_caller import (
        DeepVariantCall,
    )

    ref = fasta.FastaReader(paths["ref"])
    base = ref.query(tt.Range("chr1", 20, 21))
    long_alt = base + "GATTACAGGCTTAACCGGTTAGCATCGATCGGAT"
    calls = []
    for alts in ([base + "C", long_alt], [long_alt, base + "C"],
                 [base + "C", base + "GG"]):
        calls.append(DeepVariantCall(
            variant=tt.Variant(reference_name="chr1", start=20, end=21,
                               reference_bases=base, alternate_bases=alts),
            allele_support={alts[0]: [0, 2, 3], alts[1]: [1, 4]},
            ref_support=[5, 6]))
    return calls


@pytest.mark.parametrize("case", [
    ("short", ("chr1", 0, 1000), "WGS",
     dict(DIFF, types_to_alt_align="all", width=99, height=40), True, dict()),
    ("short", ("chr1", 0, 4000), "WGS",
     dict(DIFF, width=99, height=40), False, dict()),
    ("long", ("chr1", 0, 6000), "PACBIO", dict(width=99, height=40), False,
     dict(phase_reads=False, parse_sam_aux_fields=True,
          aux_fields_to_keep=["HP"])),
], ids=["short-all-types-contig-start", "short-indels", "long-pacbio"])
def test_diff_channel_plans_and_images_match_jax(case, short_paths,
                                                 long_paths):
    sample, region, model_type, pileup, edges, overrides = case
    paths = short_paths if sample == "short" else long_paths
    extra = edge_calls(paths) if edges else ()
    jbuilder, want = plans_of(JAX, paths, region, model_type, pileup, extra,
                              **overrides)
    builder, got = plans_of(PORT, paths, region, model_type, pileup, extra,
                            **overrides)
    assert len(got) == len(want) >= 4
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and \
                g[key].shape == w[key].shape, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    present = {tuple(bool(x) for x in p["alt_present"]) for p in got}
    if edges:
        # (True, False) cannot leave the planner: alt2 falls back to alt1.
        assert present == {(True, True), (False, True), (False, False)}
    elif sample == "short":
        assert present == {(True, True), (False, False)}   # indels, SNPs
    else:
        assert (True, True) in present
        assert {int(v) for p in got for v in np.unique(p["hp"])} >= {1, 2}
    assert any(p["alt_row_valid"].any() for p in got)
    want_images = pileup_jax.encode_longread_examples(jbuilder, want)
    got_images = pileup_device.encode_longread_examples(builder, got,
                                                        device="cpu")
    channels = len(builder.pileup_options.channels) + 2
    assert got_images.shape == want_images.shape == (len(got), 40, 99,
                                                     channels)
    np.testing.assert_array_equal(got_images, want_images)
    assert got_images[..., -2:].any()


# -- the runner ---------------------------------------------------------------

def run(package, paths, model_type="WGS", pileup=None, **overrides):
    options = preset_options(package, paths, model_type, **overrides)
    for key, value in (pileup or {}).items():
        setattr(options.pileup_options, key, value)
    plans = []
    counts = CORES[package].make_examples_runner(options,
                                                 plan_sink=plans.append)
    return counts, plans, options


RUNS = {
    "wgs-trim-reads": ("short", "WGS", None,
                       dict(trim_reads_for_pileup=True)),
    "wgs-diff-channels": ("short", "WGS", dict(DIFF), dict(regions=["chr1"])),
    "pacbio-no-phasing": ("long", "PACBIO", None, dict(
        phase_reads=False, parse_sam_aux_fields=True,
        aux_fields_to_keep=["HP"])),
    "ont-no-phasing": ("long", "ONT_R104", None, dict(
        phase_reads=False, regions=["chr2"])),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_runner_with_trimmed_and_alt_aligned_pileups_matches_jax(
        name, short_paths, long_paths):
    sample, model_type, pileup, overrides = RUNS[name]
    paths = short_paths if sample == "short" else long_paths
    want_counts, want, want_options = run(JAX, paths, model_type, pileup,
                                          **overrides)
    counts, got, options = run(PORT, paths, model_type, pileup, **overrides)
    assert counts == want_counts and len(got) >= 5
    assert_planned_equal(got, want)
    assert repr(options) == repr(want_options).replace(JAX + ".", PORT + ".")
    diff = options.pileup_options.alt_aligned_pileup == "diff_channels"
    assert any(p.plan["alt_present"].any() for p in got) == diff
    if name == "wgs-trim-reads":
        # Trimming changes what the rows hold.
        _, untrimmed, _ = run(PORT, paths, model_type)
        assert len(untrimmed) == len(got)
        assert any(not np.array_equal(a.plan["bases"], b.plan["bases"])
                   for a, b in zip(untrimmed, got))
    if sample == "long":
        assert got[0].plan["bases"].shape == (95, 147)


@pytest.mark.parametrize("mode", ["base_channels", "rows", "single_row"])
def test_host_composed_alt_modes_still_raise(short_paths, mode):
    """The alt modes that join whole host-painted alt images are ported:
    with the WGS defaults (realigner on) and indels aligned to their alt
    haplotypes, a region's examples are the JAX processor's, byte for
    byte. Neither package paints them from plans."""
    outputs = []
    for package in (JAX, PORT):
        options = preset_options(package, short_paths)
        options.pileup_options.alt_aligned_pileup = mode
        processor = CORES[package].RegionProcessor(options)
        assert not processor.examples_builder.supports_device_encode()
        outputs.append(processor.process(TYPES[package].Range(
            "chr1", 0, 4000)))
    want, got = outputs
    assert got.examples == want.examples and len(got.examples) >= 8
    assert any(len(c.variant.reference_bases) > 1 or any(
        len(a) > 1 for a in c.variant.alternate_bases)
        for c in got.candidates)
    shape = CORES[PORT].RegionProcessor(options).examples_builder \
        .example_shape()
    assert shape == {"base_channels": (100, 221, 9), "rows": (300, 221, 7),
                     "single_row": (200, 221, 7)}[mode]


@pytest.mark.parametrize("preset", ["PACBIO", "MASSEQ", "ONT_R104"])
def test_long_read_presets_need_only_direct_phasing(long_paths, preset):
    """A long-read preset needed direct phasing and nothing else: with it
    ported, the preset is accepted with its defaults (phase_reads on),
    and with methylation-aware phasing; the small model's gate is
    ported too and takes the preset's phased reads (its rows carry the
    haplotype copies), while its training rows with phase_reads, which
    crash the JAX package, raise, naming their Queue 3 entry."""
    options = preset_options(PORT, long_paths, preset)
    assert options.phase_reads
    tcore.RegionProcessor(options)
    options.enable_methylation_aware_phasing = True
    tcore.RegionProcessor(options)
    options.call_small_model_examples = True
    processor = tcore.RegionProcessor(options)
    assert processor.small_model_factory.expand_by_haplotype
    options.write_small_model_examples = True
    with pytest.raises(NotImplementedError) as raised:
        tcore.RegionProcessor(options)
    assert "phase_reads" in str(raised.value)
    assert "alt_aligned" not in str(raised.value)

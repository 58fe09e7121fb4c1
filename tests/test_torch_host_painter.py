"""The port's host painter (`PileupEncoder.build_pileup` and its per-read
`encode_read_row`) against the JAX package's, on seeded synthetic reads
and candidates, and against the port's plan-form painter on candidates
from files.

Tolerance: none. The images are uint8 and must be equal bit for bit.

The JAX package paints with its native library loaded (its C++ batch
painter `dv_encode_rows` where every channel is one it models, the
per-row numpy painter otherwise) and again with the library switched
off (`has_encode_rows` and `has_shuffle` patched to False): the port
copies the per-row branch and the native crowded-window shuffle
(libc++ std::shuffle over mt19937_64, `make_examples/shuffle.py`). The
two JAX paths differ where a crowded window is shuffled uniformly: its
fallback draws a numpy Philox permutation there, and the port follows
the native library (pinned below, ROADMAP.md Queue 3).
"""

import numpy as np
import pytest
import torch

from deepvariant_tpu.io import native as jax_native
from deepvariant_tpu.make_examples import pileup as jpileup
from deepvariant_tpu_torch.make_examples import core as tcore
from deepvariant_tpu_torch.make_examples import pileup as tpileup
from deepvariant_tpu_torch.make_examples import pileup_device
from deepvariant_tpu_torch.make_examples.pileup_device import (
    ALT_KEYS,
    PLAN_KEYS,
    make_longread_encode_fn,
)
from deepvariant_tpu_torch.core import types as tt
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.testing import synthetic
from torch_port_util import (
    ODD_COLORS,
    build_region,
    make_reads,
    preset_options,
    reference_window,
    stage1_sample,
    synthetic_region,
    wgs_options,
    write_stage1_inputs,
)

torch.set_num_threads(2)

PORT = "deepvariant_tpu_torch"
NON_AUX = tuple(sorted(ch for ch in tpileup.CHANNEL_NAME_TO_ENUM.values()
                       if ch not in tpileup.AUX_CHANNELS))


def test_constants_match_jax():
    assert tpileup.CHANNEL_NAME_TO_ENUM == jpileup.CHANNEL_NAME_TO_ENUM
    assert tpileup.PER_READ_CONST_CHANNELS == jpileup.PER_READ_CONST_CHANNELS
    assert set(NON_AUX) | tpileup.AUX_CHANNELS == \
        set(jpileup.CHANNEL_NAME_TO_ENUM.values())
    assert len(NON_AUX) == 21


def regions(seed, n_reads):
    """(reference, JAX (batch, calls, combos), port (batch, calls,
    combos)) of one seeded region. Each call gets reference supporters
    and an ALT_PS phase per alt, which the fuzzy-support and
    allele-sample-probability channels read."""
    reference, reads, candidates = synthetic_region(seed, n_reads)
    rng = np.random.RandomState(seed + 1)
    ref_support, alt_ps = [], []
    for c in candidates:
        taken = {r for ids in c["allele_support"].values() for r in ids}
        free = [r for r in range(n_reads) if r not in taken]
        ref_support.append(sorted(rng.choice(free, len(free) // 3,
                                             replace=False).tolist()))
        alt_ps.append([0] + rng.randint(0, 3, len(c["alts"])).tolist())
    out = [reference]
    for package in ("deepvariant_tpu", PORT):
        batch, calls, combos = build_region(package, reads, candidates)
        for call, refs, ps in zip(calls, ref_support, alt_ps):
            call.ref_support = list(refs)
            call.variant.info["ALT_PS"] = list(ps)
        out.append((batch, calls, combos))
    return out


def paint(module, region, reference, **fields):
    batch, calls, combos = region
    options = module.PileupOptions(**fields)
    encoder = module.PileupEncoder(options)
    images = []
    for call, combo in zip(calls, combos):
        window = reference_window(reference, options, call.variant)
        indices = module.reads_overlapping_variant(
            batch, call.variant, options.read_overlap_buffer_bp)
        images.append(encoder.build_pileup(call, window, batch, indices,
                                           combo))
    return np.stack(images)


MIXED = [tuple(np.random.RandomState(seed).choice(NON_AUX, size))
         for seed, size in ((1, 5), (2, 9), (3, 12), (4, 21))]

# name -> (PileupOptions fields, reads in the region). A crowded window
# (fewer rows than reads) is shuffled; with use_non_uniform_downsampling
# the per-allele minimums are drawn first, and when they do not fit
# (threshold 40 at 2 rows) the uniform shuffle runs after all.
CASES = {
    **{f"channel-{ch}": (dict(channels=(ch,), width=99, height=60), 80)
       for ch in NON_AUX},
    **{f"mixed-{i}": (dict(channels=channels, width=77, height=50), 120)
       for i, channels in enumerate(MIXED)},
    "odd-colors": (dict(ODD_COLORS, channels=NON_AUX, width=99, height=60),
                   80),
    "sorted": (dict(channels=NON_AUX, width=77, height=50,
                    sort_by_haplotypes=True, sort_by_alt_allele_support=True,
                    reverse_haplotypes=True), 120),
    "other-alt-color": (dict(channels=NON_AUX, width=77, height=50,
                             other_allele_supporting_read_alpha=0.3), 120),
    "crowded": (dict(channels=NON_AUX, width=99, height=30), 240),
    "crowded-non-uniform": (dict(channels=NON_AUX, width=99, height=30,
                                 use_non_uniform_downsampling=True), 240),
    "crowded-non-uniform-unfit": (
        dict(channels=NON_AUX, width=99, height=7,
             use_non_uniform_downsampling=True,
             non_uniform_downsampling_threshold=40), 240),
    "mean-coverage": (dict(channels=(1, 22, 2, 22), width=77, height=50,
                           mean_coverage=33.7), 80),
    "mean-coverage-past-the-rows": (dict(channels=(22, 6), width=77,
                                         height=40, mean_coverage=500.0), 80),
    "reads-that-bail": (dict(channels=NON_AUX, width=99, height=60,
                             min_mapping_quality=40, min_base_quality=35),
                        80),
    "wgs": (dict(), 120),
}
# The cases where the JAX package with its native library switched off
# shuffles with numpy's Philox instead of libc++'s std::shuffle.
PHILOX_DIFFERS = {"crowded", "crowded-non-uniform-unfit"}


@pytest.mark.parametrize("natives", ["loaded", "off"])
@pytest.mark.parametrize("name", list(CASES))
def test_build_pileup_is_bit_exact_vs_jax(name, natives, monkeypatch):
    fields, n_reads = CASES[name]
    reference, jregion, tregion = regions(17, n_reads)
    if natives == "off":
        monkeypatch.setattr(jax_native, "has_encode_rows", lambda: False)
        monkeypatch.setattr(jax_native, "has_shuffle", lambda: False)
    want = paint(jpileup, jregion, reference, **fields)
    got = paint(tpileup, tregion, reference, **fields)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    if natives == "off" and name in PHILOX_DIFFERS:
        # Pinned: the JAX package's Python fallback reads another
        # crowded-window sample than its native library, which the port
        # follows (see test below).
        assert not np.array_equal(got, want)
        return
    np.testing.assert_array_equal(got, want)
    # The blank channel alone paints nothing.
    assert got[:, 5:].any() == (fields.get("channels") != (18,))


def test_crowded_windows_follow_the_native_shuffle():
    """The port's crowded-window sample is libc++'s std::shuffle over
    mt19937_64 (the native library's), on the JAX package's own reads:
    its `native.shuffle_indices` and the port's shuffle give one order."""
    from deepvariant_tpu_torch.make_examples.shuffle import shuffle_indices

    for n in (96, 240, 1000):
        assert list(shuffle_indices(n, 2101079370)) == list(
            jax_native.shuffle_indices(n, 2101079370))


def test_encode_read_row_matches_jax_read_by_read():
    """Every read of the region through `encode_read_row`, bailing reads
    (None) included, with every non-aux channel."""
    reference, jregion, tregion = regions(23, 80)
    fields = dict(channels=NON_AUX, width=99, height=60,
                  min_mapping_quality=20, min_base_quality=20)
    bailed = painted = 0
    (jbatch, jcalls, _), (tbatch, tcalls, combos) = jregion, tregion
    jenc = jpileup.PileupEncoder(jpileup.PileupOptions(**fields))
    tenc = tpileup.PileupEncoder(tpileup.PileupOptions(**fields))
    for jcall, tcall, combo in zip(jcalls, tcalls, combos):
        window = reference_window(reference, tenc.options, tcall.variant)
        start = tcall.variant.start - tenc.options.half_width
        for idx in range(len(tbatch)):
            args = (window, start, tcall.variant.start,
                    tenc._read_supports_alt(tcall, idx, combo), 0.31)
            want = jenc.encode_read_row(jbatch, idx, *args,
                                        dv_call=jcall, alt_alleles=combo)
            got = tenc.encode_read_row(tbatch, idx, *args,
                                       dv_call=tcall, alt_alleles=combo)
            if want is None:
                assert got is None
                bailed += 1
                continue
            np.testing.assert_array_equal(got, want)
            painted += 1
    assert bailed > 20 and painted > 20


def test_a_leading_insertion_paints_its_anchor_as_the_host_painter_does():
    """A read whose first aligned op is an insertion anchors it one base
    left of its start; the host painter paints that column. The port's
    planner keeps it too, so the plan form's image equals the host image;
    the JAX package's planner walks from the read's start and drops it
    (ROADMAP.md Queue 3), so its device image differs there."""
    from importlib import import_module

    from deepvariant_tpu.make_examples import pileup_jax

    rng = np.random.RandomState(3)
    reference = np.frombuffer(b"ACGT", np.uint8)[rng.randint(0, 4, 400)]
    ref = reference.tobytes().decode()
    specs = [(ref[150:200] + "TTGCA" + ref[200:260], 150, "50M5I60M", 40,
              30),
             ("GGATC" + ref[200:260], 200, "5I60M", 40, 30),
             ("AAC" + "GTTA" + ref[200:250], 200, "3S4I50M", 50, 25),
             (ref[180:280], 180, "100M", 60, 35)]
    images = {}
    for package, module, encode in (
            ("deepvariant_tpu", jpileup, pileup_jax),
            (PORT, tpileup, pileup_device)):
        bam = import_module(f"{package}.io.bam")
        types = import_module(f"{package}.core.types")
        caller = import_module(f"{package}.make_examples.variant_caller")
        batch = bam.ReadBatch.from_reads(make_reads(package, specs),
                                         ["chr1"])
        calls = [caller.DeepVariantCall(variant=types.Variant(
            reference_name="chr1", start=start, end=start + 1,
            reference_bases=ref[start], alternate_bases=["A" if
                                                         ref[start] != "A"
                                                         else "C"]),
            allele_support={}) for start in (199, 230)]
        combos = [list(c.variant.alternate_bases) for c in calls]
        options = module.PileupOptions(width=77, height=30)
        encoder = module.PileupEncoder(options)

        def window(variant, options=options):
            return reference_window(reference, options, variant)

        host = np.stack([encoder.build_pileup(
            c, window(c.variant), batch,
            module.reads_overlapping_variant(batch, c.variant), combo)
            for c, combo in zip(calls, combos)])
        kwargs = {"device": "cpu"} if package == PORT else {}
        images[package] = host, np.asarray(encode.encode_region_candidates(
            encoder, calls, combos, batch, window, **kwargs))
    (jax_host, jax_plan), (host, plan) = images.values()
    np.testing.assert_array_equal(host, jax_host)
    np.testing.assert_array_equal(plan, host)
    assert not np.array_equal(jax_plan, jax_host)
    # The anchors sit in the first candidate's call column.
    call_col = 38
    assert (host[0, 5:, call_col, 1] != 0).sum() == 4


# -- the host image against the card's plan form ------------------------------

@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    directory = tmp_path_factory.mktemp("host_painter")
    sample = stage1_sample()
    paths = write_stage1_inputs(sample, directory)
    paths.update(synthetic.write_vcf_inputs(sample, str(directory),
                                            population=True))
    return paths


@pytest.fixture(scope="module")
def long_paths(tmp_path_factory):
    sample = synthetic.synthetic_longread_sample(
        5, (("chr1", 6000), ("chr2", 3000)), depth=12, mean_read_length=2000)
    return write_stage1_inputs(sample, tmp_path_factory.mktemp("long"))


def plan_form_images(options, plans):
    """The plan form's plain version on stacked plans, on the CPU."""
    o = options.pileup_options
    keys = PLAN_KEYS + (ALT_KEYS if o.alt_aligned_pileup == "diff_channels"
                        else ())
    stacked = [torch.from_numpy(np.stack([np.asarray(p.plan[k])
                                          for p in plans])) for k in keys]
    return make_longread_encode_fn(o)(*stacked).numpy()


DEVICE_SETS = {
    "wgs": ("short", ("chr1", 1000, 2500), lambda p: wgs_options(PORT, p)),
    "wgs-allele-frequency": (
        "short", ("chr1", 4000, 5500),
        lambda p: wgs_options(PORT, p,
                              population_vcf_filenames=[p["population"]])),
    "pacbio-diff-channels": (
        "long", ("chr1", 2000, 3500),
        lambda p: preset_options(PORT, p, "PACBIO")),
}


@pytest.mark.parametrize("name", list(DEVICE_SETS))
def test_host_images_equal_the_plan_form(name, paths, long_paths):
    """For the channel sets the plan painter paints, the host painter's
    image of each example equals the plan form's (its plain version, the
    one the CUDA kernel is held to) on the same candidate's plan."""
    sample, region, make = DEVICE_SETS[name]
    files = paths if sample == "short" else long_paths
    outputs = []
    for plan_mode in (False, True):
        options = make(files)
        if name == "wgs-allele-frequency":
            options.pileup_options.channels = tuple(
                options.pileup_options.channels) + (
                    tpileup.CH_ALLELE_FREQUENCY,)
        processor = tcore.RegionProcessor(options)
        processor.plan_mode = plan_mode
        outputs.append(processor.process(tt.Range(*region)))
    examples, plans = outputs[0].examples, outputs[1].plans
    assert len(examples) == len(plans) >= 4
    host = np.stack([example_codec.parse_example(e).image for e in examples])
    for e, p in zip(examples, plans):
        ex = example_codec.parse_example(e)
        assert ex.variant.encode() == p.variant.encode()
        assert ex.alt_allele_indices == p.alt_indices
    card = plan_form_images(options, plans)
    assert host.shape == card.shape
    np.testing.assert_array_equal(host, card)
    if name == "wgs-allele-frequency":
        assert host[..., -1].any()
    if name == "pacbio-diff-channels":
        assert host.shape[-1] == 10 and host[..., -2:].any()
        assert pileup_device.DEVICE_CHANNELS >= set(
            options.pileup_options.channels)

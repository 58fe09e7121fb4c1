"""The port's device encoders against the JAX package's.

`deepvariant_tpu_torch.make_examples.pileup_device.make_longread_encode_fn`
and `make_encode_fn` must give images bit-identical (tolerance 0 on
uint8) to `deepvariant_tpu.make_examples.pileup_jax`'s on the same
inputs, for every ordered list of DEVICE_CHANNELS, with and without the
diff planes, and for non-default colors and caps."""

import dataclasses

import numpy as np
import pytest
import torch

from deepvariant_tpu.make_examples import pileup as jax_pileup
from deepvariant_tpu.make_examples import pileup_jax
from deepvariant_tpu.make_examples import presets as jax_presets
from deepvariant_tpu.make_examples.core import MakeExamplesOptions
from deepvariant_tpu_torch.make_examples import pileup, pileup_device, presets
from deepvariant_tpu_torch.make_examples.pileup_device import (
    ALT_KEYS,
    PLAN_KEYS,
    make_encode_fn,
    make_longread_encode_fn,
)
from torch_port_util import (
    ODD_COLORS,
    edge_hp,
    edge_plans,
    jax_images,
    random_plans,
    with_alt,
)

torch.set_num_threads(2)

CHANNELS = sorted(pileup_device.DEVICE_CHANNELS)


def port_images(plans, options):
    encode = make_longread_encode_fn(options)
    keys = PLAN_KEYS + (ALT_KEYS if "alt_bases" in plans else ())
    return encode(*[torch.from_numpy(plans[k]) for k in keys]).numpy()


def test_constants_match_jax():
    assert pileup.WGS_CHANNELS == jax_pileup.WGS_CHANNELS
    assert pileup.DEFAULT_CHANNELS == jax_pileup.DEFAULT_CHANNELS
    assert pileup.MAX_PIXEL_FLOAT == jax_pileup.MAX_PIXEL_FLOAT
    assert pileup.CH_SUPPLEMENTARY_ALIGNMENT == \
        jax_pileup.CH_SUPPLEMENTARY_ALIGNMENT == 26
    assert pileup_device.DEVICE_CHANNELS == pileup_jax.DEVICE_CHANNELS
    assert dataclasses.asdict(pileup.PileupOptions()) == \
        dataclasses.asdict(jax_pileup.PileupOptions())
    np.testing.assert_array_equal(
        pileup.base_color_lut(pileup.PileupOptions(**ODD_COLORS)),
        jax_pileup._base_color_lut(jax_pileup.PileupOptions(**ODD_COLORS)))


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 5)])
def test_wgs_painter_bit_exact_vs_jax(seed, n):
    plans = edge_plans(random_plans(n, seed))
    plans["mapq"][0, :3] = [60, 61, 255]
    want = jax_images(plans, jax_pileup.PileupOptions())
    got = port_images(plans, pileup.PileupOptions())
    assert got.shape == want.shape == (n, 100, 221, 7)
    np.testing.assert_array_equal(got, want)


def test_options_outside_the_kernel_follow_jax():
    """The mapq, strand and support colors and the band height honour
    the options."""
    kw = dict(mapping_quality_cap=30, positive_strand_color=10,
              negative_strand_color=200, allele_supporting_read_alpha=0.5,
              reference_band_height=7)
    plans = random_plans(2, 7, rows=93)
    want = jax_images(plans, jax_pileup.PileupOptions(**kw))
    np.testing.assert_array_equal(
        port_images(plans, pileup.PileupOptions(**kw)), want)


def test_mapq_cap_scales_as_xla_compiles_it():
    """XLA turns the encoder's 254 * (min(v, cap) / cap) into a multiply
    by the folded constant 254 * (1 / cap): at cap 47 a mapq of 47 or
    more paints 253, not the IEEE quotient's 254."""
    kw = dict(mapping_quality_cap=47)
    plans = random_plans(2, 8)
    plans["bases"][0, 45] = ord("A")
    plans["mapq"][0] = np.arange(95) + 10
    plans["row_valid"][0] = True
    want = jax_images(plans, jax_pileup.PileupOptions(**kw))
    assert set(want[0, 5 + 45, :, 2]) == {253}
    np.testing.assert_array_equal(
        port_images(plans, pileup.PileupOptions(**kw)), want)


@pytest.mark.parametrize("model_type", presets.MODEL_TYPES)
def test_preset_painters_bit_exact_vs_jax(model_type):
    """Each model type's pileup options: the same fields as the JAX
    preset sets, and the same image."""
    options = presets.apply_pileup_preset(pileup.PileupOptions(), model_type)
    jax_options = jax_presets.apply_model_preset(
        MakeExamplesOptions(), model_type).pileup_options
    assert dataclasses.asdict(options) == dataclasses.asdict(jax_options)
    diff = options.alt_aligned_pileup == "diff_channels"
    plans = edge_hp(edge_plans(random_plans(
        4, 20, rows=options.max_reads, width=options.width)))
    if diff:
        with_alt(plans, 21)
    want = jax_images(plans, jax_options)
    got = port_images(plans, options)
    assert got.shape == want.shape == (
        4, options.height, options.width,
        len(options.channels) + (2 if diff else 0))
    np.testing.assert_array_equal(got, want)


def test_unknown_preset_raises_as_jax():
    with pytest.raises(ValueError, match="unknown model type"):
        presets.apply_pileup_preset(pileup.PileupOptions(), "NANOPORE_R9")
    with pytest.raises(ValueError, match="unknown model type"):
        jax_presets.apply_model_preset(MakeExamplesOptions(), "NANOPORE_R9")


def _channel_lists():
    """Seeded ordered subsets of DEVICE_CHANNELS of every length, some
    with a channel repeated, alternating diff mode and colors."""
    rng = np.random.RandomState(5)
    cases = []
    for k in range(1, 11):
        for variant in range(2):
            repeat = variant == 1 and k > 1
            channels = rng.choice(CHANNELS, k, replace=repeat).tolist()
            cases.append((tuple(channels), (k + variant) % 2 == 0,
                          (k + 2 * variant) % 3 == 0))
    return cases


@pytest.mark.parametrize(
    "channels,diff,odd_colors", _channel_lists(),
    ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_channel_subsets_bit_exact_vs_jax(channels, diff, odd_colors):
    kw = dict(channels=channels, width=33, height=27,
              reference_band_height=len(channels) % 6,
              alt_aligned_pileup="diff_channels" if diff else "none",
              **(ODD_COLORS if odd_colors else {}))
    rows = kw["height"] - kw["reference_band_height"]
    plans = with_alt(edge_hp(edge_plans(random_plans(
        5, len(channels), rows=rows, width=33))), 6)
    want = jax_images(plans, jax_pileup.PileupOptions(**kw))
    got = port_images(plans, pileup.PileupOptions(**kw))
    assert got.shape == want.shape == (5, 27, 33,
                                       len(channels) + (2 if diff else 0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(base_quality_cap=37), dict(base_quality_cap=93),
    dict(base_quality_cap=47, mapping_quality_cap=29),
    dict(mapping_quality_cap=51), dict(mapping_quality_cap=254),
    dict(reference_base_quality=20, base_quality_cap=33),
    dict(hp_tag_for_assembly_polishing=2),
    dict(hp_tag_for_assembly_polishing=1),
    dict(allele_unsupporting_read_alpha=1.0),
    ODD_COLORS,
], ids=["qcap37", "qcap93", "xla-folded-caps", "mcap51", "mcap254", "refq20", "polish2",
        "polish1", "unsupporting-1.0", "all"])
def test_color_options_and_caps_bit_exact_vs_jax(kw):
    """`scale` is 254 * (min(v, cap) / cap) as XLA compiles it, which
    at caps 47 and 29 (and 28 more) is not the IEEE quotient's byte; the
    supplementary band is int(alpha); the hp swap happens only for
    polishing tag 2."""
    kw = dict(kw, channels=tuple(CHANNELS), width=64, height=40,
              alt_aligned_pileup="diff_channels")
    plans = with_alt(edge_hp(edge_plans(random_plans(4, 30, rows=35,
                                                     width=64))), 31)
    plans["quals"][0, 0] = np.arange(64) * 4   # every fourth quality
    plans["mapq"][2, :35] = np.arange(35) * 7
    want = jax_images(plans, jax_pileup.PileupOptions(**kw))
    np.testing.assert_array_equal(
        port_images(plans, pileup.PileupOptions(**kw)), want)


def test_every_quality_and_mapq_value_scales_as_jax():
    """All 256 values of both scaled channels, at odd caps."""
    kw = dict(channels=(2, 3), width=256, height=3, reference_band_height=1,
              base_quality_cap=47, mapping_quality_cap=71)
    plans = random_plans(128, 40, rows=2, width=256)
    plans["bases"][:] = ord("A")
    plans["row_valid"][:] = True
    plans["quals"][:] = np.arange(256)
    plans["mapq"][:] = np.arange(256).reshape(128, 2)
    want = jax_images(plans, jax_pileup.PileupOptions(**kw))
    np.testing.assert_array_equal(
        port_images(plans, pileup.PileupOptions(**kw)), want)


def test_diff_planes_are_zero_where_the_alt_is_absent():
    """The whole diff plane, band included, is 0 where alt_present is
    false, and its band is the match color where it is true."""
    options = pileup.PileupOptions(
        channels=(1, 6), width=17, height=9, alt_aligned_pileup="diff_channels")
    plans = with_alt(random_plans(4, 50, rows=4, width=17), 51)
    got = port_images(plans, options)
    for n in range(4):
        for k in range(2):
            plane = got[n, :, :, 2 + k]
            if plans["alt_present"][n, k]:
                assert (plane[:5] == 50).all()
            else:
                assert not plane.any()
    np.testing.assert_array_equal(got, jax_images(
        plans, jax_pileup.PileupOptions(**dataclasses.asdict(options))))


def test_painter_ignores_alt_tensors_without_diff_mode():
    plans = random_plans(2, 60, rows=6, width=9)
    options = pileup.PileupOptions(width=9, height=11)
    without = port_images(plans, options)
    with_them = port_images(with_alt(dict(plans), 61), options)
    np.testing.assert_array_equal(without, with_them)


@pytest.mark.parametrize("kw,message", [
    (dict(channels=(1, 2, 11)), r"does not implement channel\(s\) \[11\]"),
    (dict(channels=(22, 1, 18)),
     r"does not implement channel\(s\) \[22, 18\]"),
    (dict(alt_aligned_pileup="rows"), "implements alt_aligned_pileup"),
    (dict(alt_aligned_pileup="base_channels"),
     "implements alt_aligned_pileup"),
], ids=["read_mapping_percent", "mean_coverage+blank", "rows",
        "base_channels"])
def test_unported_options_raise(kw, message):
    """Channels outside DEVICE_CHANNELS and other alt modes raise
    ValueError with the JAX factory's wording; everything else builds."""
    with pytest.raises(ValueError, match=message) as info:
        make_longread_encode_fn(pileup.PileupOptions(**kw))
    with pytest.raises(ValueError) as jax_info:
        pileup_jax.make_longread_encode_fn(jax_pileup.PileupOptions(**kw))
    assert str(info.value) == str(jax_info.value)


@pytest.mark.parametrize("kw", [
    dict(channels=tuple(pileup.DEFAULT_CHANNELS)),
    dict(channels=tuple(pileup.WGS_CHANNELS + [pileup.CH_HAPLOTYPE_TAG])),
    dict(alt_aligned_pileup="diff_channels"),
    dict(base_quality_cap=30),
    dict(alt_aligned_pileup=""),
], ids=["default6", "wgs+hp", "diff_channels", "qual-cap", "empty-alt-mode"])
def test_options_that_earlier_slices_refused_now_build(kw):
    options = pileup.PileupOptions(**kw)
    painter = make_longread_encode_fn(options)
    diff = options.alt_aligned_pileup == "diff_channels"
    assert painter.diff_mode == diff
    assert painter.colors.planes == len(options.channels) + (2 if diff else 0)


def test_region_encoder_refuses_unsupported_channels_as_jax():
    kw = dict(channels=(1, 13))
    with pytest.raises(ValueError) as info:
        make_encode_fn(pileup.PileupOptions(**kw))
    with pytest.raises(ValueError) as jax_info:
        pileup_jax.make_encode_fn(jax_pileup.PileupOptions(**kw))
    assert str(info.value) == str(jax_info.value)


def _region_inputs(seed, n, k, span, width, rows, offsets):
    """Random region tensors in make_encode_fn's argument order."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"ACGTN*", np.uint8)
    bases = alphabet[rng.randint(0, 6, (k, span))]
    bases[rng.rand(k, span) < 0.3] = 0
    row_reads = rng.randint(-1, k, (n, rows)).astype(np.int32)
    row_reads[0, :] = -1                      # a candidate of empty rows
    row_reads[1, rows // 2:] = -1
    return (
        bases,
        rng.randint(0, 256, (k, span)).astype(np.uint8),
        rng.randint(0, 256, k).astype(np.uint8),
        rng.rand(k) < 0.5,
        rng.randint(-2, 5, k).astype(np.int8),
        rng.randint(-3000, 3000, k).astype(np.int32),
        rng.rand(k) < 0.2,
        np.asarray(offsets, np.int32),
        row_reads,
        rng.randint(-3, 4, (n, k)).astype(np.int8),
        rng.randint(0, 256, (n, k)).astype(np.uint8),
        alphabet[rng.randint(0, 5, (n, width))],
    )


@pytest.mark.parametrize("channels,kw", [
    (tuple(pileup.WGS_CHANNELS), {}),
    (tuple(CHANNELS), {}),
    ((26, 8, 1, 7, 2, 19, 3), ODD_COLORS),
], ids=["wgs", "all-ten", "shuffled-odd-colors"])
def test_region_encoder_bit_exact_vs_jax(channels, kw):
    """Windows inside the span, hanging off its left and right ends
    (the edge column repeats), wholly outside it, and empty rows."""
    width, rows, span = 21, 9, 50
    offsets = [0, 29, -7, 40, -30, 70, 13]
    kw = dict(kw, channels=channels, width=width, height=rows + 4,
              reference_band_height=4)
    args = _region_inputs(70, len(offsets), 12, span, width, rows, offsets)
    want = np.asarray(pileup_jax.make_encode_fn(
        jax_pileup.PileupOptions(**kw))(*args))
    got = make_encode_fn(pileup.PileupOptions(**kw))(
        *[torch.from_numpy(a) for a in args]).numpy()
    assert got.shape == want.shape == (len(offsets), rows + 4, width,
                                       len(channels))
    np.testing.assert_array_equal(got, want)
    assert not got[0, 4:].any()               # the candidate of empty rows

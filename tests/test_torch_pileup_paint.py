"""The port's pileup paint (deepvariant_tpu_torch.ops.pileup_paint)
against the JAX package's Pallas kernel, its XLA twin and the long-read
encoder.

The rows form's plain version must be bit-exact against both
`_paint_xla` and `_paint_pileup(..., interpret=True)`; the plan form's
against `make_longread_encode_fn`. The CUDA kernel itself runs only on
the card and is held against the plain versions there by
chip_smoke.py."""

import ctypes
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepvariant_tpu.make_examples import pileup as jax_pileup
from deepvariant_tpu.ops import pileup_paint as jax_pp
from deepvariant_tpu_torch.make_examples import pileup
from deepvariant_tpu_torch.make_examples.pileup_device import (
    ALT_KEYS,
    PLAN_KEYS,
    plan_colors,
)
from deepvariant_tpu_torch.ops import pileup_paint as pp
from torch_port_util import (
    edge_hp,
    edge_plans,
    jax_images,
    random_plans,
    with_alt,
)

torch.set_num_threads(2)


def _inputs(n=2, r=16, w=32, seed=0, edge=False):
    """tests/test_ops.py-style inputs; `edge` adds N bases, other bytes,
    q up to 255 and colors at the uint8 edges."""
    rng = np.random.RandomState(seed)
    alphabet = np.frombuffer(b"ACGTN*" if edge else b"ACGT", np.uint8)
    b = alphabet[rng.randint(0, len(alphabet), (n, r, w))]
    b[rng.rand(n, r, w) < 0.25] = 0
    q = rng.randint(0, 256 if edge else 60, (n, r, w)).astype(np.uint8)
    covered = b != 0
    if edge:
        covered &= rng.rand(n, r, w) < 0.9  # covered is its own input
    ref = alphabet[rng.randint(0, len(alphabet), (n, w))]
    hi = 256 if edge else 255
    colors = [rng.randint(0, hi, (n, r)).astype(np.float32)
              for _ in range(4)]
    if edge:
        colors[0][:, 0] = 254.0
        colors[1][:, 1] = 255.0
        colors[2][:, 2] = 0.0
        colors[3][:, 3] = 127.5
    return (b, q, covered, ref, *colors)


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


CASES = [dict(seed=0), dict(seed=1, edge=True),
         dict(n=3, r=95, w=221, seed=2, edge=True)]


@pytest.mark.parametrize("case", CASES, ids=["test_ops", "edge", "wgs"])
def test_reference_bit_exact_vs_xla(case):
    args = _inputs(**case)
    want = np.asarray(jax_pp._paint_xla(*args))
    got = pp.paint_pileup_reference(*_torch(args)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", CASES[:2], ids=["test_ops", "edge"])
def test_reference_bit_exact_vs_interpreted_pallas(case):
    args = _inputs(**case)
    want = np.asarray(jax_pp._paint_pileup(*args, interpret=True))
    got = pp.paint_pileup_reference(*_torch(args)).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_uses_plain_version_and_counts_nothing():
    args = _torch(_inputs(seed=3, edge=True))
    before = pp.paint_pileup.launches
    out = pp.paint_pileup(*args)
    assert pp.paint_pileup.launches == before
    assert torch.equal(out, pp.paint_pileup_reference(*args))


@pytest.mark.parametrize("index,bad,error", [
    (0, lambda t: t.to(torch.int32), TypeError),
    (2, lambda t: t.to(torch.uint8), TypeError),
    (4, lambda t: t.to(torch.float64), TypeError),
    (1, lambda t: t[:, :-1], ValueError),
    (3, lambda t: t[:1], ValueError),
    (5, lambda t: t[:, None], ValueError),
    (0, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
], ids=["b-dtype", "covered-dtype", "color-dtype", "q-shape", "ref-shape",
        "color-rank", "noncontiguous"])
def test_wrapper_rejects_bad_inputs(index, bad, error):
    args = _torch(_inputs(seed=4))
    args[index] = bad(args[index])
    with pytest.raises(error):
        pp.paint_pileup(*args)


# The rows form's arguments among the plan's tensors, in
# `rows_form_args`' order.
ROWS_FORM_KEYS = ("bases", "quals", "mapq", "rev", "tlen", "support",
                  "row_valid", "ref_window")

# (n, rows, width, seed, options): the WGS widths, an odd width with a
# band of 3, the option overrides of the painter's own test with
# support colors that all differ, so each support code shows, and the
# long-read channel set with its diff planes.
PLAN_CASES = [
    (2, 95, 221, 10, dict()),
    (3, 20, 33, 11, dict(reference_band_height=3)),
    (2, 93, 221, 12, dict(mapping_quality_cap=30, positive_strand_color=10,
                          negative_strand_color=200,
                          allele_supporting_read_alpha=0.5,
                          other_allele_supporting_read_alpha=0.3,
                          reference_band_height=7)),
    (4, 95, 147, 13, dict(channels=(1, 2, 3, 4, 5, 6, 7, 26),
                          alt_aligned_pileup="diff_channels")),
]


def _plan_form(plans, kw):
    """(the plan form's 15 tensors, its colors) for stacked plans; the
    alt tensors are None where the plans have none."""
    options = pileup.PileupOptions(**kw)
    colors = plan_colors(options,
                         options.alt_aligned_pileup == "diff_channels")
    return [torch.from_numpy(plans[k]) if k in plans else None
            for k in PLAN_KEYS + ALT_KEYS], colors


@pytest.mark.parametrize("n,rows,width,seed,kw", PLAN_CASES,
                         ids=["wgs", "odd-width-band3", "options",
                              "longread"])
def test_plan_reference_bit_exact_vs_jax(n, rows, width, seed, kw):
    plans = edge_hp(edge_plans(random_plans(n, seed, rows=rows,
                                            width=width)))
    if kw.get("alt_aligned_pileup") == "diff_channels":
        with_alt(plans, seed)
    want = jax_images(plans, jax_pileup.PileupOptions(width=width, **kw))
    args, colors = _plan_form(plans, kw)
    got = pp.paint_pileup_plan_reference(*args, colors).numpy()
    assert got.shape == want.shape == (
        n, colors.band + rows, width, colors.planes)
    np.testing.assert_array_equal(got, want)


def test_plan_rows_are_the_rows_form_of_rows_form_args():
    plans = edge_plans(random_plans(2, 13, rows=9, width=17))
    args, colors = _plan_form(plans, {})
    image = pp.paint_pileup_plan_reference(*args, colors)
    rows = pp.paint_pileup_reference(*pp.rows_form_args(
        *[torch.from_numpy(plans[k]) for k in ROWS_FORM_KEYS], colors))
    assert torch.equal(image[:, colors.band:], rows)


@pytest.mark.parametrize("diff", [False, True], ids=["wgs", "diff"])
def test_plan_wrapper_on_cpu_uses_plain_version_and_counts_nothing(diff):
    kw = dict(alt_aligned_pileup="diff_channels") if diff else {}
    args, colors = _plan_form(with_alt(edge_plans(random_plans(
        2, 14, rows=9, width=17)), 15), kw)
    before = pp.paint_pileup.launches
    out = pp.paint_pileup_plan(*args, colors)
    assert pp.paint_pileup.launches == before
    assert out.shape == (2, 14, 17, 9 if diff else 7)
    assert torch.equal(out, pp.paint_pileup_plan_reference(*args, colors))


@pytest.mark.parametrize("index,bad,error", [
    (0, lambda t: t.to(torch.int32), TypeError),
    (3, lambda t: t.to(torch.uint8), TypeError),
    (5, lambda t: t.to(torch.int64), TypeError),
    (7, lambda t: t.to(torch.uint8), TypeError),
    (4, lambda t: t.to(torch.uint8), TypeError),
    (2, lambda t: t[:, :-1], ValueError),
    (10, lambda t: t[:1], ValueError),
    (1, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
    (9, lambda t: t.to("meta"), ValueError),
    (11, lambda t: t[:, :1], ValueError),
    (12, lambda t: t.to(torch.uint8), TypeError),
    (13, lambda t: None, TypeError),
    (14, lambda t: t[:, 0], ValueError),
], ids=["bases-dtype", "rev-dtype", "tlen-dtype", "support-dtype",
        "hp-dtype", "mapq-shape", "ref-shape", "noncontiguous", "device",
        "alt-bases-shape", "alt-row-valid-dtype", "alt-ref-missing",
        "alt-present-shape"])
def test_plan_wrapper_rejects_bad_inputs(index, bad, error):
    args, colors = _plan_form(
        with_alt(random_plans(2, 15, rows=9, width=17), 16),
        dict(alt_aligned_pileup="diff_channels"))
    args[index] = bad(args[index])
    with pytest.raises(error):
        pp.paint_pileup_plan(*args, colors)


def test_plan_wrapper_takes_no_alt_tensors_without_diff_mode():
    args, colors = _plan_form(random_plans(2, 17, rows=9, width=17), {})
    assert args[11:] == [None] * 4
    assert pp.paint_pileup_plan(*args, colors).shape == (2, 14, 17, 7)


_WGS_COLORS = plan_colors(pileup.PileupOptions())


@pytest.mark.parametrize("colors", [
    None, "band 5",
    dataclasses.replace(_WGS_COLORS, band=-1),
    dataclasses.replace(_WGS_COLORS, kinds=(), band_colors=()),
    dataclasses.replace(_WGS_COLORS, kinds=(0,) * 11, band_colors=(0,) * 11,
                        diff=True),
    dataclasses.replace(_WGS_COLORS, kinds=(0,) * 13, band_colors=(0,) * 13),
    dataclasses.replace(_WGS_COLORS, kinds=(10,) * 7),
    dataclasses.replace(_WGS_COLORS, band_colors=(1,) * 6),
    dataclasses.replace(_WGS_COLORS, match=256),
], ids=["none", "str", "negative-band", "no-planes", "13-planes-diff",
        "13-planes", "bad-kind", "band-colors-short", "color-over-255"])
def test_plan_wrapper_rejects_bad_colors(colors):
    args, _ = _plan_form(random_plans(2, 16, rows=9, width=17), {})
    with pytest.raises(ValueError):
        pp.paint_pileup_plan(*args, colors)


def test_plan_colors_struct_matches_the_kernel_layout():
    """_PlanColorsC must lay out as csrc/pileup_paint.cu's DvPlanColors:
    int32 band, planes, diff; float qual_cap, qual_scale, mapq_cap,
    mapq_scale; u8 kinds[12], band_colors[12], base[4], strand[2],
    support[3], supp[2], hp[4], match, mismatch; padded to 4 bytes."""
    c = pp._PlanColorsC
    assert [(f, getattr(c, f).offset) for f, _ in c._fields_] == [
        ("band", 0), ("planes", 4), ("diff", 8), ("qual_cap", 12),
        ("qual_scale", 16), ("mapq_cap", 20), ("mapq_scale", 24),
        ("kinds", 28), ("band_colors", 40), ("base", 52), ("strand", 56),
        ("support", 58), ("supp", 61), ("hp", 63), ("match", 67),
        ("mismatch", 68)]
    assert ctypes.sizeof(c) == 72


def test_kind_numbers_match_the_kernel_source():
    """KIND_* of ops/pileup_paint.py are DvKind of csrc/pileup_paint.cu."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "deepvariant_tpu_torch", "csrc",
                           "pileup_paint.cu")) as f:
        source = f.read()
    for name, value in [
            ("Base", pp.KIND_BASE), ("Quality", pp.KIND_QUALITY),
            ("Differs", pp.KIND_DIFFERS), ("Mapq", pp.KIND_MAPQ),
            ("Strand", pp.KIND_STRAND), ("Support", pp.KIND_SUPPORT),
            ("Tlen", pp.KIND_TLEN), ("Hp", pp.KIND_HP), ("Af", pp.KIND_AF),
            ("Supp", pp.KIND_SUPP)]:
        assert f"kKind{name} = {value}," in source
    assert f"kMaxPlanes = {pp.MAX_PLANES};" in source


def test_module_imports_without_nvcc_and_builds_nothing():
    code = (
        "import os, shutil\n"
        "os.environ['PATH'] = ''\n"
        "from deepvariant_tpu_torch.ops import pileup_paint, _build\n"
        "assert shutil.which('nvcc') is None\n"
        "assert 'pileup_paint' in _build.source_names()\n"
        "assert not _build._loaded\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=repo)

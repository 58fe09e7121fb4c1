"""The port's pileup paint (deepvariant_tpu_torch.ops.pileup_paint)
against the JAX package's Pallas kernel, its XLA twin and the long-read
encoder.

The rows form's plain version must be bit-exact against both
`_paint_xla` and `_paint_pileup(..., interpret=True)`; the plan form's
against `make_longread_encode_fn`. The CUDA kernel itself runs only on
the card and is held against the plain versions there by
chip_smoke.py."""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepvariant_tpu.make_examples import pileup as jax_pileup
from deepvariant_tpu.ops import pileup_paint as jax_pp
from deepvariant_tpu_torch.make_examples import pileup
from deepvariant_tpu_torch.make_examples.pileup_device import WgsPlanPainter
from deepvariant_tpu_torch.ops import pileup_paint as pp
from torch_port_util import edge_plans, jax_images, random_plans

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


# The plan form's arguments, in `paint_pileup_plan`'s order.
PLAN_FORM_KEYS = ("bases", "quals", "mapq", "rev", "tlen", "support",
                  "row_valid", "ref_window")

# (n, rows, width, seed, options): the WGS widths, an odd width with a
# band of 3, and the option overrides of the painter's own test with
# support colors that all differ, so each support code shows.
PLAN_CASES = [
    (2, 95, 221, 10, dict()),
    (3, 20, 33, 11, dict(reference_band_height=3)),
    (2, 93, 221, 12, dict(mapping_quality_cap=30, positive_strand_color=10,
                          negative_strand_color=200,
                          allele_supporting_read_alpha=0.5,
                          other_allele_supporting_read_alpha=0.3,
                          reference_band_height=7)),
]


def _plan_form(plans, kw):
    colors = WgsPlanPainter(pileup.PileupOptions(**kw)).colors
    return [torch.from_numpy(plans[k]) for k in PLAN_FORM_KEYS], colors


@pytest.mark.parametrize("n,rows,width,seed,kw", PLAN_CASES,
                         ids=["wgs", "odd-width-band3", "options"])
def test_plan_reference_bit_exact_vs_jax(n, rows, width, seed, kw):
    plans = edge_plans(random_plans(n, seed, rows=rows, width=width))
    want = jax_images(plans, jax_pileup.PileupOptions(width=width, **kw))
    args, colors = _plan_form(plans, kw)
    got = pp.paint_pileup_plan_reference(*args, colors).numpy()
    assert got.shape == want.shape == (
        n, colors.band + rows, width, pp.NUM_CHANNELS)
    np.testing.assert_array_equal(got, want)


def test_plan_rows_are_the_rows_form_of_rows_form_args():
    plans = edge_plans(random_plans(2, 13, rows=9, width=17))
    args, colors = _plan_form(plans, {})
    image = pp.paint_pileup_plan_reference(*args, colors)
    rows = pp.paint_pileup_reference(*pp.rows_form_args(*args, colors))
    assert torch.equal(image[:, colors.band:], rows)


def test_plan_wrapper_on_cpu_uses_plain_version_and_counts_nothing():
    args, colors = _plan_form(edge_plans(random_plans(2, 14, rows=9,
                                                      width=17)), {})
    before = pp.paint_pileup.launches
    out = pp.paint_pileup_plan(*args, colors)
    assert pp.paint_pileup.launches == before
    assert torch.equal(out, pp.paint_pileup_plan_reference(*args, colors))


@pytest.mark.parametrize("index,bad,error", [
    (0, lambda t: t.to(torch.int32), TypeError),
    (3, lambda t: t.to(torch.uint8), TypeError),
    (4, lambda t: t.to(torch.int64), TypeError),
    (5, lambda t: t.to(torch.uint8), TypeError),
    (2, lambda t: t[:, :-1], ValueError),
    (7, lambda t: t[:1], ValueError),
    (1, lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
     ValueError),
    (6, lambda t: t.to("meta"), ValueError),
], ids=["bases-dtype", "rev-dtype", "tlen-dtype", "support-dtype",
        "mapq-shape", "ref-shape", "noncontiguous", "device"])
def test_plan_wrapper_rejects_bad_inputs(index, bad, error):
    args, colors = _plan_form(random_plans(2, 15, rows=9, width=17), {})
    args[index] = bad(args[index])
    with pytest.raises(error):
        pp.paint_pileup_plan(*args, colors)


@pytest.mark.parametrize("colors", [
    None, "band 5",
    pp.PlanColors(band=-1, mapq_cap=60.0, strand=(70, 240),
                  support=(152, 254, 76), band_colors=(1,) * 6),
], ids=["none", "str", "negative-band"])
def test_plan_wrapper_rejects_bad_colors(colors):
    args, _ = _plan_form(random_plans(2, 16, rows=9, width=17), {})
    with pytest.raises(ValueError):
        pp.paint_pileup_plan(*args, colors)


def test_plan_colors_struct_matches_the_kernel_layout():
    """_PlanColorsC must lay out as csrc/pileup_paint.cu's DvPlanColors:
    int32 band, float mapq_cap, u8 strand[2], support[3],
    band_colors[6], padded to 4 bytes."""
    c = pp._PlanColorsC
    assert [getattr(c, f).offset for f in (
        "band", "mapq_cap", "strand", "support", "band_colors")] == \
        [0, 4, 8, 10, 13]
    assert ctypes.sizeof(c) == 20


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

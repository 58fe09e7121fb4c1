"""The port's WGS plan painter against the JAX long-read encoder.

`deepvariant_tpu_torch.make_examples.pileup_device.make_longread_encode_fn`
must give images bit-identical to `deepvariant_tpu.make_examples.
pileup_jax.make_longread_encode_fn(PileupOptions())` on the same plans."""

import dataclasses

import numpy as np
import pytest
import torch

from deepvariant_tpu.make_examples import pileup as jax_pileup
from deepvariant_tpu_torch.calling import plan_predictor
from deepvariant_tpu_torch.make_examples import pileup
from deepvariant_tpu_torch.make_examples.pileup_device import (
    make_longread_encode_fn,
)
from torch_port_util import edge_plans, jax_images, random_plans

torch.set_num_threads(2)

PLAN_KEYS = plan_predictor.PLAN_KEYS


def test_constants_match_jax():
    assert pileup.WGS_CHANNELS == jax_pileup.WGS_CHANNELS
    assert pileup.DEFAULT_CHANNELS == jax_pileup.DEFAULT_CHANNELS
    assert pileup.MAX_PIXEL_FLOAT == jax_pileup.MAX_PIXEL_FLOAT
    assert dataclasses.asdict(pileup.PileupOptions()) == \
        dataclasses.asdict(jax_pileup.PileupOptions())


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 5)])
def test_wgs_painter_bit_exact_vs_jax(seed, n):
    plans = edge_plans(random_plans(n, seed))
    plans["mapq"][0, :3] = [60, 61, 255]
    want = jax_images(plans, jax_pileup.PileupOptions())
    encode = make_longread_encode_fn(pileup.PileupOptions())
    got = encode(*[torch.from_numpy(plans[k]) for k in PLAN_KEYS]).numpy()
    assert got.shape == want.shape == (n, 100, 221, 7)
    np.testing.assert_array_equal(got, want)


def test_options_outside_the_kernel_follow_jax():
    """Colors computed outside the kernel honour the options."""
    kw = dict(mapping_quality_cap=30, positive_strand_color=10,
              negative_strand_color=200, allele_supporting_read_alpha=0.5,
              reference_band_height=7)
    plans = random_plans(2, 7, rows=93)
    want = jax_images(plans, jax_pileup.PileupOptions(**kw))
    encode = make_longread_encode_fn(pileup.PileupOptions(**kw))
    got = encode(*[torch.from_numpy(plans[k]) for k in PLAN_KEYS]).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw,error", [
    (dict(channels=tuple(pileup.DEFAULT_CHANNELS)), NotImplementedError),
    (dict(channels=tuple(pileup.WGS_CHANNELS + [pileup.CH_HAPLOTYPE_TAG])),
     NotImplementedError),
    (dict(alt_aligned_pileup="diff_channels"), NotImplementedError),
    (dict(base_quality_cap=30), NotImplementedError),
    (dict(alt_aligned_pileup="rows"), ValueError),
], ids=["default6", "wgs+hp", "diff_channels", "qual-cap", "rows"])
def test_unported_options_raise(kw, error):
    with pytest.raises(error) as info:
        make_longread_encode_fn(pileup.PileupOptions(**kw))
    if error is NotImplementedError:
        assert "later slice" in str(info.value)

"""The port's fused plan path (deepvariant_tpu_torch.calling.
plan_predictor) against the JAX package's PlanPredictor, float32 on the
CPU. Probabilities agree to 1e-5 (the images are bit-identical; the CNN
differs only in the order of the conv sums)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepvariant_tpu.calling import plan_predictor as jax_plan
from deepvariant_tpu.make_examples.pileup import PileupOptions as JaxOptions
from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu_torch.calling import plan_predictor as plan
from deepvariant_tpu_torch.calling.call_variants import Predictor
from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.make_examples.pileup import (
    DEFAULT_CHANNELS,
    PileupOptions,
)
from deepvariant_tpu_torch.models import inception_v3 as iv3
from torch_port_util import (
    edge_hp,
    jax_images,
    random_flax_variables,
    random_plans,
    with_alt,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(7, seed=4)


@pytest.fixture(scope="module")
def plans():
    stacked = random_plans(5, seed=9)
    return [{k: v[i] for k, v in stacked.items()} for i in range(5)]


@pytest.fixture(scope="module")
def predictor(variables):
    model = iv3.InceptionV3(7)
    model.load_state_dict(iv3.from_flax_variables(variables))
    return plan.PlanPredictor(model, PileupOptions(), batch_size=4,
                              device="cpu", dtype=torch.float32)


def test_plan_keys_match_jax():
    assert plan.PLAN_KEYS == jax_plan.PLAN_KEYS
    assert plan.ALT_KEYS == jax_plan.ALT_KEYS


def test_probabilities_match_jax_plan_predictor(variables, plans,
                                                predictor):
    jax_predictor = jax_plan.PlanPredictor(
        variables, JaxOptions(), batch_size=4,
        model=jax_iv3.InceptionV3(dtype=jnp.float32))
    want = jax_predictor(plans)
    payloads = [plan.PlannedExample(p, Variant(start=i), [0], 1)
                for i, p in enumerate(plans)]
    out = list(predictor.predict_plan_stream(payloads))
    assert [p for p, _ in out] == payloads  # in order, padding dropped
    got = np.stack([probs for _, probs in out])
    assert got.shape == (5, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(predictor(plans[:3]), got[:3], atol=1e-6)


def test_fused_path_equals_painted_images_through_predictor(variables,
                                                            plans,
                                                            predictor):
    """Painting then calling equals calling the painted images."""
    images = predictor.encode(plans[:4]).numpy()
    assert images.shape == (4, 100, 221, 7)
    staged = Predictor(predictor.predictor.model, batch_size=4,
                       device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(staged(images), predictor(plans[:4]))


@pytest.mark.parametrize("diff_mode", [False, True])
def test_compact_plan_matches_jax(plans, diff_mode):
    full = dict(plans[0], alt_bases=np.zeros((2, 95, 221), np.uint8),
                alt_row_valid=np.zeros((2, 95), bool),
                alt_ref=np.zeros((2, 221), np.uint8),
                alt_present=np.zeros(2, bool))
    got = plan.compact_plan(full, diff_mode)
    want = jax_plan.compact_plan(full, diff_mode)
    assert list(got) == list(want)


LONGREAD = dict(channels=(1, 2, 3, 4, 5, 6, 7, 26), width=99,
                alt_aligned_pileup="diff_channels", sort_by_haplotypes=True)


@pytest.fixture(scope="module")
def longread_variables():
    return random_flax_variables(10, seed=5)


@pytest.fixture(scope="module")
def longread_plans():
    stacked = with_alt(edge_hp(random_plans(5, seed=10, width=99)), 11)
    return [{k: v[i] for k, v in stacked.items()} for i in range(5)]


def test_diff_mode_probabilities_match_jax_plan_predictor(
        longread_variables, longread_plans):
    """The long-read preset's channels and diff planes, 100x99x10, on
    full plans and on plans stripped of their alt tensors, which both
    packages stage as zeros (alt_present false: zero diff planes). Same
    tolerance as the WGS test: 1e-5, the conv sums' order."""
    jax_predictor = jax_plan.PlanPredictor(
        longread_variables, JaxOptions(**LONGREAD), batch_size=4,
        model=jax_iv3.InceptionV3(dtype=jnp.float32))
    model = iv3.InceptionV3(10)
    model.load_state_dict(iv3.from_flax_variables(longread_variables))
    predictor = plan.PlanPredictor(model, PileupOptions(**LONGREAD),
                                   batch_size=4, device="cpu",
                                   dtype=torch.float32)
    assert predictor.diff_mode and jax_predictor.diff_mode
    stripped = [plan.compact_plan(p, False) for p in longread_plans]
    assert not set(plan.ALT_KEYS) & set(stripped[0])
    for plans in (longread_plans, stripped):
        want = jax_predictor(plans[:4])
        got = predictor(plans[:4])
        assert got.shape == (4, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    images = predictor.encode(longread_plans[:4]).numpy()
    assert images.shape == (4, 100, 99, 10) and images[..., 8:].any()
    assert not predictor.encode(stripped[:4]).numpy()[..., 8:].any()
    np.testing.assert_array_equal(images, jax_images(
        {k: np.stack([p[k] for p in longread_plans[:4]])
         for k in longread_plans[0]}, JaxOptions(**LONGREAD)))
    out = list(predictor.predict_plan_stream(
        [plan.PlannedExample(p, Variant(start=i), [0], 1)
         for i, p in enumerate(longread_plans)]))
    np.testing.assert_allclose(np.stack([p for _, p in out])[:4],
                               predictor(longread_plans[:4]), atol=1e-6)


def test_wgs_predictor_stages_no_alt_tensors(predictor, plans):
    """Without diff mode the alt tensors are neither staged nor read,
    whether the plans carry them or not."""
    staged = predictor.stage(plans[:2])
    assert tuple(staged) == plan.PLAN_KEYS
    full = [dict(p, alt_bases=np.ones((2, 95, 221), np.uint8),
                 alt_row_valid=np.ones((2, 95), bool),
                 alt_ref=np.ones((2, 221), np.uint8),
                 alt_present=np.ones(2, bool)) for p in plans[:2]]
    np.testing.assert_array_equal(predictor(full), predictor(plans[:2]))


@pytest.mark.parametrize("channels,alt,model_channels", [
    (tuple(DEFAULT_CHANNELS), "none", 6),
    ((1, 2, 3, 4, 5, 6, 7, 26), "diff_channels", 10),
    ((19, 1), "none", 2),
], ids=["rnaseq-6", "pacbio-10", "two"])
def test_unported_presets_raise(variables, channels, alt, model_channels):
    """The presets that earlier slices refused now build, with the model's
    channel count checked against the planes painted; a model of another
    width raises ValueError when the predictor is built."""
    options = PileupOptions(channels=channels, alt_aligned_pileup=alt)
    predictor = plan.PlanPredictor(iv3.InceptionV3(model_channels), options,
                                   batch_size=2, device="cpu",
                                   dtype=torch.float32)
    assert predictor.diff_mode == (alt == "diff_channels")
    assert predictor.encode([]).shape == (2, 100, 221, model_channels)
    with pytest.raises(ValueError, match="channels"):
        plan.PlanPredictor(iv3.InceptionV3(model_channels + 1), options,
                           device="cpu")

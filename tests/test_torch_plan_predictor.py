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
from torch_port_util import random_flax_variables, random_plans

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


def test_unported_presets_raise(variables):
    model = iv3.InceptionV3(6)
    with pytest.raises(NotImplementedError):
        plan.PlanPredictor(model, PileupOptions(
            channels=tuple(DEFAULT_CHANNELS)), device="cpu")

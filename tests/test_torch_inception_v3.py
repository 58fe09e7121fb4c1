"""The port's InceptionV3 (deepvariant_tpu_torch.models.inception_v3)
against the JAX package's flax model, in float32 on the CPU.

Tolerances: the two forwards differ only in the order of the conv sums
(XLA against oneDNN), so probabilities agree to 1e-5. BN folding
changes the rounding of every conv, and the folded port is held to
2e-4 against the unfolded JAX model, the bound the JAX package uses
for its own folding check."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu_torch.models import inception_v3 as iv3
from torch_port_util import random_flax_variables

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

CHANNELS = 7


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(CHANNELS, seed=0)


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(1)
    return rng.randint(0, 255, (2, 100, 221, CHANNELS), np.uint8)


@pytest.fixture(scope="module")
def jax_probs(variables, images):
    """The JAX float32 forward, built once for this file."""
    model = jax_iv3.InceptionV3(dtype=jnp.float32)
    x = jax_iv3.normalize_pileup(jnp.asarray(images)).astype(jnp.float32)
    return np.asarray(jax.jit(
        lambda v, x: model.apply(v, x, train=False))(variables, x))


def port_model(variables):
    model = iv3.InceptionV3(CHANNELS)
    model.load_state_dict(iv3.from_flax_variables(variables))
    return iv3.prepare_for_inference(model, "cpu", torch.float32)


def port_probs(model, images):
    x = iv3.normalize_pileup(torch.from_numpy(images), torch.float32)
    with torch.no_grad():
        return model(x).numpy()


def test_flax_layout_matches_jax_model():
    """to_flax_variables gives exactly the JAX model's tree of shapes."""
    want = jax.eval_shape(lambda: jax_iv3.InceptionV3().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 100, 221, CHANNELS)),
        train=False))
    got = iv3.to_flax_variables(iv3.InceptionV3(CHANNELS))
    assert jax.tree_util.tree_map(lambda a: a.shape, want) == \
        jax.tree_util.tree_map(lambda a: a.shape, got)


def test_flax_variables_round_trip_exactly(variables):
    back = iv3.to_flax_variables(port_model(variables))
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, value in flat_a:
        np.testing.assert_array_equal(flat_b[path], value)


def test_float32_forward_matches_jax(variables, images, jax_probs):
    got = port_probs(port_model(variables), images)
    assert got.shape == (2, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_probs, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), jax_probs.argmax(-1))


def test_folded_port_matches_unfolded_jax(variables, images, jax_probs):
    folded = iv3.fold_batch_norm(port_model(variables))
    assert folded.fold_bn and not any(
        isinstance(m, iv3.BatchNorm) for m in folded.modules())
    got = port_probs(folded, images)
    np.testing.assert_allclose(got, jax_probs, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), jax_probs.argmax(-1))


def test_fold_matches_jax_fold_exactly(variables):
    """The folded weights are the JAX package's fold_batch_norm bit for
    bit (same float32 operations)."""
    _, want = jax_iv3.fold_batch_norm(jax_iv3.InceptionV3(), variables)
    got = iv3.to_flax_variables(iv3.fold_batch_norm(port_model(variables)))
    assert set(got) == {"params"}
    for path, value in jax.tree_util.tree_leaves_with_path(want):
        got_value = got
        for key in path:
            got_value = got_value[key.key]
        np.testing.assert_array_equal(got_value, np.asarray(value))


def test_pad_stem_input_channels_is_exact(variables, images):
    model = port_model(variables)
    padded = iv3.pad_stem_input_channels(model, 8)
    assert padded.num_channels == 8
    assert tuple(padded.stem1.conv.weight.shape) == (32, 8, 3, 3)
    assert torch.equal(padded.stem1.conv.weight[:, CHANNELS:],
                       torch.zeros(32, 1, 3, 3))
    x = iv3.normalize_pileup(torch.from_numpy(images), torch.float32)
    x8 = torch.nn.functional.pad(x, (0, 1))
    with torch.no_grad():
        np.testing.assert_array_equal(padded(x8).numpy(), model(x).numpy())
    with pytest.raises(ValueError):
        iv3.pad_stem_input_channels(model, 6)


def test_param_count_inception_scale():
    n = sum(p.numel() for p in iv3.InceptionV3(6).parameters())
    assert 21_700_000 < n < 21_900_000


def test_create_model_is_seeded_and_float32_head():
    a = iv3.create_model(CHANNELS, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    b = iv3.create_model(CHANNELS, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    assert a.stem1.conv.weight.dtype == torch.bfloat16
    assert a.stem1.conv.weight.is_contiguous(
        memory_format=torch.channels_last)
    assert a.classification.weight.dtype == torch.float32
    assert a.stem1.bn.mean.dtype == torch.float32


def test_normalize_pileup_exact():
    x = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    for dtype in (torch.bfloat16, torch.float32):
        got = iv3.normalize_pileup(x, dtype).float().numpy()
        np.testing.assert_array_equal(got, (np.arange(256) - 128) / 128)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        iv3.prepare_for_inference(iv3.InceptionV3(CHANNELS), "cuda",
                                  torch.float32)

"""Shared pieces of the tests that hold the port's training
(deepvariant_tpu_torch.training) against the JAX package's: a tiny twin
model in both packages, seeded labeled records, and tree comparisons."""

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn
from flax import serialization

from deepvariant_tpu.core.types import Variant, VariantCall
from deepvariant_tpu.io import examples as example_codec
from deepvariant_tpu.io.tfrecord import TFRecordWriter
from deepvariant_tpu.models.inception_v3 import ConvBN as JaxConvBN
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.models.checkpoint import state_to_flax
from torch_twin_util import TWIN_FEATURES, TWIN_SHAPE, TorchTwin  # noqa: F401



class JaxTwin(nn.Module):
    """conv (3x3, stride 4, VALID) + BN(scale=False) + ReLU, mean pool,
    dropout, Dense head: the JAX package's ConvBN and head in small."""

    dtype: Any = jnp.float32
    dropout_rate: float = 0.0
    bn_momentum: float = 0.9

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = x.astype(self.dtype)
        x = JaxConvBN(TWIN_FEATURES, (3, 3), strides=(4, 4),
                      padding="VALID", dtype=self.dtype,
                      bn_momentum=self.bn_momentum, name="stem")(x, train)
        x = jnp.mean(x, axis=(1, 2)).astype(jnp.float32)
        x = nn.Dropout(self.dropout_rate, deterministic=not train)(x)
        logits = nn.Dense(3, name="classification")(x)
        return jax.nn.softmax(logits, axis=-1)


def twin_variables(seed: int = 0):
    """JaxTwin's {params, batch_stats} with random non-trivial running
    statistics, as numpy float32."""
    variables = JaxTwin().init(jax.random.PRNGKey(seed),
                               jnp.zeros((1,) + TWIN_SHAPE), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.RandomState(seed)
    stats = variables["batch_stats"]["stem"]["bn"]
    stats["mean"] = (rng.standard_normal(TWIN_FEATURES) * 0.1).astype(
        np.float32)
    stats["var"] = rng.uniform(0.5, 1.5, TWIN_FEATURES).astype(np.float32)
    return variables


def torch_variables(variables, device="cpu"):
    """A flax {params, batch_stats} tree -> the port trainer's
    {params, batch_stats} maps of float32 tensors on `device`."""
    out = {}
    for collection in ("params", "batch_stats"):
        out[collection] = {
            k: v.float().to(device)
            for k, v in iv3.tree_from_flax(variables[collection]).items()}
    return out


def random_batch(n, shape, seed):
    rng = np.random.RandomState(seed)
    return {
        "images": rng.randint(0, 256, (n,) + tuple(shape)).astype(np.uint8),
        "labels": rng.randint(0, 3, (n,)).astype(np.int32),
        "sample_weights": rng.choice([0.5, 1.0, 2.0], n).astype(np.float32),
        "variant_types": rng.randint(0, 3, (n,)).astype(np.int32),
    }


def to_torch(batch, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def jax_state_tree(state):
    """The JAX package's TrainState as flax serializes it: nested dicts
    of numpy arrays (optax's tuples as {"0": ...})."""
    return jax.tree_util.tree_map(
        np.asarray, serialization.to_state_dict(jax.device_get(state)))


def port_state_tree(state):
    return state_to_flax(state)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree)}


def assert_trees_close(got, want, rtol, atol, what=""):
    """Same keys everywhere; every array within rtol/atol."""
    got, want = flat(got), flat(want)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for key in want:
        assert got[key].shape == want[key].shape, (what, key)
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {key}")


def write_training_records(path, n, shape=(32, 32, 4), seed=0,
                           channels=(1, 2, 3, 4)):
    """Seeded labeled examples (random images, labels 0..2, SNPs and
    indels) and their example_info.json, by the JAX package's writer."""
    rng = np.random.RandomState(seed)
    with TFRecordWriter(path) as w:
        for i in range(n):
            alt = "T" if rng.rand() < 0.5 else "TT"
            v = Variant(
                reference_name="chr1", start=i * 10, end=i * 10 + 1,
                reference_bases="A", alternate_bases=[alt],
                calls=[VariantCall(call_set_name="s")],
            )
            img = rng.randint(0, 255, shape, np.uint8)
            w.write(example_codec.make_example(
                v, img, alt_allele_indices=[0],
                locus_region=f"chr1:{i * 10}-{i * 10 + 1}",
                label=int(rng.randint(0, 3)),
            ))
    example_codec.write_example_info(path, shape, list(channels))

"""The port's training config, metrics and input pipeline
(deepvariant_tpu_torch.training.{config,metrics,data}) against the JAX
package's.

Tolerances: none. The presets are compared field by field, the input
pipeline is host code with the same `random.Random` draws and its
batches are compared byte for byte, and the confusion matrices count
whole examples (exact in float32)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvariant_tpu.training import config as jax_config
from deepvariant_tpu.training import data as jax_data
from deepvariant_tpu.training import metrics as jax_metrics
from deepvariant_tpu_torch.training import config as port_config
from deepvariant_tpu_torch.training import data as port_data
from deepvariant_tpu_torch.training import metrics as port_metrics
from torch_train_util import write_training_records

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

PRESETS = ("wgs", "base", "exome", "wes", "pacbio", "ont", "wgs_test",
           "exome_debug", "pacbio_test", "ont_debug", "WGS")


@pytest.mark.parametrize("name", PRESETS)
def test_get_config_matches_jax_field_by_field(name):
    want = jax_config.get_config(name)
    got = port_config.get_config(name)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for field in dataclasses.fields(want):
        assert getattr(got, field.name) == getattr(want, field.name), \
            field.name
    assert got.class_weight_list() == want.class_weight_list()


def test_unknown_preset_raises_as_jax():
    with pytest.raises(ValueError, match="unknown config preset"):
        port_config.get_config("nanopore")


def test_train_config_defaults_match_jax():
    assert dataclasses.asdict(port_config.TrainConfig()) == \
        dataclasses.asdict(jax_config.TrainConfig())


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_update_matches_jax(masked):
    rng = np.random.RandomState(3)
    labels = rng.randint(0, 3, 40).astype(np.int32)
    preds = rng.randint(0, 3, 40).astype(np.int32)
    mask = rng.rand(40) < 0.6 if masked else None
    start = rng.randint(0, 5, (3, 3)).astype(np.float32)
    want = np.asarray(jax_metrics.confusion_update(
        jnp.asarray(start), jnp.asarray(labels), jnp.asarray(preds),
        None if mask is None else jnp.asarray(mask)))
    got = port_metrics.confusion_update(
        torch.from_numpy(start), torch.from_numpy(labels),
        torch.from_numpy(preds),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(port_metrics.empty_confusion().numpy(),
                                  np.asarray(jax_metrics.empty_confusion()))


@pytest.mark.parametrize("cm", [
    [[10, 0, 0], [0, 5, 5], [0, 0, 10]],
    [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
    [[3, 1, 0], [0, 0, 0], [2, 0, 7]],
    [[1.5, 0.5, 0], [0, 2, 1], [0, 0, 0]],
])
def test_metrics_from_confusion_matches_jax(cm):
    cm = np.asarray(cm, np.float32)
    assert port_metrics.metrics_from_confusion(cm, prefix="t/") == \
        jax_metrics.metrics_from_confusion(cm, prefix="t/")


def _assert_batches_equal(got, want):
    for field in ("images", "labels", "sample_weights", "variant_types"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """17 labeled examples in three shards, and a tune file of 3."""
    d = tmp_path_factory.mktemp("records")
    for i, n in enumerate((7, 4, 6)):
        write_training_records(str(d / f"train-{i:05d}-of-00003.tfrecord"),
                               n, seed=10 + i)
    write_training_records(str(d / "tune.tfrecord"), 3, seed=20)
    return str(d)


TRAIN_CASES = {
    "buffer-smaller-than-data": dict(batch_size=4,
                                     shuffle_buffer_elements=5),
    "class-weights": dict(batch_size=3, shuffle_buffer_elements=6,
                          class_weights="1,2,10"),
    "buffer-larger-than-data": dict(batch_size=5,
                                    shuffle_buffer_elements=100),
    "other-seed": dict(batch_size=4, shuffle_buffer_elements=3,
                       seed=7),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_input_fn_train_batches_equal_jax(shards, case):
    """Train mode over three shards: the file-order shuffle, the shuffle
    buffer's swap and pop and the epoch-end drain, three epochs deep."""
    spec = os.path.join(shards, "train@3.tfrecord")
    kwargs = TRAIN_CASES[case]
    want_it = jax_data.input_fn(spec, jax_config.TrainConfig(**kwargs))
    got_it = port_data.input_fn(spec, port_config.TrainConfig(**kwargs))
    n_batches = 3 * 17 // kwargs["batch_size"] + 1
    for _ in range(n_batches):
        _assert_batches_equal(next(got_it), next(want_it))


@pytest.mark.parametrize("batch_size,spec", [
    (4, "train@3.tfrecord"),     # 17 examples: 4 full, 1 padded
    (8, "tune.tfrecord"),        # 3 examples: smaller than one batch
    (17, "train@3.tfrecord"),    # exactly one batch
])
def test_input_fn_tune_batches_equal_jax(shards, batch_size, spec):
    path = os.path.join(shards, spec)
    want = list(jax_data.input_fn(
        path, jax_config.TrainConfig(batch_size=batch_size,
                                     class_weights="1,1,10"), mode="tune"))
    got = list(port_data.input_fn(
        path, port_config.TrainConfig(batch_size=batch_size,
                                      class_weights="1,1,10"), mode="tune"))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _assert_batches_equal(a, b)


def test_input_fn_seed_argument_overrides_config(shards):
    spec = os.path.join(shards, "train@3.tfrecord")
    cfg = dict(batch_size=4, shuffle_buffer_elements=4)
    got = port_data.input_fn(spec, port_config.TrainConfig(**cfg), seed=99)
    want = jax_data.input_fn(spec, jax_config.TrainConfig(**cfg), seed=99)
    for _ in range(6):
        _assert_batches_equal(next(got), next(want))


@pytest.mark.parametrize("suffix", [".pbtxt", ".json"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dataset_config_round_trips_across_packages(tmp_path, suffix,
                                                    writer):
    fields = dict(name="wgs train", tfrecord_path="/x/train@3.tfrecord.gz",
                  num_examples=123456)
    path = str(tmp_path / ("ds" + suffix))
    if writer == "port":
        port_data.DatasetConfig(**fields).write(path)
    else:
        jax_data.DatasetConfig(**fields).write(path)
    assert dataclasses.asdict(port_data.DatasetConfig.read(path)) == fields
    assert dataclasses.asdict(jax_data.DatasetConfig.read(path)) == fields
    with open(path) as f:
        text = f.read()
    other = str(tmp_path / ("other" + suffix))
    (jax_data if writer == "port" else port_data).DatasetConfig(
        **fields).write(other)
    with open(other) as f:
        assert f.read() == text

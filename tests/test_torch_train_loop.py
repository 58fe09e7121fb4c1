"""The port's training loops (`train`, `train_resident` and the train
CLI with `--device cpu`) against the JAX package's, on the CPU.

Both packages' `create_model` are patched, in this file's tests only
(monkeypatch), to build the tiny twin of `torch_train_util` with dropout
0 and the same weights: the loops' logic (the input pipeline's order,
steps per epoch and per tune pass, the schedule's counts, the tune pass,
checkpoints, best-checkpoint selection, history) is what is compared
here; the full InceptionV3 step is test_torch_train_inception.py's, and
one unpatched CLI run of the port trains InceptionV3 itself. The JAX
loop shards each batch over the 8 virtual CPU devices of
tests/conftest.py, so batches are multiples of 8.

Tolerances: float32 losses and metrics of each epoch to 1e-5 relative
(plus 1e-6 absolute), the saved states' leaves to 1e-5 relative plus
1e-6 absolute; the file names written are equal. The CLI runs the
presets' bfloat16 (use_mixed_precision): the port's CLI is held to the
port's `train` exactly (same inputs, same code), and to the JAX CLI's
losses at 2e-2 relative (XLA's CPU backend computes bfloat16 ops in
float32 and rounds less often)."""

import ast
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvariant_tpu.scripts import train as jax_cli
from deepvariant_tpu.training import train as jax_train
from deepvariant_tpu.training import train_resident as jax_resident
from deepvariant_tpu.training.config import TrainConfig as JaxConfig
from deepvariant_tpu.training.data import DatasetConfig
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.scripts import train as port_cli
from deepvariant_tpu_torch.training import train as port_train
from deepvariant_tpu_torch.training import train_resident as port_resident
from deepvariant_tpu_torch.training.config import TrainConfig, get_config
from torch_train_util import (
    TWIN_SHAPE,
    JaxTwin,
    TorchTwin,
    assert_trees_close,
    twin_variables,
    write_training_records,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

N_TRAIN, N_TUNE = 27, 12


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Train (27 examples, two shards) and tune (12) records of the
    twin's shape, and their dataset configs."""
    d = tmp_path_factory.mktemp("data")
    write_training_records(str(d / "train-00000-of-00002.tfrecord"), 15,
                           shape=TWIN_SHAPE, seed=1, channels=[1] * 7)
    write_training_records(str(d / "train-00001-of-00002.tfrecord"), 12,
                           shape=TWIN_SHAPE, seed=2, channels=[1] * 7)
    write_training_records(str(d / "tune.tfrecord"), N_TUNE,
                           shape=TWIN_SHAPE, seed=3, channels=[1] * 7)
    train_cfg, tune_cfg = str(d / "train.pbtxt"), str(d / "tune.json")
    DatasetConfig(name="train", tfrecord_path=str(d / "train@2.tfrecord"),
                  num_examples=N_TRAIN).write(train_cfg)
    DatasetConfig(name="tune", tfrecord_path=str(d / "tune.tfrecord"),
                  num_examples=N_TUNE).write(tune_cfg)
    return train_cfg, tune_cfg


@pytest.fixture
def twins(monkeypatch):
    """create_model in both packages' loops builds the twin, seed-2
    weights, dropout 0."""
    variables = twin_variables(2)

    def jax_create(c, height=100, width=221, dtype=jnp.bfloat16, rng=None,
                   bn_momentum=0.9997):
        return (JaxTwin(dtype=dtype, bn_momentum=bn_momentum),
                jax.tree_util.tree_map(jnp.asarray, variables))

    def port_create(c, height=100, width=221, dtype=torch.bfloat16,
                    generator=None, bn_momentum=0.9997, device="cuda"):
        model = TorchTwin(c, bn_momentum=bn_momentum)
        state = {**iv3.tree_from_flax(variables["params"]),
                 **iv3.tree_from_flax(variables["batch_stats"])}
        model.load_state_dict(state)
        return iv3.prepare_for_inference(model, device, dtype)

    monkeypatch.setattr(jax_train, "create_model", jax_create)
    monkeypatch.setattr(jax_resident, "create_model", jax_create)
    monkeypatch.setattr(port_train, "create_model", port_create)


def _config(cls, datasets, **overrides):
    train_cfg, tune_cfg = datasets
    fields = dict(train_dataset_config=train_cfg, tune_dataset_config=tune_cfg,
                  batch_size=8, num_epochs=3, use_mixed_precision=False,
                  shuffle_buffer_elements=10, learning_rate=0.05,
                  learning_rate_num_epochs_per_decay=1.0,
                  learning_rate_decay_rate=0.5, bn_momentum=0.9,
                  num_validation_examples=N_TUNE, weight_decay=0.01)
    fields.update(overrides)
    return cls(**fields)


def _assert_results_close(got, want, rtol=1e-5):
    assert set(got) == set(want)
    for key in want:
        if "examples_per_sec" in key or "epoch_seconds" in key:
            continue
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   atol=1e-6, err_msg=key)


def _files(directory):
    return sorted(os.path.relpath(os.path.join(root, name), directory)
                  for root, _, names in os.walk(directory) for name in names)


def _read(path):
    with open(path, "rb") as f:
        return flax_msgpack.unpack(f.read())


@pytest.mark.parametrize("overrides", [
    dict(optimizer="sgd"),
    dict(optimizer="adam", learning_rate=0.01, gradient_accumulation_steps=2,
         class_weights="1,2,10", use_ema=False),
    dict(optimizer="rmsprop", learning_rate=0.01, warmup_steps=3,
         limit=2, num_epochs=4),
], ids=["sgd", "adam-accum-weights", "rmsprop-warmup-limit"])
def test_train_loop_matches_jax(tmp_path, datasets, twins, overrides):
    want_logs, got_logs = [], []
    want = jax_train.train(_config(JaxConfig, datasets, **overrides),
                           str(tmp_path / "jax"), log_fn=want_logs.append)
    got = port_train.train(_config(TrainConfig, datasets, **overrides),
                           str(tmp_path / "port"), device="cpu",
                           log_fn=got_logs.append)
    _assert_results_close(got, want)
    assert len(got_logs) == len(want_logs)
    files = _files(str(tmp_path / "port"))
    assert files == _files(str(tmp_path / "jax"))
    epochs = overrides.get("num_epochs", 3)
    assert files == ["checkpoints/best.msgpack",
                     f"checkpoints/ckpt-{epochs - 1}.msgpack",
                     "checkpoints/example_info.json"]
    for name in files[:2]:
        assert_trees_close(_read(str(tmp_path / "port" / name)),
                           _read(str(tmp_path / "jax" / name)),
                           rtol=1e-5, atol=1e-6, what=name)
    with open(str(tmp_path / "port" / files[2])) as f:
        assert json.load(f)["shape"] == list(TWIN_SHAPE)


def test_train_max_steps_and_early_stopping(tmp_path, datasets, twins):
    overrides = dict(early_stopping_patience=1, num_epochs=6)
    want_logs, got_logs = [], []
    want = jax_train.train(_config(JaxConfig, datasets, **overrides),
                           str(tmp_path / "jax"), max_steps=9,
                           log_fn=want_logs.append)
    got = port_train.train(_config(TrainConfig, datasets, **overrides),
                           str(tmp_path / "port"), device="cpu", max_steps=9,
                           log_fn=got_logs.append)
    _assert_results_close(got, want)
    assert [line.split(":")[0] for line in got_logs] == \
        [line.split(":")[0] for line in want_logs]
    assert _files(str(tmp_path / "port")) == _files(str(tmp_path / "jax"))


@pytest.mark.parametrize("overrides", [
    dict(optimizer="sgd"),
    dict(optimizer="adam", learning_rate=0.01, class_weights="1,1,3",
         gradient_accumulation_steps=2),
], ids=["sgd", "adam-accum-weights"])
def test_train_resident_matches_jax(tmp_path, datasets, twins, overrides):
    cfg = _config(JaxConfig, datasets, **overrides)
    want = jax_resident.train_resident(cfg, str(tmp_path / "jax"),
                                       device=jax.devices()[0],
                                       log_fn=lambda line: None)
    got = port_resident.train_resident(
        _config(TrainConfig, datasets, **overrides), str(tmp_path / "port"),
        device="cpu", log_fn=lambda line: None)
    _assert_results_close(got, want)
    files = _files(str(tmp_path / "port"))
    assert files == _files(str(tmp_path / "jax")) == [
        "checkpoints/best.msgpack", "checkpoints/example_info.json",
        "checkpoints/final.msgpack", "history.json"]
    for name in ("checkpoints/best.msgpack", "checkpoints/final.msgpack"):
        got_state = _read(str(tmp_path / "port" / name))
        assert set(got_state) == {"params", "batch_stats", "ema_params",
                                  "step"}
        assert_trees_close(got_state, _read(str(tmp_path / "jax" / name)),
                           rtol=1e-5, atol=1e-6, what=name)
    with open(str(tmp_path / "port" / "history.json")) as f:
        got_history = json.load(f)
    with open(str(tmp_path / "jax" / "history.json")) as f:
        want_history = json.load(f)
    assert len(got_history) == len(want_history) == 3
    for g, w in zip(got_history, want_history):
        assert g["epoch"] == w["epoch"]
        for key in ("train/loss", "tune/loss", "tune/f1_weighted"):
            # history.json rounds to 5 decimals: one unit of rounding.
            assert abs(g[key] - w[key]) <= 1e-5 + 1e-5 * abs(w[key]), key


def test_tune_index_plan_matches_jax():
    for n, batch in ((12, 8), (3, 8), (16, 8), (0, 4)):
        got = port_resident._tune_index_plan(n, batch)
        want = jax_resident._tune_index_plan(n, batch)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_load_dataset_arrays_matches_jax(datasets):
    spec = DatasetConfig.read(datasets[0]).tfrecord_path
    for weights in ("", "1,2,10"):
        got = port_resident.load_dataset_arrays(
            spec, TrainConfig(class_weights=weights))
        want = jax_resident.load_dataset_arrays(
            spec, JaxConfig(class_weights=weights))
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes(), key


def _cli_flags(datasets, directory):
    train_cfg, tune_cfg = datasets
    return ["--config", "wgs_test", "--train_dataset_config", train_cfg,
            "--tune_dataset_config", tune_cfg, "--experiment_dir", directory,
            "--batch_size", "8", "--num_epochs", "2"]


def test_cli_matches_train_and_jax_cli(tmp_path, datasets, twins, capsys):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_cli.main(_cli_flags(datasets, jax_dir)) == 0
    assert port_cli.main(_cli_flags(datasets, port_dir) +
                         ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("train done:") == 2
    assert _files(port_dir) == _files(jax_dir)
    # The CLI is `train` with the preset and the flags.
    train_cfg, tune_cfg = datasets
    cfg = dataclasses.replace(
        get_config("wgs_test"), train_dataset_config=train_cfg,
        tune_dataset_config=tune_cfg, batch_size=8, num_epochs=2)
    assert cfg.use_mixed_precision
    direct = port_train.train(cfg, str(tmp_path / "direct"), device="cpu",
                              log_fn=lambda line: None)
    assert_trees_close(_read(os.path.join(port_dir, "checkpoints",
                                          "best.msgpack")),
                       _read(str(tmp_path / "direct" / "checkpoints" /
                                 "best.msgpack")), rtol=0, atol=0)
    done = [ast.literal_eval(line[len("train done: "):])
            for line in out.splitlines() if line.startswith("train done:")]
    want, got = done
    assert set(got) == set(direct)
    assert all(got[k] == direct[k] for k in got
               if "examples_per_sec" not in k)
    for key in ("train/loss", "tune/loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-2,
                                   err_msg=key)


def test_cli_trains_inception_on_cpu(tmp_path):
    """The port's CLI unpatched: InceptionV3 at 100x221x7 (bfloat16, the
    preset's), one step and one tune batch."""
    d = tmp_path
    write_training_records(str(d / "train.tfrecord"), 4, shape=(100, 221, 7),
                           seed=4, channels=[1, 2, 3, 4, 5, 6, 7])
    DatasetConfig(name="t", tfrecord_path=str(d / "train.tfrecord"),
                  num_examples=4).write(str(d / "train.pbtxt"))
    rc = port_cli.main([
        "--config", "wgs_test", "--train_dataset_config",
        str(d / "train.pbtxt"), "--tune_dataset_config",
        str(d / "train.pbtxt"), "--experiment_dir", str(d / "exp"),
        "--batch_size", "2", "--num_epochs", "1", "--limit", "1",
        "--device", "cpu"])
    assert rc == 0
    state = _read(str(d / "exp" / "checkpoints" / "best.msgpack"))
    assert int(state["step"]) == 1
    kernel = state["params"]["stem1"]["conv"]["kernel"]
    assert kernel.shape == (3, 3, 7, 32) and kernel.dtype == np.float32
    assert set(state["opt_state"]) == {"0", "1"}


def test_cuda_without_a_card_raises(tmp_path, datasets):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.train(_config(TrainConfig, datasets), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_resident.train_resident(_config(TrainConfig, datasets),
                                     str(tmp_path))

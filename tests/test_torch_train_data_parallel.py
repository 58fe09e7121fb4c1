"""The port's data-parallel train and eval steps and `train()` over a gloo
group of real processes on the CPU, against the JAX package's
`shard_train_step` on the 8-device CPU mesh and against the port's
one-rank step on the same global batches.

The twin model of `torch_train_util` runs two steps of a global batch of
16 for SGD with EMA and AdamW, with gradient accumulation 1 and 2, on 2
and 4 ranks (4 ranks and accumulation 2: each rank holds 2 rows of each
micro batch of 8). Dropout is 0: the two packages cannot draw the same
masks. Tolerances, as in test_torch_train_step.py: losses to 1e-6
relative, every leaf of the state (params, batch_stats, opt_state,
ema_params) to 1e-5 relative plus 1e-6 absolute, the confusion matrices
and the step count exactly; the ranks' states are equal to each other
exactly (every rank applies the same update to the same sums).

A BatchNorm layer in a group of 2 is held to flax's BatchNorm on the
whole batch: output and input gradient to 1e-5, the bias gradient
summed over the ranks to 1e-5, the running statistics to 1e-6.

The twin's AdamW leaves take 5e-5 absolute (ADAMW_ATOL says why). The
full InceptionV3 is test_torch_train_data_parallel_inception.py's.

`train()` on 2 ranks (the twin patched in as create_model) writes one
set of files, from rank 0, equal to the one-rank run's to 1e-5 relative
plus 1e-6 absolute, with the same tune metrics."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from deepvariant_tpu.training import train as jax_train
from deepvariant_tpu.training.config import TrainConfig as JaxConfig
from deepvariant_tpu.training.data import DatasetConfig
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.training import train as port_train
from deepvariant_tpu_torch.training.config import TrainConfig
from torch_dist_util import run_ranks
from torch_train_util import (
    TWIN_SHAPE,
    JaxTwin,
    TorchTwin,
    assert_trees_close,
    jax_state_tree,
    port_state_tree,
    random_batch,
    to_torch,
    torch_variables,
    twin_variables,
    write_training_records,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

BATCH = 16
STEPS = 2
RANKS = (2, 4)
# AdamW's first update is lr * g / (|g| + eps) per element: where a
# gradient element is within a few eps of zero, its float32 summation
# order moves the update by up to a few thousandths of lr (measured
# 2.1e-5 at lr 0.01, against JAX on 2 and 4 ranks).
ADAMW_ATOL = 5e-5
COMMON = dict(use_mixed_precision=False, learning_rate_decay_rate=0.5,
              learning_rate_num_epochs_per_decay=1.0, weight_decay=0.01,
              ema_momentum=0.9, label_smoothing=0.01)
CASES = {
    "sgd-ema-accum1": dict(optimizer="sgd", learning_rate=0.05,
                           use_ema=True, gradient_accumulation_steps=1),
    "sgd-ema-accum2": dict(optimizer="sgd", learning_rate=0.05,
                           use_ema=True, gradient_accumulation_steps=2),
    "adamw-accum1": dict(optimizer="adam", learning_rate=0.01,
                         optimizer_weight_decay=0.02, use_ema=False,
                         gradient_accumulation_steps=1),
    "adamw-accum2": dict(optimizer="adam", learning_rate=0.01,
                         optimizer_weight_decay=0.02, use_ema=False,
                         gradient_accumulation_steps=2),
}


def _fields(name):
    return {**COMMON, **CASES[name]}


def _batches(shape, n=BATCH, seed=200):
    return [random_batch(n, shape, seed + i) for i in range(STEPS)]


def _numpy_maps(variables):
    return {c: {k: v.numpy() for k, v in m.items()}
            for c, m in variables.items()}


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """{ranks: each rank's records per case} of the twin."""
    variables = _numpy_maps(torch_variables(twin_variables(0)))
    cases = [_fields(name) for name in CASES]
    return {n: run_ranks("torch_dist_util:train_steps", n,
                         tmp_path_factory.mktemp(f"ranks{n}"), cases=cases,
                         variables=variables, batches=_batches(TWIN_SHAPE))
            for n in RANKS}


def _jax_records(name):
    cfg = JaxConfig(**_fields(name))
    model = JaxTwin()
    tx, _ = jax_train.make_optimizer(cfg, 1)
    state = jax_train.init_state(
        model, jax.tree_util.tree_map(jnp.asarray, twin_variables(0)), tx)
    mesh = jax_train.data_parallel_mesh(jax.devices()[:8])
    step, _, replicated = jax_train.shard_train_step(
        jax_train.make_train_step(model, tx, cfg), mesh)
    evaluate = jax.jit(jax_train.make_eval_step(model, cfg))
    state = jax.device_put(state, replicated)
    records = []
    for batch in _batches(TWIN_SHAPE):
        state, loss, cms = step(state, batch)
        eval_loss, eval_cm = evaluate(state, batch)
        records.append({
            "state": jax_state_tree(state), "loss": float(loss),
            "cms": {k: np.asarray(v) for k, v in cms.items()},
            "eval_loss": float(eval_loss), "eval_cm": np.asarray(eval_cm)})
    return records


def _one_rank_records(name, net, variables, batches):
    cfg = TrainConfig(**_fields(name))
    tx, _ = port_train.make_optimizer(cfg, 1)
    state = port_train.init_state(net, variables, tx)
    step = port_train.make_train_step(net, tx, cfg)
    evaluate = port_train.make_eval_step(net, cfg)
    records = []
    for batch in batches:
        state, loss, cms = step(state, to_torch(batch))
        eval_loss, eval_cm = evaluate(state, to_torch(batch))
        records.append({
            "state": port_state_tree(state), "loss": float(loss),
            "cms": {k: v.numpy() for k, v in cms.items()},
            "eval_loss": float(eval_loss), "eval_cm": eval_cm.numpy()})
    return records


def _assert_records_close(got, want, what, loss_rtol=1e-6, rtol=1e-5,
                          atol=1e-6):
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        tag = f"{what} step {i}"
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=loss_rtol,
                                   err_msg=tag)
        np.testing.assert_allclose(g["eval_loss"], w["eval_loss"],
                                   rtol=loss_rtol, err_msg=tag)
        for key in ("all", "snp", "indel"):
            np.testing.assert_array_equal(g["cms"][key], w["cms"][key],
                                          err_msg=f"{tag} {key}")
        np.testing.assert_array_equal(g["eval_cm"], w["eval_cm"],
                                      err_msg=tag)
        assert_trees_close(g["state"], w["state"], rtol=rtol, atol=atol,
                           what=tag)
        assert int(g["state"]["step"]) == i + 1


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", list(CASES))
def test_data_parallel_step_matches_jax_and_one_rank(rank_runs, name,
                                                     ranks):
    index = list(CASES).index(name)
    per_rank = [records[index] for records in rank_runs[ranks]]
    for rank, records in enumerate(per_rank[1:], 1):
        assert_trees_close({str(i): r["state"] for i, r in
                            enumerate(records)},
                           {str(i): r["state"] for i, r in
                            enumerate(per_rank[0])},
                           rtol=0, atol=0, what=f"rank {rank} vs rank 0")
    got = per_rank[0]
    atol = ADAMW_ATOL if name.startswith("adamw") else 1e-6
    _assert_records_close(got, _jax_records(name), f"{name} vs JAX",
                          atol=atol)
    one_rank = _one_rank_records(name, TorchTwin(),
                                 torch_variables(twin_variables(0)),
                                 _batches(TWIN_SHAPE))
    _assert_records_close(got, one_rank, f"{name} vs one rank", atol=atol)


def test_batch_norm_in_a_group_of_two_matches_flax(tmp_path):
    rng = np.random.RandomState(9)
    x = (rng.standard_normal((8, 5, 6, 11)) * 2 + 0.5).astype(np.float32)
    grad = rng.standard_normal(x.shape).astype(np.float32)
    momentum = 0.9
    ranks = run_ranks("torch_dist_util:batch_norm_layer", 2, tmp_path,
                      x=x, grad=grad, momentum=momentum)
    bias = np.linspace(-0.5, 0.5, 5).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, use_scale=False,
                      epsilon=1e-3, momentum=momentum)
    stats = {"mean": np.full(5, 0.25, np.float32),
             "var": np.full(5, 1.5, np.float32)}

    def apply(x_nhwc, bias):
        return bn.apply({"params": {"bias": bias}, "batch_stats": stats},
                        x_nhwc, mutable=["batch_stats"])

    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    want, mutated = apply(x_nhwc, jnp.asarray(bias))
    _, vjp = jax.vjp(lambda a, b: apply(a, b)[0], x_nhwc, jnp.asarray(bias))
    dx, dbias = vjp(jnp.asarray(grad.transpose(0, 2, 3, 1)))
    y = np.concatenate([r["y"] for r in ranks]).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(y, np.asarray(want), rtol=1e-5, atol=1e-5)
    got_dx = np.concatenate([r["dx"] for r in ranks]).transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got_dx, np.asarray(dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(r["dbias"] for r in ranks),
                               np.asarray(dbias), rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(r["mean"],
                                   mutated["batch_stats"]["mean"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["var"], mutated["batch_stats"]["var"],
                                   rtol=1e-6, atol=1e-6)


def _read(path):
    with open(path, "rb") as f:
        return flax_msgpack.unpack(f.read())


def _files(directory):
    return sorted(os.path.relpath(os.path.join(root, name), directory)
                  for root, _, names in os.walk(directory) for name in names)


def test_train_loop_on_two_ranks_matches_one_rank(tmp_path, monkeypatch):
    d = tmp_path / "data"
    d.mkdir()
    write_training_records(str(d / "train.tfrecord"), 27, shape=TWIN_SHAPE,
                           seed=1, channels=[1] * 7)
    write_training_records(str(d / "tune.tfrecord"), 12, shape=TWIN_SHAPE,
                           seed=3, channels=[1] * 7)
    train_cfg, tune_cfg = str(d / "train.pbtxt"), str(d / "tune.pbtxt")
    DatasetConfig(name="train", tfrecord_path=str(d / "train.tfrecord"),
                  num_examples=27).write(train_cfg)
    DatasetConfig(name="tune", tfrecord_path=str(d / "tune.tfrecord"),
                  num_examples=12).write(tune_cfg)
    fields = dict(train_dataset_config=train_cfg,
                  tune_dataset_config=tune_cfg, batch_size=8, num_epochs=2,
                  use_mixed_precision=False, shuffle_buffer_elements=10,
                  learning_rate=0.01, optimizer="adam",
                  gradient_accumulation_steps=2, class_weights="1,2,10",
                  bn_momentum=0.9, num_validation_examples=12,
                  weight_decay=0.01)
    variables = twin_variables(2)
    got = run_ranks("torch_dist_util:train_loop", 2, tmp_path / "ranks",
                    fields=fields, experiment_dir=str(tmp_path / "dp"),
                    variables=variables)

    def create(c, height=100, width=221, dtype=None, generator=None,
               bn_momentum=0.9997, device="cuda"):
        model = TorchTwin(c, bn_momentum=bn_momentum)
        model.load_state_dict({
            **iv3.tree_from_flax(variables["params"]),
            **iv3.tree_from_flax(variables["batch_stats"])})
        return iv3.prepare_for_inference(model, device, dtype)

    monkeypatch.setattr(port_train, "create_model", create)
    want = port_train.train(TrainConfig(**fields), str(tmp_path / "one"),
                            device="cpu", log_fn=lambda line: None)
    for metrics in got:
        assert set(metrics) == set(want)
        for key in want:
            if "examples_per_sec" not in key:
                np.testing.assert_allclose(metrics[key], want[key],
                                           rtol=1e-5, atol=1e-6,
                                           err_msg=key)
    files = _files(str(tmp_path / "dp"))
    assert files == _files(str(tmp_path / "one")) == [
        "checkpoints/best.msgpack", "checkpoints/ckpt-1.msgpack",
        "checkpoints/example_info.json"]
    for name in files[:2]:
        assert_trees_close(_read(str(tmp_path / "dp" / name)),
                           _read(str(tmp_path / "one" / name)),
                           rtol=1e-5, atol=1e-6, what=name)
    with open(str(tmp_path / "dp" / files[2])) as f:
        assert json.load(f)["shape"] == list(TWIN_SHAPE)

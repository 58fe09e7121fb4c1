"""One train step and one eval step of the full InceptionV3(7) at
100x221, batch 2, float32, SGD, dropout 0, in the port against the JAX
package, on the CPU; the JAX step is built once for the file.

Tolerances, and why they are loose for the update. A train-mode step of
this network is ill-conditioned in float32: batch norm's backward
subtracts the batch means of its incoming gradient at each of 94
layers, and the rounding of two float32 implementations is amplified to
a few percent of the update. Measured at this batch (seed 0 weights,
seed 5 batch): the JAX float32 update is 5.9% (relative L2) from the
port's float64 step and the port's float32 update 3.5%, while the two
float64 steps (JAX with x64) agree to 4e-5 per element. So the port's
float64 step is the reference: the loss of both float32 steps within
1e-4 relative of it, their updates (params, ema_params, the momentum
trace) within 15% relative L2 of its update and of each other; the
batch-norm statistics, which the forward alone sets, within 1e-5
relative; step and count equal. The eval step's loss agrees to 1e-4
relative and its confusion matrix exactly. The bfloat16 step is held to
the float32 step, not to JAX (whose CPU backend computes bfloat16 ops
in float32 and rounds less often than the card does): its loss within
5e-2 relative (measured 3.0%; the L2 term, from the float32 masters,
is most of the loss)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu.training import train as jax_train
from deepvariant_tpu.training.config import TrainConfig as JaxConfig
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.training import train as port_train
from deepvariant_tpu_torch.training.config import TrainConfig
from torch_port_util import random_flax_variables
from torch_train_util import (
    flat,
    jax_state_tree,
    port_state_tree,
    random_batch,
    to_torch,
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

SHAPE = (100, 221, 7)
FIELDS = dict(optimizer="sgd", learning_rate=0.01, use_mixed_precision=False)
UPDATE_RTOL = 0.15


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(SHAPE[2], seed=0)


@pytest.fixture(scope="module")
def batch():
    return random_batch(2, SHAPE, 5)


@pytest.fixture(scope="module")
def jax_run(variables, batch):
    """(state before, state after, loss, eval loss, eval confusion) of
    the JAX package's float32 step."""
    cfg = JaxConfig(**FIELDS)
    model = jax_iv3.InceptionV3(dtype=jnp.float32, dropout_rate=0.0)
    tx, _ = jax_train.make_optimizer(cfg, 10)
    state = jax_train.init_state(
        model, jax.tree_util.tree_map(jnp.asarray, variables), tx)
    before = jax_state_tree(state)
    state, loss, _ = jax.jit(jax_train.make_train_step(model, tx, cfg))(
        state, batch)
    eval_loss, eval_cm = jax.jit(jax_train.make_eval_step(model, cfg))(
        state, batch)
    return (before, jax_state_tree(state), float(loss), float(eval_loss),
            np.asarray(eval_cm))


def port_step(variables, batch, dtype, compute=None):
    """The port's state after one step with weights in `dtype` (the head
    stays float32, as the pooled features are), computing in `compute`."""
    cfg = TrainConfig(**FIELDS)
    model = iv3.InceptionV3(SHAPE[2], dropout_rate=0.0,
                            dtype=compute or dtype)
    tx, _ = port_train.make_optimizer(cfg, 10)
    tensors = {c: {k: v.to(torch.float32 if k.startswith("classification")
                           else dtype)
                   for k, v in iv3.tree_from_flax(variables[c]).items()}
               for c in ("params", "batch_stats")}
    state = port_train.init_state(model, tensors, tx)
    state, loss, cms = port_train.make_train_step(model, tx, cfg)(
        state, to_torch(batch))
    return model, cfg, state, float(loss)


@pytest.fixture(scope="module")
def port_runs(variables, batch):
    return {name: port_step(variables, batch, dtype)
            for name, dtype in (("f32", torch.float32),
                                ("f64", torch.float64))}


def _update_distance(a, b, start, group):
    """Relative L2 distance of two states' moves from `start` over the
    float leaves under `group`."""
    a, b, start = flat(a), flat(b), flat(start)
    keys = [k for k in b if k[:len(group)] == group]
    assert keys and set(keys) == {k for k in a if k[:len(group)] == group}

    def origin(k):
        # params and ema_params move from the initial weights; the
        # optimizer trace starts at zero.
        return start.get(("params",) + k[1:], 0) if group[0] in (
            "params", "ema_params") else 0

    num = sum(float(np.sum((a[k].astype(np.float64) - b[k]) ** 2))
              for k in keys)
    den = sum(float(np.sum((b[k].astype(np.float64) - origin(k)) ** 2))
              for k in keys)
    return (num / den) ** 0.5


def test_loss_matches_jax_and_float64(jax_run, port_runs):
    _, _, jax_loss, _, _ = jax_run
    f32, f64 = port_runs["f32"][3], port_runs["f64"][3]
    assert abs(f32 - f64) <= 1e-4 * abs(f64)
    assert abs(jax_loss - f64) <= 1e-4 * abs(f64)
    assert abs(f32 - jax_loss) <= 1e-4 * abs(jax_loss)


@pytest.mark.parametrize("group", [("params",), ("ema_params",),
                                   ("opt_state", "0", "trace")])
def test_update_matches_jax_within_float32_noise(jax_run, port_runs, group):
    before, jax_after, _, _, _ = jax_run
    port32 = port_state_tree(port_runs["f32"][2])
    port64 = port_state_tree(port_runs["f64"][2])
    assert _update_distance(port32, port64, before, group) < UPDATE_RTOL
    assert _update_distance(jax_after, port64, before, group) < UPDATE_RTOL
    assert _update_distance(port32, jax_after, before, group) < UPDATE_RTOL


def test_batch_stats_step_and_count_match_jax(jax_run, port_runs):
    _, jax_after, _, _, _ = jax_run
    got = flat(port_state_tree(port_runs["f32"][2]))
    want = flat(jax_after)
    assert set(got) == set(want)
    for key in want:
        if key[0] == "batch_stats":
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=str(key))
        elif want[key].dtype.kind == "i":
            assert got[key].dtype == np.int32 and got[key] == want[key] == 1


def test_eval_step_matches_jax(jax_run, port_runs):
    _, _, _, jax_eval_loss, jax_eval_cm = jax_run
    model, cfg, state, _ = port_runs["f32"]
    loss, cm = port_train.make_eval_step(model, cfg)(
        state, to_torch(random_batch(2, SHAPE, 5)))
    np.testing.assert_allclose(float(loss), jax_eval_loss, rtol=1e-4)
    np.testing.assert_array_equal(cm.numpy(), jax_eval_cm)


def test_trained_module_prepares_and_folds(port_runs, batch):
    """A module loaded with the trained state serves inference through
    prepare_for_inference and fold_batch_norm, as the eval step reads
    it (use_ema: the EMA weights)."""
    model, cfg, state, _ = port_runs["f32"]
    trained = iv3.InceptionV3(SHAPE[2])
    trained.load_state_dict({**state["ema_params"], **state["batch_stats"]})
    trained.train()
    ready = iv3.prepare_for_inference(trained, "cpu", torch.float32)
    folded = iv3.fold_batch_norm(ready)
    x = iv3.normalize_pileup(torch.from_numpy(batch["images"]),
                             torch.float32)
    with torch.no_grad():
        probs = ready(x)
        folded_probs = folded(x)
    eval_loss, _ = port_train.make_eval_step(model, cfg)(
        state, to_torch(batch))
    want = port_train.loss_fn(probs, torch.from_numpy(batch["labels"]),
                              torch.from_numpy(batch["sample_weights"]),
                              cfg.label_smoothing)
    np.testing.assert_allclose(float(want), float(eval_loss), rtol=1e-6)
    np.testing.assert_allclose(folded_probs.numpy(), probs.numpy(),
                               atol=2e-4)


def test_bfloat16_step_against_float32(variables, batch, port_runs):
    _, _, state, loss = port_step(variables, batch, torch.float32,
                                  compute=torch.bfloat16)
    f32 = port_runs["f32"][3]
    assert abs(loss - f32) <= 5e-2 * abs(f32)
    for tree in (state["params"], state["ema_params"]):
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all()
                   for v in tree.values())

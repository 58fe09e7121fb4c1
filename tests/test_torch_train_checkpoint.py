"""Training checkpoints across the two packages: a TrainState that the
JAX package's `save_checkpoint` writes loads in the port (and the
port's next step equals JAX's next step), a TrainState that the port
writes loads through the JAX package's `load_checkpoint` against its
template, and the resident trainer's inference snapshot loads in both
packages' call_variants loaders.

Tolerances: what crosses a file is compared exactly (float32 arrays and
int32 counts); the next step after a load is held to JAX's as in
test_torch_train_step.py (loss 1e-6 relative, every state leaf 1e-5
relative plus 1e-6 absolute)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvariant_tpu.models import inception_v3 as jax_iv3
from deepvariant_tpu.scripts import call_variants as jax_cv
from deepvariant_tpu.training import train as jax_train
from deepvariant_tpu.training.config import TrainConfig as JaxConfig
from deepvariant_tpu_torch.models import checkpoint as port_ckpt
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.training import train as port_train
from deepvariant_tpu_torch.training import train_resident as port_resident
from deepvariant_tpu_torch.training.config import TrainConfig
from torch_port_util import random_flax_variables
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
)

torch.set_num_threads(2)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

OPTIMIZERS = ("sgd", "adam", "rmsprop")
INFO = {"version": "1", "shape": list(TWIN_SHAPE), "channels": [1] * 7}


def _setup(optimizer):
    fields = dict(optimizer=optimizer, use_mixed_precision=False,
                  learning_rate=0.05 if optimizer == "sgd" else 0.01,
                  gradient_accumulation_steps=2, weight_decay=0.01)
    jcfg, cfg = JaxConfig(**fields), TrainConfig(**fields)
    variables = twin_variables(2)
    jmodel, tmodel = JaxTwin(), TorchTwin()
    jtx, _ = jax_train.make_optimizer(jcfg, 4)
    ptx, _ = port_train.make_optimizer(cfg, 4)
    jstate = jax_train.init_state(
        jmodel, jax.tree_util.tree_map(jnp.asarray, variables), jtx)
    pstate = port_train.init_state(tmodel, torch_variables(variables), ptx)
    return (jmodel, jtx, jcfg, jstate), (tmodel, ptx, cfg, pstate)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_jax_checkpoint_loads_in_port_and_steps_alike(tmp_path, optimizer):
    (jmodel, jtx, jcfg, jstate), (tmodel, ptx, cfg, template) = \
        _setup(optimizer)
    jstep = jax.jit(jax_train.make_train_step(jmodel, jtx, jcfg))
    for i in range(2):
        jstate, _, _ = jstep(jstate, random_batch(4, TWIN_SHAPE, 30 + i))
    path = str(tmp_path / "ckpt-1.msgpack")
    jax_train.save_checkpoint(path, jstate, INFO)
    state = port_train.load_checkpoint(path, template)
    assert_trees_close(port_state_tree(state), jax_state_tree(jstate),
                       rtol=0, atol=0)
    assert int(state["step"]) == 2 and state["step"].dtype == torch.int32
    batch = random_batch(4, TWIN_SHAPE, 40)
    jstate, jloss, _ = jstep(jstate, batch)
    state, loss, _ = port_train.make_train_step(tmodel, ptx, cfg)(
        state, to_torch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert_trees_close(port_state_tree(state), jax_state_tree(jstate),
                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_port_checkpoint_loads_in_jax(tmp_path, optimizer):
    (jmodel, jtx, jcfg, jtemplate), (tmodel, ptx, cfg, state) = \
        _setup(optimizer)
    step = port_train.make_train_step(tmodel, ptx, cfg)
    for i in range(2):
        state, _, _ = step(state, to_torch(random_batch(4, TWIN_SHAPE, i)))
    path = str(tmp_path / "checkpoints" / "ckpt-0.msgpack")
    port_train.save_checkpoint(path, state, INFO)
    assert os.path.exists(str(tmp_path / "checkpoints" /
                              "example_info.json"))
    restored = jax_train.load_checkpoint(path, jtemplate)
    assert_trees_close(jax_state_tree(restored), port_state_tree(state),
                       rtol=0, atol=0)
    assert np.asarray(restored["step"]).dtype == np.int32
    # And back into the port against its own template.
    again = port_train.load_checkpoint(path, _setup(optimizer)[1][3])
    assert_trees_close(port_state_tree(again), port_state_tree(state),
                       rtol=0, atol=0)


def test_load_checkpoint_refuses_another_tree(tmp_path):
    _, (_, _, _, sgd_state) = _setup("sgd")
    path = str(tmp_path / "sgd.msgpack")
    port_train.save_checkpoint(path, sgd_state)
    _, (_, _, _, adam_template) = _setup("adam")
    with pytest.raises(ValueError, match="do not match"):
        port_train.load_checkpoint(path, adam_template)


@pytest.fixture(scope="module")
def inception_state():
    """A port TrainState of InceptionV3(7) (SGD), its EMA weights apart
    from its weights."""
    variables = random_flax_variables(7, seed=3)
    tensors = torch_variables(variables)
    tx, _ = port_train.make_optimizer(TrainConfig(), 100)
    state = port_train.init_state(iv3.InceptionV3(7), tensors, tx)
    state["ema_params"] = {k: v * 0.5 for k, v in state["params"].items()}
    state["step"] = torch.tensor(17, dtype=torch.int32)
    return state


@pytest.fixture
def jax_model_without_init(monkeypatch):
    """The JAX loader's create_model without flax's init of InceptionV3
    (about half a minute on a CPU): the template tree comes from the
    port's layout."""
    def create_model(c, height=100, width=221, **kwargs):
        return jax_iv3.InceptionV3(), random_flax_variables(c, seed=0)

    monkeypatch.setattr(jax_cv, "create_model", create_model)


@pytest.mark.parametrize("layout", ["resident-snapshot", "train-state"])
@pytest.mark.parametrize("use_ema", [True, False])
def test_trained_checkpoints_load_in_both_call_variants(
        tmp_path, inception_state, jax_model_without_init, layout, use_ema):
    ckpt_dir = tmp_path / "checkpoints"
    path = str(ckpt_dir / "best.msgpack")
    info = {"version": "1", "shape": [100, 221, 7], "channels": [1] * 7}
    if layout == "resident-snapshot":
        os.makedirs(ckpt_dir)
        port_resident._save_inference_state(
            path, port_resident.snapshot(inception_state), info)
    else:
        port_train.save_checkpoint(path, inception_state, info)
    want = inception_state["ema_params" if use_ema else "params"]
    # The port's loader, given the directory.
    model = port_ckpt.load_variables_for_shape(
        str(ckpt_dir), (100, 221, 7), use_ema=use_ema, device="cpu")
    loaded = model.state_dict()
    for name, value in {**want, **inception_state["batch_stats"]}.items():
        assert torch.equal(loaded[name], value), name
    # The JAX package's loader reads the file, but always its `params`:
    # its first try, the lean {params, batch_stats} template, succeeds on
    # every layout because flax's restore ignores keys the template lacks,
    # so its EMA branches never run (ROADMAP Queue 3). The port reads the
    # EMA weights where the file has them, as those branches intend.
    _, variables = jax_cv.load_variables_for_shape(
        path, (100, 221, 7), use_ema=use_ema)
    assert_trees_close(variables, {
        "params": iv3.tree_to_flax(inception_state["params"]),
        "batch_stats": iv3.tree_to_flax(inception_state["batch_stats"]),
    }, rtol=0, atol=0)

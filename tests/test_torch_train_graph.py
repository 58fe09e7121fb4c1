"""The train step's CUDA graph (`training/train.py`, `_MicroGraph`): on
one card, from the second call of a micro-batch shape, the forward and
backward replay one captured graph.

On the CPU the step never captures. Tests marked `chip` need a CUDA card
and skip without one (they decide inside the `card` fixture); on the
card they hold the graphed step to the eager one (which spans force) bit
for bit, step after step, for SGD and Adam, with and without gradient
accumulation; count the kernels' launches once per micro-batch; keep one
graph, running another shape eagerly; and leave the state passed in as
it was: `python -m pytest tests/test_torch_train_graph.py -q`."""

import pytest
import torch

from deepvariant_tpu_torch.ops import batch_norm_relu as bnr
from deepvariant_tpu_torch.ops import pool
from deepvariant_tpu_torch.training import train as port_train
from deepvariant_tpu_torch.training.config import TrainConfig
from deepvariant_tpu_torch.utils import trace
from torch_twin_util import TWIN_SHAPE, TorchTwin

torch.set_num_threads(2)

SHAPE = (100, 221, 7)


@pytest.fixture
def card():
    """The CUDA device for tests marked `chip`; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _fresh_recorder():
    trace.reset()
    yield
    trace.reset()


def _batch(n, shape, seed, device):
    g = torch.Generator().manual_seed(seed)
    return {k: v.to(device) for k, v in {
        "images": torch.randint(0, 256, (n,) + tuple(shape), generator=g,
                                dtype=torch.uint8),
        "labels": torch.randint(0, 3, (n,), generator=g, dtype=torch.int32),
        "sample_weights": torch.rand(n, generator=g) + 0.5,
        "variant_types": torch.randint(0, 3, (n,), generator=g,
                                       dtype=torch.int32),
    }.items()}


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


def test_the_cpu_step_never_captures(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU step captured a graph")

    monkeypatch.setattr(port_train, "_MicroGraph", refuse)
    cfg = TrainConfig(batch_size=8, learning_rate=0.01, weight_decay=1e-3,
                      seed=3)
    torch.manual_seed(0)
    model = TorchTwin(dropout_rate=0.3)
    tx, _ = port_train.make_optimizer(cfg, 10)
    state = port_train.init_state(
        model, port_train.model_variables(model, "cpu"), tx)
    step = port_train.make_train_step(model, tx, cfg)
    for i in range(3):
        state, loss, _ = step(state, _batch(8, TWIN_SHAPE, i, "cpu"))
    assert torch.isfinite(loss)


def _inception_step(card, optimizer, accum, batch):
    cfg = TrainConfig(batch_size=batch, optimizer=optimizer,
                      gradient_accumulation_steps=accum, use_ema=True,
                      learning_rate=0.01, weight_decay=1e-4, seed=5,
                      use_mixed_precision=True)
    model, variables = port_train.training_model(cfg, SHAPE, card)
    tx, _ = port_train.make_optimizer(cfg, 10)
    state = port_train.init_state(model, variables, tx)
    return (port_train.make_train_step(model, tx, cfg),
            port_train.make_train_step(model, tx, cfg), state)


@pytest.mark.chip
@pytest.mark.parametrize("optimizer,accum", [("sgd", 1), ("adam", 1),
                                             ("adam", 2)])
def test_graphed_steps_equal_eager_steps(card, optimizer, accum):
    graphed, eager, state = _inception_step(card, optimizer, accum, 8)
    sg = se = state
    before = _clone(state)
    for i in range(4):
        batch = _batch(8, SHAPE, 10 + i, card)
        sg, lg, cg = graphed(sg, batch)
        with trace.recording():
            se, le, ce = eager(se, batch)
        torch.cuda.synchronize()
        assert torch.equal(lg, le), i
        assert _equal(cg, ce), i
        assert _equal(sg, se), i
    assert _equal(state, before)


@pytest.mark.chip
def test_launches_count_once_a_micro_batch(card):
    graphed, _, state = _inception_step(card, "sgd", 2, 8)
    bnr.batch_norm_relu.launches = 0
    pool.box3x3.launches = pool.max3x3s2.launches = 0
    for i in range(3):
        state, _, _ = graphed(state, _batch(8, SHAPE, 20 + i, card))
    micro_batches = 3 * 2
    assert bnr.batch_norm_relu.launches == 4 * 94 * micro_batches
    assert (pool.box3x3.launches, pool.max3x3s2.launches) == (
        18 * micro_batches, 8 * micro_batches)


@pytest.mark.chip
def test_one_graph_and_another_shape_runs_eagerly(card, monkeypatch):
    graphed, eager, state = _inception_step(card, "sgd", 1, 8)
    made = []
    real = port_train._MicroGraph

    def counting(*args, **kwargs):
        made.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_train, "_MicroGraph", counting)
    sg = se = state
    for i, n in enumerate((8, 8, 4, 4, 8)):
        batch = _batch(n, SHAPE, 30 + i, card)
        sg, lg, _ = graphed(sg, batch)
        with trace.recording():
            se, le, _ = eager(se, batch)
        torch.cuda.synchronize()
        assert torch.equal(lg, le), i
        assert _equal(sg, se), i
    assert made == [1]

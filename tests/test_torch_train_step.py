"""The port's train and eval steps (deepvariant_tpu_torch.training.train)
against the JAX package's, on a tiny twin model, in float32 on the CPU.

The twin (`torch_train_util`: a 3x3 stride-4 conv, batch norm without
scale, mean pooling and a Dense head, with the same parameter names in
both packages) runs three steps per case of a matrix over the three
optimizers, gradient accumulation 1 and 2, EMA on and off, warmup 0 and
2, label smoothing and class weights, with a learning rate that halves
every step. Both models are built with dropout 0: the two packages
cannot draw the same masks, and dropout is tested by its statistics.

Tolerances: the twin's convs and reductions run in a different order in
XLA and oneDNN, so losses agree to 1e-6 relative and every leaf of the
state (params, batch_stats, opt_state, ema_params) to 1e-5 relative
plus 1e-6 absolute (measured: 2e-7 and 1e-7); steps and counts are
equal, and so are the confusion matrices. Batch norm in training mode
is held to flax's BatchNorm at 1e-5 (output) and 1e-6 (mean and biased
variance), at 1e-2 in bfloat16 (its rounding); the schedule to 1e-5
relative (numpy's and XLA's float32 pow differ by a few ulp once the
staircase has decayed hundreds of times); loss_fn and the L2 penalty to
1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from deepvariant_tpu.training import train as jax_train
from deepvariant_tpu.training.config import TrainConfig as JaxConfig
from deepvariant_tpu_torch.models import inception_v3 as iv3
from deepvariant_tpu_torch.training import train as port_train
from deepvariant_tpu_torch.training.config import TrainConfig
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

# One case per row: the optimizer, accumulation, EMA, warmup, label
# smoothing and class weights, each value of each axis at least twice.
MATRIX = [
    ("sgd", 1, True, 0, 0.01, ""),
    ("sgd", 2, False, 2, 0.0, "1,2,10"),
    ("sgd", 2, True, 0, 0.1, ""),
    ("sgd", 1, False, 2, 0.01, "1,1,3"),
    ("adam", 1, True, 0, 0.01, "1,2,10"),
    ("adam", 2, False, 2, 0.01, ""),
    ("adam", 2, True, 2, 0.0, "1,1,3"),
    ("adam", 1, False, 0, 0.1, ""),
    ("rmsprop", 1, True, 2, 0.01, ""),
    ("rmsprop", 2, False, 0, 0.01, "1,2,10"),
    ("rmsprop", 2, True, 0, 0.1, ""),
    ("rmsprop", 1, False, 2, 0.0, "1,1,3"),
]


def _configs(optimizer, accum, ema, warmup, smoothing, class_weights):
    fields = dict(
        optimizer=optimizer, gradient_accumulation_steps=accum,
        use_ema=ema, warmup_steps=warmup, label_smoothing=smoothing,
        class_weights=class_weights, use_mixed_precision=False,
        learning_rate=0.05 if optimizer == "sgd" else 0.01,
        # decay_steps = int(1 * 1.0) = 1: the rate halves every step, so
        # the count each optimizer reads is checked.
        learning_rate_num_epochs_per_decay=1.0,
        learning_rate_decay_rate=0.5, weight_decay=0.01,
        optimizer_weight_decay=0.02 if optimizer == "adam" else 0.0,
        ema_momentum=0.9)
    return JaxConfig(**fields), TrainConfig(**fields)


def _batches(config):
    """Three batches of 4 with the config's class weights."""
    out = []
    weights = config.class_weight_list()
    for i in range(3):
        b = random_batch(4, TWIN_SHAPE, 100 + i)
        b["sample_weights"] = np.asarray(
            [weights[l] if weights else 1.0 for l in b["labels"]],
            np.float32)
        out.append(b)
    return out


@pytest.mark.parametrize("case", MATRIX, ids=lambda c: "-".join(map(str, c)))
def test_twin_three_steps_match_jax(case):
    jax_cfg, cfg = _configs(*case)
    variables = twin_variables(0)
    jmodel, tmodel = JaxTwin(), TorchTwin()
    jtx, _ = jax_train.make_optimizer(jax_cfg, 1)
    ptx, _ = port_train.make_optimizer(cfg, 1)
    jstate = jax_train.init_state(
        jmodel, jax.tree_util.tree_map(jnp.asarray, variables), jtx)
    pstate = port_train.init_state(tmodel, torch_variables(variables), ptx)
    jstep = jax.jit(jax_train.make_train_step(jmodel, jtx, jax_cfg))
    pstep = port_train.make_train_step(tmodel, ptx, cfg)
    jeval = jax.jit(jax_train.make_eval_step(jmodel, jax_cfg))
    peval = port_train.make_eval_step(tmodel, cfg)
    for batch in _batches(cfg):
        before = port_state_tree(pstate)
        jstate, jloss, jcms = jstep(jstate, batch)
        pstate, ploss, pcms = pstep(pstate, to_torch(batch))
        # The step leaves the state it was given as it was.
        assert_trees_close(before, before, 0, 0)
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-6)
        for key in ("all", "snp", "indel"):
            np.testing.assert_array_equal(pcms[key].numpy(),
                                          np.asarray(jcms[key]))
        assert_trees_close(port_state_tree(pstate), jax_state_tree(jstate),
                           rtol=1e-5, atol=1e-6, what=str(case))
        jl, jcm = jeval(jstate, batch)
        pl, pcm = peval(pstate, to_torch(batch))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-6)
        np.testing.assert_array_equal(pcm.numpy(), np.asarray(jcm))
    assert int(pstate["step"]) == 3
    assert pstate["step"].dtype == torch.int32


def test_train_step_leaves_its_input_state_unchanged():
    _, cfg = _configs("adam", 2, True, 0, 0.01, "")
    model = TorchTwin()
    tx, _ = port_train.make_optimizer(cfg, 1)
    state = port_train.init_state(model, torch_variables(twin_variables(0)),
                                  tx)
    before = port_state_tree(state)
    port_train.make_train_step(model, tx, cfg)(
        state, to_torch(_batches(cfg)[0]))
    assert_trees_close(port_state_tree(state), before, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("momentum", [0.9, 0.9997])
def test_batch_norm_training_mode_matches_flax(dtype, momentum):
    """Output, and the running mean and biased variance moved the flax
    way (not torch's unbiased update with the other momentum)."""
    rng = np.random.RandomState(4)
    x = (rng.standard_normal((3, 5, 6, 11)) * 2 + 0.5).astype(np.float32)
    bias = rng.standard_normal(11).astype(np.float32)
    mean0 = rng.standard_normal(11).astype(np.float32)
    var0 = rng.uniform(0.5, 2, 11).astype(np.float32)
    jdtype = getattr(jnp, dtype)
    bn = nn.BatchNorm(use_running_average=False, use_scale=False,
                      epsilon=1e-3, momentum=momentum, dtype=jdtype)
    want, mutated = bn.apply(
        {"params": {"bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x).astype(jdtype), mutable=["batch_stats"])
    port = iv3.BatchNorm(11, momentum)
    with torch.no_grad():
        port.bias.copy_(torch.from_numpy(bias))
        port.mean.copy_(torch.from_numpy(mean0))
        port.var.copy_(torch.from_numpy(var0))
    port.train()
    tdtype = getattr(torch, dtype)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdtype))
    assert got.dtype == tdtype
    got = got.permute(0, 2, 3, 1).float().detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=1e-5 if dtype == "float32" else 1e-2,
                               atol=1e-5 if dtype == "float32" else 1e-2)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(port.mean.numpy(), stats["mean"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(port.var.numpy(), stats["var"], rtol=1e-6,
                               atol=1e-6)
    # Eval mode reads the running statistics.
    port.eval()
    want_eval = bn.clone(use_running_average=True).apply(
        {"params": {"bias": bias}, "batch_stats": stats},
        jnp.asarray(x).astype(jdtype))
    got_eval = port(torch.from_numpy(x).permute(0, 3, 1, 2).to(tdtype))
    np.testing.assert_allclose(
        got_eval.permute(0, 2, 3, 1).float().detach().numpy(),
        np.asarray(want_eval, np.float32),
        rtol=1e-5 if dtype == "float32" else 1e-2,
        atol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("warmup", [0, 7])
def test_lr_schedule_matches_jax(warmup):
    fields = dict(learning_rate=0.01, learning_rate_decay_rate=0.9,
                  learning_rate_num_epochs_per_decay=2.25,
                  warmup_steps=warmup)
    want = jax_train.make_lr_schedule(JaxConfig(**fields), 10)
    got = port_train.make_lr_schedule(TrainConfig(**fields), 10)
    for step in list(range(0, 60)) + [1000, 12345]:
        value = got(step)
        assert value.dtype == np.float32
        np.testing.assert_allclose(value, float(want(jnp.int32(step))),
                                   rtol=1e-5, err_msg=str(step))


@pytest.mark.parametrize("smoothing", [0.0, 0.01, 0.2])
def test_loss_fn_matches_jax(smoothing):
    rng = np.random.RandomState(5)
    logits = rng.standard_normal((9, 3)).astype(np.float32) * 4
    logits[0] = [40.0, -40.0, 0.0]       # a probability under the clip
    probs = np.array(jax.nn.softmax(jnp.asarray(logits)))
    labels = rng.randint(0, 3, 9).astype(np.int32)
    weights = rng.choice([0.0, 1.0, 10.0], 9).astype(np.float32)
    want = jax_train.loss_fn(jnp.asarray(probs), jnp.asarray(labels),
                             jnp.asarray(weights), smoothing)
    got = port_train.loss_fn(torch.from_numpy(probs),
                             torch.from_numpy(labels),
                             torch.from_numpy(weights), smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zero = port_train.loss_fn(torch.from_numpy(probs),
                              torch.from_numpy(labels), torch.zeros(9),
                              smoothing)
    assert float(zero) == 0.0


def test_l2_penalty_covers_every_kernel_and_nothing_else():
    variables = twin_variables(1)
    want = jax_train._l2_kernel_penalty(variables["params"], 0.003)
    params = torch_variables(variables)["params"]
    got = port_train._l2_kernel_penalty(params, 0.003)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert sorted(port_train._kernel_names(params)) == [
        "classification.weight", "stem.conv.weight"]
    names = port_train._kernel_names(dict(iv3.InceptionV3(7).named_parameters()))
    assert len(names) == 95 and all(
        n.endswith("conv.weight") for n in names[:-1])
    assert names[-1] == "classification.weight"
    assert port_train._l2_kernel_penalty(params, 0.0) == 0.0


@pytest.mark.parametrize("weight_decay", [0.0, 0.003])
def test_l2_penalty_and_its_gradient_equal_autograds(weight_decay):
    """The penalty outside autograd's graph, and its gradient added after
    `autograd.grad`, give what autograd gives for the sum of squares."""
    gen = torch.Generator().manual_seed(5)
    params = {"a.conv.weight": torch.randn(4, 3, 3, 3, generator=gen),
              "a.bn.bias": torch.randn(4, generator=gen),
              "head.weight": torch.randn(3, 8, generator=gen)}
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    penalty = weight_decay * torch.stack(
        [leaves[k].square().sum() for k in port_train._kernel_names(leaves)]
    ).sum() if weight_decay else 0.0
    data = sum((v * (i + 1.5)).sum() for i, v in enumerate(leaves.values()))
    want = torch.autograd.grad(data + penalty, list(leaves.values()))
    grads = dict(zip(params, torch.autograd.grad(
        sum((v * (i + 1.5)).sum() for i, v in enumerate(leaves.values())),
        list(leaves.values()))))
    port_train._add_l2_gradient(grads, params, weight_decay)
    for k, w in zip(params, want):
        torch.testing.assert_close(grads[k], w, rtol=1e-6, atol=1e-7)
    got = port_train._l2_kernel_penalty(params, weight_decay)
    assert not torch.is_tensor(got) or not got.requires_grad
    np.testing.assert_allclose(float(got), float(penalty), rtol=1e-6)


def test_step_copies_the_statistics_and_puts_the_model_in_training():
    """The step's statistics are new tensors, and a model left in eval
    mode is put back in training mode."""
    _, cfg = _configs("sgd", 1, False, 0, 0.0, "")
    model = TorchTwin()
    tx, _ = port_train.make_optimizer(cfg, 1)
    state = port_train.init_state(model, torch_variables(twin_variables(0)),
                                  tx)
    step = port_train.make_train_step(model, tx, cfg)
    model.eval()
    new, _, _ = step(state, to_torch(_batches(cfg)[0]))
    assert all(m.training for m in model.modules())
    assert state["batch_stats"].keys() == new["batch_stats"].keys()
    for k, v in state["batch_stats"].items():
        assert new["batch_stats"][k].data_ptr() != v.data_ptr()


def test_optimizer_state_layout_is_optax():
    """init() gives optax's tree (as flax writes it) for each optimizer."""
    variables = twin_variables(0)
    for name in ("sgd", "adam", "rmsprop"):
        jax_cfg, cfg = _configs(name, 1, True, 0, 0.0, "")
        jtx, _ = jax_train.make_optimizer(jax_cfg, 1)
        want = jax_state_tree({"opt": jtx.init(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]))})
        ptx, _ = port_train.make_optimizer(cfg, 1)
        got = port_state_tree({"opt": ptx.init(
            torch_variables(variables)["params"])})
        assert_trees_close(got, want, rtol=0, atol=0, what=name)
    with pytest.raises(ValueError, match="Unknown optimizer"):
        port_train.make_optimizer(TrainConfig(optimizer="lamb"), 1)


def test_dropout_statistics():
    """InceptionV3's head dropout in training mode: about `rate` of the
    features zeroed, the rest scaled by 1/(1 - rate), the same mask from
    the same (seed, step, micro step), another from another; the
    identity in eval mode."""
    h = torch.ones(4000, 2048)
    gen = port_train.dropout_generator(7, 3, 0, torch.device("cpu"))
    out = iv3.dropout(h, 0.2, gen)
    kept = out != 0
    share = 1 - kept.float().mean().item()
    # 8.2M Bernoulli draws: the share is within 0.2 +- 0.001 (7 sigma).
    assert abs(share - 0.2) < 1e-3
    assert torch.all(out[kept] == 1.25)
    again = iv3.dropout(h, 0.2, port_train.dropout_generator(
        7, 3, 0, torch.device("cpu")))
    assert torch.equal(again, out)
    for other in [(7, 4, 0), (7, 3, 1), (8, 3, 0)]:
        differs = iv3.dropout(h, 0.2, port_train.dropout_generator(
            *other, torch.device("cpu")))
        assert not torch.equal(differs, out)
    # Per-column shares: no feature is favoured.
    per_feature = 1 - kept.float().mean(0)
    assert per_feature.min() > 0.13 and per_feature.max() < 0.27

    model = iv3.InceptionV3(7, dropout_rate=0.5)
    x = torch.zeros(2, 100, 221, 7)
    model.eval()
    with torch.no_grad():
        a = model.logits(x, port_train.dropout_generator(
            0, 0, 0, torch.device("cpu")))
        b = model.logits(x)
    assert torch.equal(a, b)
    assert model.dropout_rate == 0.5
    assert iv3.InceptionV3(7).dropout_rate == 0.2


@pytest.mark.parametrize("channels_last", [False, True])
def test_avg_pool_backward_is_the_pool_of_the_gradient(channels_last):
    """InceptionV3's SAME 3x3 average pool takes its own backward (the
    box filter is self-adjoint): equal to torch's avg_pool2d gradient on
    the CPU, and gradcheck-exact in float64."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, 9)))
    g = torch.from_numpy(rng.standard_normal((2, 5, 7, 9)))
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    want, = torch.autograd.grad(torch.nn.functional.avg_pool2d(
        x, 3, 1, 1, count_include_pad=True), x, g)
    out = iv3._avg_pool_same(x)
    got, = torch.autograd.grad(out, x, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-15)
    assert torch.autograd.gradcheck(iv3._avg_pool_same, (x,))


def test_batch_norm_training_mode_takes_one_value_per_channel():
    """A batch of one at a 1x1 grid, which flax normalizes to its bias
    (variance 0) and torch's F.batch_norm would refuse."""
    bias = np.asarray([0.5, -1.0, 2.0], np.float32)
    x = np.asarray([[[[3.0, -2.0, 7.0]]]], np.float32)    # NHWC
    bn = nn.BatchNorm(use_running_average=False, use_scale=False,
                      epsilon=1e-3, momentum=0.9)
    want, mutated = bn.apply(
        {"params": {"bias": bias},
         "batch_stats": {"mean": np.zeros(3, np.float32),
                         "var": np.ones(3, np.float32)}},
        jnp.asarray(x), mutable=["batch_stats"])
    port = iv3.BatchNorm(3, 0.9)
    with torch.no_grad():
        port.bias.copy_(torch.from_numpy(bias))
    port.train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    # torch's CPU kernel leaves a rounding residue of the mean (4e-6 at
    # the output, against 1/sqrt(eps) = 31.6).
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.var.numpy(),
                               mutated["batch_stats"]["var"], rtol=1e-6)

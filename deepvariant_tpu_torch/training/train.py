"""The training loop for the InceptionV3 genotype classifier, on the card.

The port of `deepvariant_tpu/training/train.py` (the reference's TF2
custom loop, train.py:98-773), with the same numbers in the same order:

  * keras SGD(nesterov, momentum, use_ema), Adam(W) and RMSprop -> the
    formulas of optax's chains (`sgd`, `adamw`, `rmsprop`), written with
    torch's multi-tensor `_foreach` ops; no `torch.optim` class, whose
    formulas differ (RMSprop's eps outside the root, momentum before the
    learning rate), is used. The optimizer state is optax's tree: a
    chain's tuple as {"0": ..., "1": ...}, a state by its fields,
    EmptyState as {}.
  * ExponentialDecay(staircase) + LinearWarmup (train.py:231-260) ->
    optax's `join_schedules` of a linear warmup and the staircase decay,
    evaluated in float32 at the count before its increment.
  * CategoricalCrossentropy(label_smoothing) over softmax outputs with
    per-example sample weights + L2 over every conv and dense kernel
    (keras_modeling.add_l2_regularizers) -> `loss_fn` + `_l2_kernel_penalty`.
  * Gradient accumulation: the batch split contiguously into micro
    batches, batch-norm statistics threaded from one to the next,
    float32 gradients summed and scaled once, one optimizer update.
  * EMA of the parameters after each update; the eval step reads it.
  * Checkpoints: the full TrainState in flax's msgpack layout, which
    the JAX package's `load_checkpoint` reads, + example_info.json.

The state is a dict laid out as the JAX package's TrainState: `params`,
`batch_stats` and `ema_params` map the model's state-dict names to
float32 tensors on the device (conv weights channels_last), `opt_state`
is optax's tree over such maps, and `step` and optax's counts are int32
scalars kept on the host, so the schedule and the dropout seed need no
round trip to the card. Dropout draws from a generator seeded from
(seed, step, micro step): torch cannot draw JAX's masks.

Data parallelism (JAX: `data_parallel_mesh` + `shard_train_step`, a jit
over a batch sharded on a `data` mesh axis) is one process per device
under torch.distributed (`parallel.distribute.DataParallel`): every rank
holds the replicated state and its rows of each global batch
(`DataParallel.local_rows`: its part of every micro batch), and the step
computes what the one-rank step computes on the global batch, up to
float32 summation order. Batch norm takes the global batch's statistics
(`inception_v3.sync_batch_norm`), each rank's loss term divides by the
global weight sum, the L2 penalty is added on rank 0 only, and the
gradients, the micro losses and the confusion matrices are summed over
the ranks in one flat all-reduce; every rank then applies the same
update. `train()` runs over the group: rank 0 writes the checkpoints.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from deepvariant_tpu_torch.device import full_float32_precision
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.models import checkpoint as ckpt_lib
from deepvariant_tpu_torch.models.inception_v3 import (
    create_model,
    normalize_pileup,
    sync_batch_norm,
)
from deepvariant_tpu_torch.ops import batch_norm_relu, pool
from deepvariant_tpu_torch.parallel.distribute import (
    DataParallel,
    data_parallel_mesh,
)
from deepvariant_tpu_torch.training import metrics as metrics_lib
from deepvariant_tpu_torch.training.config import TrainConfig
from deepvariant_tpu_torch.training.data import Batch, DatasetConfig, input_fn
from deepvariant_tpu_torch.utils import trace

NUM_CLASSES = 3
INT32_MAX = np.iinfo(np.int32).max

Tree = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Schedule and optimizers (optax's formulas)
# ---------------------------------------------------------------------------

def make_lr_schedule(config: TrainConfig, steps_per_epoch: int):
    """LinearWarmup into staircase ExponentialDecay (train.py:231-260):
    count -> float32 learning rate, as optax evaluates it."""
    decay_steps = max(
        int(steps_per_epoch * config.learning_rate_num_epochs_per_decay), 1
    )
    lr = np.float32(config.learning_rate)
    rate = np.float32(config.learning_rate_decay_rate)

    def exp_decay(step: int) -> np.float32:
        return np.float32(lr * np.power(rate, np.float32(step // decay_steps)))

    if config.warmup_steps <= 0:
        return exp_decay
    # optax.linear_schedule(lr / 10, lr, warmup_steps), joined at
    # warmup_steps: the decay sees the count minus the boundary.
    warmup_steps = config.warmup_steps
    init_value = config.learning_rate / 10
    end_value = config.learning_rate

    def schedule(step: int) -> np.float32:
        if step >= warmup_steps:
            return exp_decay(step - warmup_steps)
        count = min(max(step, 0), warmup_steps)
        frac = np.float32(1) - np.float32(count) / np.float32(warmup_steps)
        return np.float32(np.float32(init_value - end_value) * frac
                          + np.float32(end_value))

    return schedule


def _count(value: int) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32)


def _increment(count: torch.Tensor) -> torch.Tensor:
    """optax's safe_increment: saturates at the int32 maximum."""
    return _count(min(int(count) + 1, INT32_MAX))


def _keys(tree: Tree) -> List[str]:
    return list(tree)


def _values(tree: Tree, keys: List[str]) -> List[torch.Tensor]:
    return [tree[k] for k in keys]


def _zeros(tree: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


class Optimizer:
    """An optax chain's `init` and `update` over {name: tensor} trees.

    `update(grads, state, params)` returns (updates, new state), and
    `apply_updates` adds them, as `tx.update` and `optax.apply_updates`
    do; nothing is changed in place."""

    def __init__(self, name: str, config: TrainConfig,
                 schedule: Callable[[int], np.float32]):
        if name not in ("sgd", "adam", "rmsprop"):
            raise ValueError(f"Unknown optimizer: {name}")
        self.name = name
        self.config = config
        self.schedule = schedule

    def init(self, params: Tree) -> dict:
        if self.name == "sgd":
            return {"0": {"trace": _zeros(params)}, "1": {"count": _count(0)}}
        if self.name == "adam":
            return {"0": {"count": _count(0), "mu": _zeros(params),
                          "nu": _zeros(params)},
                    "1": {}, "2": {"count": _count(0)}}
        # scale_by_rms with initial_scale 0, no bias correction.
        return {"0": {"nu": _zeros(params)}, "1": {"count": _count(0)},
                "2": {"trace": _zeros(params)}}

    def _step_size(self, count: torch.Tensor) -> float:
        # scale_by_learning_rate: -1 * schedule(count), in float32.
        return float(-self.schedule(int(count)))

    def update(self, grads: Tree, state: dict, params: Tree):
        keys = _keys(grads)
        g = _values(grads, keys)
        c = self.config
        if self.name == "sgd":
            # trace(momentum, nesterov=True), then the learning rate.
            m = c.momentum
            trace = torch._foreach_add(
                g, torch._foreach_mul(_values(state["0"]["trace"], keys), m))
            u = torch._foreach_add(g, torch._foreach_mul(trace, m))
            count = state["1"]["count"]
            u = torch._foreach_mul(u, self._step_size(count))
            new_state = {"0": {"trace": dict(zip(keys, trace))},
                         "1": {"count": _increment(count)}}
        elif self.name == "adam":
            # scale_by_adam (eps outside the root, eps_root 0), then
            # add_decayed_weights, then the learning rate.
            b1, b2 = c.beta_1, c.beta_2
            mu = torch._foreach_add(
                torch._foreach_mul(g, 1 - b1),
                torch._foreach_mul(_values(state["0"]["mu"], keys), b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                torch._foreach_mul(_values(state["0"]["nu"], keys), b2))
            count_inc = _increment(state["0"]["count"])
            k = np.float32(int(count_inc))
            bc1 = float(np.float32(1) - np.power(np.float32(b1), k))
            bc2 = float(np.float32(1) - np.power(np.float32(b2), k))
            denom = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, bc2)), c.epsilon)
            u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if c.optimizer_weight_decay:
                u = torch._foreach_add(u, torch._foreach_mul(
                    _values(params, keys), c.optimizer_weight_decay))
            count = state["2"]["count"]
            u = torch._foreach_mul(u, self._step_size(count))
            new_state = {"0": {"count": count_inc, "mu": dict(zip(keys, mu)),
                               "nu": dict(zip(keys, nu))},
                         "1": {}, "2": {"count": _increment(count)}}
        else:
            # scale_by_rms (eps inside the root), the learning rate, then
            # trace(momentum): the momentum runs over lr-scaled steps.
            rho = c.rho
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - rho),
                torch._foreach_mul(_values(state["0"]["nu"], keys), rho))
            u = torch._foreach_mul(
                torch._foreach_rsqrt(torch._foreach_add(nu, c.epsilon)), g)
            count = state["1"]["count"]
            u = torch._foreach_mul(u, self._step_size(count))
            u = torch._foreach_add(u, torch._foreach_mul(
                _values(state["2"]["trace"], keys), c.momentum))
            new_state = {"0": {"nu": dict(zip(keys, nu))},
                         "1": {"count": _increment(count)},
                         "2": {"trace": dict(zip(keys, u))}}
        return dict(zip(keys, u)), new_state


def apply_updates(params: Tree, updates: Tree) -> Tree:
    keys = _keys(params)
    return dict(zip(keys, torch._foreach_add(_values(params, keys),
                                             _values(updates, keys))))


def make_optimizer(config: TrainConfig, steps_per_epoch: int):
    schedule = make_lr_schedule(config, steps_per_epoch)
    return Optimizer(config.optimizer, config, schedule), schedule


def _kernel_names(params: Tree) -> List[str]:
    """The flax `kernel` leaves: every conv and dense weight."""
    return [k for k in params if k.endswith("weight")]


def _l2_kernel_penalty(params: Tree, weight_decay: float):
    """Sum of L2 over every conv/dense kernel (keras add_l2_regularizers),
    without a graph: each kernel's norm in one multi-tensor op, squared."""
    if not weight_decay:
        return 0.0
    with torch.no_grad():
        norms = torch._foreach_norm([params[k].float()
                                     for k in _kernel_names(params)])
        return weight_decay * torch.stack(norms).square().sum()


def _add_l2_gradient(grads: Tree, params: Tree, weight_decay: float):
    """Adds the L2 penalty's gradient, 2 * weight_decay * kernel, to each
    kernel's gradient in place, in one multi-tensor op."""
    if weight_decay:
        names = _kernel_names(params)
        with torch.no_grad():
            torch._foreach_add_(_values(grads, names),
                                _values(params, names),
                                alpha=2.0 * weight_decay)


def _copies(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """New tensors equal to `tensors`, copied in one multi-tensor op."""
    out = [torch.empty_like(t) for t in tensors]
    if out:
        torch._foreach_copy_(out, tensors)
    return out


def weighted_loss_sum(
    probabilities: torch.Tensor,
    labels: torch.Tensor,
    sample_weights: torch.Tensor,
    label_smoothing: float,
) -> torch.Tensor:
    """The numerator of `loss_fn`: the weighted cross-entropy summed over
    the batch."""
    onehot = F.one_hot(labels.long(), NUM_CLASSES).to(torch.float32)
    if label_smoothing:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / \
            NUM_CLASSES
    logp = torch.log(torch.clamp(probabilities, 1e-7, 1.0))
    per_example = -torch.sum(onehot * logp, dim=-1) * sample_weights
    return torch.sum(per_example)


def loss_fn(
    probabilities: torch.Tensor,
    labels: torch.Tensor,
    sample_weights: torch.Tensor,
    label_smoothing: float,
    weight_total: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted categorical cross-entropy over softmax outputs: the log
    of the probabilities clipped to [1e-7, 1], not log_softmax, as the
    JAX package computes it (the gradients differ where the clip bites).
    compute_average_loss semantics: the sum over the global weight sum,
    which is `weight_total` where this batch is one rank's part."""
    if weight_total is None:
        weight_total = torch.sum(sample_weights)
    return weighted_loss_sum(probabilities, labels, sample_weights,
                             label_smoothing) / torch.clamp_min(
        weight_total, 1e-6)


def dropout_seed(seed: int, step: int, micro: int, rank: int = 0) -> int:
    """The seed of one micro step's dropout generator, from (seed, step,
    micro step, rank) so that a run is deterministic; rank 0 draws what
    the one-rank step draws."""
    entropy = [seed, step, micro] + ([rank] if rank else [])
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def dropout_generator(seed: int, step: int, micro: int,
                      device: torch.device, rank: int = 0
                      ) -> torch.Generator:
    """A generator for one micro step's dropout masks, seeded with
    `dropout_seed`."""
    generator = torch.Generator(device=device)
    generator.manual_seed(dropout_seed(seed, step, micro, rank))
    return generator


class _MicroGraph:
    """One micro-batch's forward and backward, `run(leaves, batch_stats,
    micro_batch, generator)`, captured once as a CUDA graph over static
    copies of its inputs, and replayed for every later micro-batch of the
    same shapes: one launch where the eager call makes about a thousand,
    so the host no longer paces the card.

    A call copies its inputs in, seeds the graph's dropout generator
    (registered with the graph, so a replay draws what a fresh generator
    with that seed draws), replays, copies batch norm's running
    statistics back into `batch_stats` and returns new tensors. The
    replay runs the eager call's kernels on the same inputs, so it
    computes what the eager call computes. The port's kernel launch
    counters move by the captured launches on every replay."""

    def __init__(self, run, params: Tree, batch_stats: Tree,
                 micro_batch: Dict[str, torch.Tensor]):
        device = next(iter(params.values())).device
        self.leaves = {k: v.detach().clone().requires_grad_(True)
                       for k, v in params.items()}
        self.stats = {k: v.clone() for k, v in batch_stats.items()}
        self.batch = {k: v.clone() for k, v in micro_batch.items()}
        self.generator = torch.Generator(device=device)
        args = (self.leaves, self.stats, self.batch, self.generator)
        self.counters = (batch_norm_relu.batch_norm_relu, pool.box3x3,
                         pool.max3x3s2)
        before = [c.launches for c in self.counters]
        # torch's rule for a capture: warm up on a side stream first.
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run(*args)
        torch.cuda.current_stream(device).wait_stream(side)
        warm = [c.launches for c in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        with torch.cuda.graph(self.graph):
            self.out = run(*args)
        # Each micro-batch counts its launches once: the warm-up and the
        # capture are not counted, every replay is.
        self.launches = []
        for counter, n, w in zip(self.counters, before, warm):
            self.launches.append(counter.launches - w)
            counter.launches = n

    def __call__(self, params: Tree, batch_stats: Tree,
                 micro_batch: Dict[str, torch.Tensor], seed: int):
        leaf_keys, stat_keys = _keys(self.leaves), _keys(self.stats)
        with torch.no_grad():
            torch._foreach_copy_(_values(self.leaves, leaf_keys),
                                 _values(params, leaf_keys))
            if stat_keys:
                torch._foreach_copy_(_values(self.stats, stat_keys),
                                     _values(batch_stats, stat_keys))
            for k, v in self.batch.items():
                v.copy_(micro_batch[k])
        self.generator.manual_seed(seed)
        self.graph.replay()
        for counter, n in zip(self.counters, self.launches):
            counter.launches += n
        data, penalty, probs, grads = self.out
        if stat_keys:
            with torch.no_grad():
                torch._foreach_copy_(_values(batch_stats, stat_keys),
                                     _values(self.stats, stat_keys))
        return (data.clone(),
                penalty.clone() if torch.is_tensor(penalty) else penalty,
                probs.clone(),
                dict(zip(leaf_keys, _copies(_values(grads, leaf_keys)))))


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _confusions(labels, preds, variant_types) -> Dict[str, torch.Tensor]:
    empty = metrics_lib.empty_confusion(labels.device)
    return {
        "all": metrics_lib.confusion_update(empty, labels, preds),
        "snp": metrics_lib.confusion_update(
            empty, labels, preds,
            variant_types == metrics_lib.VARIANT_TYPE_SNP),
        "indel": metrics_lib.confusion_update(
            empty, labels, preds,
            variant_types == metrics_lib.VARIANT_TYPE_INDEL),
    }


def make_train_step(model: torch.nn.Module, tx: Optimizer,
                    config: TrainConfig,
                    data_parallel: Optional[DataParallel] = None):
    """Returns `train_step(state, batch) -> (new state, loss, confusion
    matrices)`, `batch` a dict of tensors on the state's device.

    `model` is the architecture: `functional_call` runs it in training
    mode on the state's tensors, its own weights unused. With
    config.gradient_accumulation_steps > 1 the batch is split into that
    many contiguous micro-batches run one after another: the float32
    gradients are summed and scaled by 1/accum, the loss is the mean of
    the micro losses (each with the L2 penalty), the batch-norm running
    statistics move once per micro-batch, and the optimizer applies one
    update. The state's batch_stats are copied first, so the state passed
    in is left as it was.

    With `data_parallel` in a process group, `batch` is this rank's rows
    of the global batch (`DataParallel.local_batch` with the same
    accumulation), and the step returns on every rank what the one-rank
    step returns for the global batch: the new replicated state, the
    global loss and the global confusion matrices.

    Its phases are `utils.trace` spans: `train.step` (the state's step
    is its identifier) around `train.forward` (the pileup's
    normalization through the loss and L2 penalty) and `train.backward`
    (`torch.autograd.grad`), once per micro-batch, and `train.update`
    (the optimizer, `apply_updates` and the EMA).

    On one card (no `data_parallel`) the micro-batch's forward and
    backward run as a CUDA graph (`_MicroGraph`) from the second call of
    its shape on, with the same results bit for bit; the optimizer and
    the EMA run eagerly. While spans record, the eager path runs."""
    accum = max(int(getattr(
        config, "gradient_accumulation_steps", 1) or 1), 1)
    dp = data_parallel if data_parallel is not None and \
        data_parallel.grouped else None
    rank = dp.rank if dp is not None else 0
    # The eager step's host time can pace the card, so what runs on every
    # step is kept cheap: the module walks of train() and sync_batch_norm
    # only where they change something.
    modules = list(model.modules())

    def forward_backward(leaves, batch_stats, micro_batch, generator,
                         weight_total=None):
        with trace.span("train.forward"):
            x = normalize_pileup(micro_batch["images"], model.compute_dtype)
            # InceptionV3 ties no weights: no search for ties.
            probs = functional_call(model, {**leaves, **batch_stats}, (x,),
                                    {"generator": generator},
                                    tie_weights=False)
            data = loss_fn(
                probs,
                micro_batch["labels"],
                micro_batch["sample_weights"],
                config.label_smoothing,
                weight_total,
            )
            # The penalty and its gradient leave autograd's graph: some
            # five hundred launches a step fewer. Over ranks the penalty
            # enters the gradient sum once.
            penalty = _l2_kernel_penalty(leaves, config.weight_decay)
        with trace.span("train.backward"):
            grads = dict(zip(leaves, torch.autograd.grad(
                data, list(leaves.values()))))
            if rank == 0:
                _add_l2_gradient(grads, leaves, config.weight_decay)
        return data.detach(), penalty, probs.detach(), grads

    # The graph is captured on the second call of a shape (the first
    # warms the kernels up); one graph, other shapes run eagerly. While
    # spans record (a profiler), the eager call runs, so that they see
    # its phases.
    graphs: Dict[tuple, _MicroGraph] = {}
    seen = set()

    def micro_grad(params, batch_stats, micro_batch, seed, weight_total):
        device = next(iter(params.values())).device
        if device.type == "cuda" and dp is None and not trace.on():
            key = tuple((k, v.shape, v.dtype, v.stride())
                        for k, v in micro_batch.items())
            if key in seen and not graphs:
                graphs[key] = _MicroGraph(forward_backward, params,
                                          batch_stats, micro_batch)
            if key in graphs:
                return graphs[key](params, batch_stats, micro_batch, seed)
            seen.add(key)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        return forward_backward(leaves, batch_stats, micro_batch, generator,
                                weight_total)

    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        step = int(state["step"])
        with trace.span("train.step", step):
            return apply_step(state, batch, step)

    def apply_step(state, batch, step):
        if not all(m.training for m in modules):
            model.train()
        params = state["params"]
        stats_keys = _keys(state["batch_stats"])
        batch_stats = dict(zip(stats_keys, _copies(
            _values(state["batch_stats"], stats_keys))))
        size = batch["labels"].shape[0] // accum
        micros = [{k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                  for i in range(accum)]
        totals = [None] * accum
        if dp is not None:
            totals = dp.all_reduce_sum(torch.stack(
                [m["sample_weights"].sum() for m in micros]))
        grad_sum, data_losses, penalties, all_probs = None, [], [], []
        with sync_batch_norm(model, dp.gather_over_ranks) if dp else \
                contextlib.nullcontext():
            for i, micro in enumerate(micros):
                data_i, penalty_i, probs_i, g = micro_grad(
                    params, batch_stats, micro,
                    dropout_seed(config.seed, step, i, rank),
                    totals[i])
                if grad_sum is None:
                    grad_sum = g
                else:
                    keys = _keys(grad_sum)
                    grad_sum = dict(zip(keys, torch._foreach_add(
                        _values(grad_sum, keys), _values(g, keys))))
                data_losses.append(data_i)
                penalties.append(penalty_i)
                all_probs.append(probs_i)
        probs = torch.cat(all_probs)
        cms = _confusions(batch["labels"], torch.argmax(probs, dim=-1),
                          batch["variant_types"])
        data_losses = torch.stack(data_losses)
        if dp is not None:
            data_losses, cms = _sum_over_ranks(dp, grad_sum, data_losses,
                                               cms)
        loss = data_losses[0] + penalties[0]
        for i in range(1, accum):
            loss = loss + (data_losses[i] + penalties[i])
        grads = grad_sum
        if accum > 1:
            inv = float(np.float32(1.0 / accum))
            keys = _keys(grad_sum)
            grads = dict(zip(keys, torch._foreach_mul(
                _values(grad_sum, keys), inv)))
            loss = loss * inv
        with trace.span("train.update"):
            updates, new_opt_state = tx.update(grads, state["opt_state"],
                                               params)
            new_params = apply_updates(params, updates)
            if config.use_ema:
                keys = _keys(new_params)
                decay = config.ema_momentum
                new_ema = dict(zip(keys, torch._foreach_add(
                    torch._foreach_mul(_values(state["ema_params"], keys),
                                       decay),
                    torch._foreach_mul(_values(new_params, keys),
                                       1.0 - decay))))
            else:
                new_ema = new_params
        new_state = {
            "params": new_params,
            "batch_stats": batch_stats,
            "opt_state": new_opt_state,
            "ema_params": new_ema,
            "step": _count(step + 1),
        }
        return new_state, loss, cms

    return train_step


def _sum_over_ranks(dp: DataParallel, grads: Tree,
                    data_losses: torch.Tensor,
                    cms: Dict[str, torch.Tensor]):
    """Sum this rank's gradients (in place), micro losses and confusion
    matrices over the ranks in one flat all-reduce."""
    keys = _keys(grads)
    dtype = grads[keys[0]].dtype
    names = list(cms)
    flat = torch.cat([grads[k].reshape(-1) for k in keys]
                     + [data_losses.to(dtype)]
                     + [cms[n].reshape(-1).to(dtype) for n in names])
    dp.all_reduce_sum(flat)
    offset = 0
    for k in keys:
        g = grads[k]
        g.copy_(flat[offset:offset + g.numel()].view(g.shape))
        offset += g.numel()
    n = data_losses.numel()
    data_losses = flat[offset:offset + n].to(data_losses.dtype)
    offset += n
    summed = {}
    for name in names:
        cm = cms[name]
        summed[name] = flat[offset:offset + cm.numel()].view(
            cm.shape).to(cm.dtype)
        offset += cm.numel()
    return data_losses, summed


def make_eval_step(model: torch.nn.Module, config: TrainConfig,
                   data_parallel: Optional[DataParallel] = None):
    """Returns `eval_step(state, batch) -> (loss, confusion matrix)`;
    with `data_parallel` in a group, over the global batch of which
    `batch` is this rank's rows."""
    dp = data_parallel if data_parallel is not None and \
        data_parallel.grouped else None

    @torch.no_grad()
    def eval_step(state: dict, batch: Dict[str, torch.Tensor]):
        model.eval()
        params = state["ema_params"] if config.use_ema else state["params"]
        x = normalize_pileup(batch["images"], model.compute_dtype)
        probs = functional_call(model, {**params, **state["batch_stats"]},
                                (x,))
        preds = torch.argmax(probs, dim=-1)
        cm = metrics_lib.confusion_update(
            metrics_lib.empty_confusion(probs.device), batch["labels"],
            preds, mask=batch["sample_weights"] > 0,
        )
        if dp is None:
            return loss_fn(probs, batch["labels"], batch["sample_weights"],
                           config.label_smoothing), cm
        numerator = weighted_loss_sum(probs, batch["labels"],
                                      batch["sample_weights"],
                                      config.label_smoothing)
        flat = dp.all_reduce_sum(torch.cat([
            numerator.reshape(1), batch["sample_weights"].sum().reshape(1),
            cm.reshape(-1).to(numerator.dtype)]))
        return (flat[0] / torch.clamp_min(flat[1], 1e-6),
                flat[2:].view(cm.shape).to(cm.dtype))

    return eval_step


# ---------------------------------------------------------------------------
# State and checkpoints
# ---------------------------------------------------------------------------

def model_variables(model: torch.nn.Module,
                    device: Union[str, torch.device]) -> Dict[str, Tree]:
    """{params, batch_stats} of `model` as float32 tensors on `device`
    (4-d weights channels_last, the layout cuDNN's NHWC convs read)."""

    def place(t):
        t = t.detach().to(device=device, dtype=torch.float32)
        if t.dim() == 4:
            t = t.contiguous(memory_format=torch.channels_last)
        return t.clone()

    return {
        "params": {k: place(v) for k, v in model.named_parameters()},
        "batch_stats": {k: place(v) for k, v in model.named_buffers()},
    }


def init_state(model: torch.nn.Module, variables: Dict[str, Tree],
               tx: Optimizer) -> dict:
    params = variables["params"]
    return {
        "params": params,
        "batch_stats": variables["batch_stats"],
        "opt_state": tx.init(params),
        "ema_params": {k: v.clone() for k, v in params.items()},
        "step": _count(0),
    }


def save_checkpoint(path: str, state: dict,
                    example_info: Optional[dict] = None):
    """The full TrainState in flax's msgpack layout (what the JAX
    package's `save_checkpoint` writes), + example_info.json beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ckpt_lib.save_train_state(path, state)
    if example_info is not None:
        with open(os.path.join(os.path.dirname(path),
                               "example_info.json"), "w") as f:
            json.dump(example_info, f)


def load_checkpoint(path: str, template_state: dict) -> dict:
    return ckpt_lib.load_train_state(path, template_state)


def _to_device(batch: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def training_model(config: TrainConfig, input_shape, device: torch.device):
    """(model, variables) for `train` and `train_resident`: the model
    built by `create_model` in float32 on the CPU (its master weights
    go to `device`), computing in bfloat16 under use_mixed_precision."""
    model = create_model(
        input_shape[2], height=input_shape[0], width=input_shape[1],
        dtype=torch.float32, bn_momentum=config.bn_momentum, device="cpu",
    )
    variables = model_variables(model, device)
    model.dtype = (torch.bfloat16 if config.use_mixed_precision
                   else torch.float32)
    return model, variables


# ---------------------------------------------------------------------------
# Main loop
# ---------------------------------------------------------------------------

def train(
    config: TrainConfig,
    experiment_dir: str,
    device: Union[str, torch.device] = "cuda",
    max_steps: Optional[int] = None,
    log_fn=print,
    data_parallel: Optional[DataParallel] = None,
) -> Dict[str, float]:
    """Full training run; returns final tune metrics.

    In a process group (`initialize_multihost`, e.g. under torchrun) it
    trains data-parallel: every rank reads the same batches (the same
    seed) and takes its rows of each, the metrics are the global batch's,
    and only rank 0 writes checkpoints and example_info.json."""
    dp = data_parallel or data_parallel_mesh(device)
    device = dp.device
    full_float32_precision()
    train_ds_cfg = DatasetConfig.read(config.train_dataset_config)
    tune_ds_cfg = DatasetConfig.read(config.tune_dataset_config)

    # example_info.json contract (train.py:139-185).
    first_train_file = train_ds_cfg.tfrecord_path.split(",")[0]
    example_info = example_codec.read_example_info(first_train_file)
    input_shape = example_info["shape"]

    steps_per_epoch = max(
        train_ds_cfg.num_examples // config.batch_size, 1
    )
    steps_per_tune = max(
        (min(config.num_validation_examples, tune_ds_cfg.num_examples)
         or tune_ds_cfg.num_examples) // config.batch_size, 1
    )
    if config.limit:
        steps_per_epoch = min(steps_per_epoch, config.limit)
        steps_per_tune = min(steps_per_tune, config.limit)

    model, variables = training_model(config, input_shape, device)
    tx, schedule = make_optimizer(config, steps_per_epoch)
    state = init_state(model, variables, tx)
    if config.init_checkpoint:
        state = load_checkpoint(config.init_checkpoint, state)

    step_fn = make_train_step(model, tx, config, dp)
    eval_fn = make_eval_step(model, config, dp)
    accum = max(int(config.gradient_accumulation_steps or 1), 1)

    def local(batch: Batch, accum: int = 1) -> Dict[str, torch.Tensor]:
        return _to_device(dp.local_batch(_batch_dict(batch), accum), device)

    ckpt_dir = os.path.join(experiment_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)

    train_iter = input_fn(train_ds_cfg.tfrecord_path, config, mode="train")
    best_metric = -float("inf")
    patience = 0
    total_steps = 0
    results: Dict[str, float] = {}

    for epoch in range(config.num_epochs):
        cm_all = metrics_lib.empty_confusion(device)
        losses = []
        t0 = time.time()
        for _ in range(steps_per_epoch):
            batch = next(train_iter)
            state, loss, cms = step_fn(state, local(batch, accum))
            losses.append(loss)
            cm_all += cms["all"]
            total_steps += 1
            if max_steps and total_steps >= max_steps:
                break
        train_metrics = metrics_lib.metrics_from_confusion(
            cm_all.cpu().numpy(), prefix="train/"
        )
        train_metrics["train/loss"] = float(np.mean(
            torch.stack(losses).cpu().numpy()))
        dt = time.time() - t0
        train_metrics["train/examples_per_sec"] = (
            steps_per_epoch * config.batch_size / max(dt, 1e-9)
        )

        # Tune pass.
        tune_cm = metrics_lib.empty_confusion(device)
        tune_losses = []
        for i, batch in enumerate(
            input_fn(tune_ds_cfg.tfrecord_path, config, mode="tune")
        ):
            if i >= steps_per_tune:
                break
            loss, cm = eval_fn(state, local(batch))
            tune_losses.append(loss)
            tune_cm += cm
        tune_metrics = metrics_lib.metrics_from_confusion(
            tune_cm.cpu().numpy(), prefix="tune/"
        )
        if tune_losses:
            tune_metrics["tune/loss"] = float(
                np.mean(torch.stack(tune_losses).cpu().numpy())
            )
        results = {**train_metrics, **tune_metrics}
        log_fn(f"epoch {epoch}: " + json.dumps(
            {k: round(v, 5) for k, v in results.items()}))

        # The metrics are global, so every rank decides alike; rank 0
        # writes and the others wait for it.
        metric_val = results.get(config.best_checkpoint_metric, 0.0)
        is_best = metric_val > best_metric
        if dp.rank == 0:
            save_checkpoint(
                os.path.join(ckpt_dir, f"ckpt-{epoch}.msgpack"),
                state, example_info,
            )
            # Keep only the latest epoch checkpoint plus best.msgpack
            # (the reference's CheckpointManager max_to_keep analog);
            # a full InceptionV3 state is ~260 MB per epoch otherwise.
            prev = os.path.join(ckpt_dir, f"ckpt-{epoch - 1}.msgpack")
            if epoch > 0 and os.path.exists(prev):
                os.unlink(prev)
            if is_best:
                shutil.copyfile(
                    os.path.join(ckpt_dir, f"ckpt-{epoch}.msgpack"),
                    os.path.join(ckpt_dir, "best.msgpack"),
                )
        dp.barrier()
        if is_best:
            best_metric = metric_val
            patience = 0
        else:
            patience += 1
            if patience >= config.early_stopping_patience:
                log_fn(f"early stopping at epoch {epoch}")
                break
        if max_steps and total_steps >= max_steps:
            break
    return results


def _batch_dict(batch: Batch) -> Dict[str, np.ndarray]:
    return {
        "images": batch.images,
        "labels": batch.labels,
        "sample_weights": batch.sample_weights,
        "variant_types": batch.variant_types,
    }

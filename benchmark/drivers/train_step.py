"""Training: the port's single-device train step over a resident corpus.

What `train_resident` runs: the whole corpus of seeded examples on the
card, each step's batch gathered there by a seeded permutation (a new
one each epoch), and `make_train_step`'s step (InceptionV3 in training
mode with bfloat16 convolutions and float32 master weights, the
configuration's loss, L2 penalty, optimizer and EMA) applied to it.

Set-up builds the state and the step once, and drives them through the
first three steps on three disjoint batches of the first epoch's
permutation (which also warm every shape up); the window goes on from
there with the same state and step.

End-to-end: `train_examples_per_s`, the examples of the steps that
finished on the card inside the window (CUDA events) over the window;
`setup_s`.

Correct: the reference follows the first three steps from the same
weights on the same batches in float32. Read leaf by leaf: the first
step's gradient (from the optimizer's state after it), and after the
first and the third step each parameter's change, the change of its
moving average (EMA), the change of batch norm's running statistics and
the optimizer's moments, each by the gap of the two norms and by the
norm of the difference; and after those steps the counts of [label,
predicted class] over the batch's rows. The cell's limits file names the
numbers compared.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from benchmark import compare, plans, roofline
from benchmark.harness import Check, Outcome, done_in_window
from benchmark.reference import inception_v3 as ref_net
from benchmark.reference import paint as ref_paint
from benchmark.reference import train as ref_train
from benchmark.tracing import Spans, Trace
from benchmark.weights import seeded_weights

CHECK_STEPS = 3
# The steps after which the state is compared.
READ_AFTER = (1, CHECK_STEPS)
# Batch norm's biases start around +1.5, so that most ReLUs pass: a
# random network at bias 0 is chaotic in training mode (float32 rounding
# alone moves its early layers' gradients by percents), and its first
# steps then differ from the reference as much in bfloat16 as one
# precision lower, so no comparison could tell the two apart.
BN_BIAS = 1.5


def corpus(n, cfg, tr, seed, device):
    """n seeded examples on the card: plans painted by the reference
    painter, their genotype labels, class weights and variant types."""
    p = cfg["pileup"]
    stacked = plans.make_plans(n, cfg, tr, seed, device)
    colors = ref_paint.Colors(p)
    diff = plans.diff_mode(p)
    images = torch.empty((n, p["height"], p["width"], plans.planes(p)),
                         dtype=torch.uint8, device=device)
    block = 1024
    for s in range(0, n, block):
        part = {k: v[s:s + block] for k, v in stacked.items()}
        images[s:s + block] = ref_paint.paint(part, p["channels"], diff,
                                              colors)
    labels = stacked["labels"]
    weights = cfg["training"].get("class_weights") or [1.0, 1.0, 1.0]
    return {
        "images": images,
        "labels": labels,
        "sample_weights": torch.tensor(weights, dtype=torch.float32,
                                       device=device)[labels.long()],
        "variant_types": stacked["variant_types"],
    }


def train_config(cfg, seed):
    """The port's TrainConfig for this configuration; the dropout masks
    draw from `seed`."""
    from deepvariant_tpu_torch.training.config import TrainConfig

    t = cfg["training"]
    weights = t.get("class_weights")
    fields = {k: v for k, v in t.items()
              if k not in ("class_weights", "dropout_rate")}
    return TrainConfig(batch_size=cfg["batch_size"],
                       class_weights=",".join(str(w) for w in weights)
                       if weights else "", seed=seed, **fields)


def _plant(fault, step):
    """Breaks the timed step underneath, for the fault tests: 'frozen'
    returns the state unchanged, 'half' trains on the first half of each
    batch's rows only, 'ema' and 'stats' leave the moving average or
    batch norm's running statistics as they were."""
    if fault == "frozen":
        def frozen(state, batch):
            _, loss, cms = step(state, batch)
            return state, loss, cms
        return frozen
    if fault in ("ema", "stats"):
        key = {"ema": "ema_params", "stats": "batch_stats"}[fault]

        def unmoved(state, batch):
            new, loss, cms = step(state, batch)
            return {**new, key: state[key]}, loss, cms
        return unmoved
    if fault == "half":
        def half(state, batch):
            n = batch["labels"].shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})
        return half
    if fault is not None:
        raise ValueError(f"no fault {fault!r} for this driver")
    return step


def run(ctx) -> Outcome:
    from deepvariant_tpu_torch.models.inception_v3 import InceptionV3
    from deepvariant_tpu_torch.training import train as train_lib

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    p = cfg["pileup"]
    device = torch.device(ctx.device)
    cuda = device.type == "cuda"
    shape = (p["height"], p["width"], plans.planes(p))
    batch = cfg["batch_size"]
    n = tr["corpus_examples"]
    steps_per_epoch = n // batch
    spans = Spans()
    tc = train_config(cfg, ctx.seed)

    weights = seeded_weights(shape, ctx.seed, device, bn_bias=BN_BIAS)
    with torch.device("meta"):
        model = InceptionV3(shape[2], bn_momentum=tc.bn_momentum,
                            dropout_rate=cfg["training"]["dropout_rate"])
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    variables = train_lib.model_variables(model, device)
    model.dtype = torch.bfloat16 if tc.use_mixed_precision else \
        torch.float32
    tx, _ = train_lib.make_optimizer(tc, steps_per_epoch)
    state = train_lib.init_state(model, variables, tx)
    step = _plant(ctx.fault, train_lib.make_train_step(model, tx, tc))
    del variables
    data = corpus(n, cfg, tr, ctx.seed, device)
    order = np.random.default_rng(ctx.seed)
    epoch = {"perm": None}

    def gather(s):
        if s % steps_per_epoch == 0:
            perm = order.permutation(n)[:steps_per_epoch * batch]
            epoch["perm"] = torch.from_numpy(
                perm.reshape(steps_per_epoch, batch)).long().to(device)
        idx = epoch["perm"][s % steps_per_epoch]
        return {k: v.index_select(0, idx) for k, v in data.items()}

    # The first steps: set-up, warm-up, and what the reference follows.
    first, losses0, after = [], [], {}
    for s in range(CHECK_STEPS):
        b = gather(s)
        first.append(b)
        state, loss, cms = step(state, b)
        losses0.append(loss)
        if s + 1 in READ_AFTER:
            mu, nu = _moments(state["opt_state"], tc.optimizer)
            after[s + 1] = {"params": state["params"],
                            "ema": state["ema_params"],
                            "stats": state["batch_stats"],
                            "mu": mu, "nu": nu, "cm": cms["all"]}
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    spans.times.clear()

    setup_s = time.time() - ctx.t_process
    trace = Trace() if ctx.trace else None
    spans.traced = ctx.trace
    marks, losses = [], []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    t_traced = t0
    if trace:
        trace.start()
    s = CHECK_STEPS
    while time.perf_counter() < deadline:
        with spans.span("step"):
            state, loss, _ = step(state, gather(s))
        losses.append(loss)
        if cuda:
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            marks.append(mark)
        else:
            marks.append(time.perf_counter() - t0)
        s += 1
        if trace and s - CHECK_STEPS == tr["trace_steps"]:
            trace.stop()
            t_traced = time.perf_counter()
    if trace and t_traced == t0:
        trace.stop()
        t_traced = time.perf_counter()
    if cuda:
        torch.cuda.synchronize(device)
        finished = [start.elapsed_time(m) / 1e3 for m in marks]
    else:
        finished = marks
    in_window = done_in_window(finished, 0.0, ctx.seconds)
    traced_s = t_traced - t0
    after_trace = in_window - done_in_window(finished, 0.0, traced_s)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses \
        else 0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    print(f"[{ctx.cell.name}] {len(marks)} steps of {batch} started in "
          f"{ctx.seconds} s, {in_window:.3f} finished inside it", flush=True)
    reduced = trace.reduce() if trace else None

    got = {
        "losses": [float(x) for x in losses0],
        "grads": {k: ref_train.first_gradient(v, cfg["training"])
                  for k, v in after[1]["mu"].items()},
        "after": after,
    }
    del state, step, model, data, after, losses, losses0
    if cuda:
        torch.cuda.empty_cache()
    checks, read = check(ctx, got, weights, first, steps_per_epoch, tc.seed)
    untraced_s = max(ctx.seconds - traced_s, 1e-9)
    return Outcome(
        metrics={"train_examples_per_s": in_window * batch / ctx.seconds,
                 "setup_s": setup_s},
        attempted=len(marks),
        failed=failed,
        checks=checks,
        memory_peak_bytes=peak,
        facts={"batch": batch,
               "flops_per_example": roofline.train_flops(*shape),
               "examples_per_s": (after_trace * batch / untraced_s)
               if trace else in_window * batch / ctx.seconds,
               "peak_bytes": peak},
        spans=spans, reduced=reduced, readings=read)


def _moments(opt_state, optimizer):
    """The optimizer's first- and second-moment trees (optax's layout):
    SGD's trace and no second, Adam's mu and nu."""
    if optimizer == "sgd":
        return opt_state["0"]["trace"], {}
    return opt_state["0"]["mu"], opt_state["0"]["nu"]


def reference(ctx, weights, batches, steps_per_epoch, seed, **control):
    """The reference's first steps from `weights` on `batches`: float32,
    or with `control` (quant='fp8' or 'int8', half_batch=True) the
    control or a planted fault in the program's place."""
    ref_net.full_float32()
    return ref_train.train_steps(
        {k: v.float() for k, v in weights.items()}, batches,
        ctx.cell.config["training"], seed, steps_per_epoch, **control)


def _minus(tree, start, leaves):
    return {k: tree[k].float() - start[k] for k in leaves}


def readings(got, want, weights):
    """Every number read: the loss gap of each step (`loss_gap`) and of
    the first (`loss1_gap`); for the first gradient (`grad`) and, after
    each step k of READ_AFTER, each parameter's change (`change<k>`), its
    moving average's change (`ema<k>`), batch norm's running statistics'
    change (`stats<k>`) and the optimizer's moments (`mu<k>`, `nu<k>`):
    the worst and the median leaf's gap of norms (`<x>_gap`,
    `<x>_gap_median`) and norm of the difference (`<x>_diff`,
    `<x>_diff_median`), over the leaves that move; after each step k, the
    share of rows whose (label, predicted class) count differs
    (`cm<k>_gap`); the leaves with the widest gradient gaps, and both
    sides' losses."""
    params0 = {k: v.float() for k, v in weights.items()
               if not ref_net.is_statistic(k)}
    stats0 = {k: v.float() for k, v in weights.items()
              if ref_net.is_statistic(k)}
    leaves = compare.moving_leaves(want["grads"])
    trees = {"grad": (got["grads"], want["grads"], leaves)}
    read = {
        "loss_gap": compare.loss_gap(got["losses"], want["losses"]),
        "loss1_gap": compare.loss_gap(got["losses"][:1], want["losses"][:1]),
    }
    for k, g in got["after"].items():
        w = want["after"][k]
        trees[f"change{k}"] = (_minus(g["params"], params0, leaves),
                               _minus(w["params"], params0, leaves), leaves)
        trees[f"ema{k}"] = (_minus(g["ema"], params0, leaves),
                            _minus(w["ema"], params0, leaves), leaves)
        trees[f"stats{k}"] = (_minus(g["stats"], stats0, stats0),
                              _minus(w["stats"], stats0, stats0),
                              list(stats0))
        trees[f"mu{k}"] = (g["mu"], w["mu"], leaves)
        if w["nu"]:
            trees[f"nu{k}"] = (g["nu"], w["nu"], leaves)
        read[f"cm{k}_gap"] = compare.count_gap(g["cm"], w["cm"])
    for name, (g, w, keys) in trees.items():
        gaps = compare.leaf_gaps(g, w, keys)
        diffs = compare.leaf_diffs(g, w, keys)
        read[f"{name}_gap"] = max(gaps)
        read[f"{name}_gap_median"] = statistics.median(gaps)
        read[f"{name}_diff"] = max(diffs)
        read[f"{name}_diff_median"] = statistics.median(diffs)
    read["worst_grad_leaves"] = compare.worst_leaves(
        got["grads"], want["grads"], leaves)
    read["losses"] = [got["losses"], want["losses"]]
    return read


def check(ctx, got, weights, batches, steps_per_epoch, seed):
    """The first three steps of the port against the reference's: every
    number read, and a check of each that the cell's limits file names."""
    start = time.perf_counter()
    read = readings(got, reference(ctx, weights, batches, steps_per_epoch,
                                   seed), weights)
    print(f"[{ctx.cell.name}] the reference took "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    return [Check(name, read[name], limit)
            for name, limit in ctx.cell.limits.items()], read


def control_readings(ctx, controls):
    """For each of `controls`, the numbers of a run whose program is the
    reference with it (quant='fp8' or 'int8': one precision below
    bfloat16; half_batch=True: half of each batch left out), at the
    cell's size: the inputs as a run makes them, no window."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    p = cfg["pileup"]
    device = torch.device(ctx.device)
    shape = (p["height"], p["width"], plans.planes(p))
    batch, n = cfg["batch_size"], tr["corpus_examples"]
    steps_per_epoch = n // batch
    weights = seeded_weights(shape, ctx.seed, device, bn_bias=BN_BIAS)
    data = corpus(n, cfg, tr, ctx.seed, device)
    perm = np.random.default_rng(ctx.seed).permutation(n)
    batches = []
    for s in range(CHECK_STEPS):
        idx = torch.from_numpy(perm[s * batch:(s + 1) * batch]).long().to(
            device)
        batches.append({k: v.index_select(0, idx) for k, v in data.items()})
    del data
    want = reference(ctx, weights, batches, steps_per_epoch, ctx.seed)
    return [readings(reference(ctx, weights, batches, steps_per_epoch,
                               ctx.seed, **control), want, weights)
            for control in controls]

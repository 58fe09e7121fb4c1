"""Plain PyTorch training steps of DeepVariant's InceptionV3: the
benchmark's reference for the train cells.

Frozen copies of the formulas the configurations state: the weighted
categorical cross-entropy over softmax outputs with label smoothing (the
log of the probabilities clipped to [1e-7, 1]), the L2 penalty over every
conv and dense kernel, the staircase exponential learning-rate decay,
SGD with Nesterov momentum and Adam as optax chains them (Keras's
formulas), the parameters' exponential moving average, batch norm's
running statistics, and the head's dropout. The dropout masks are drawn as the
configuration's seeded trainer draws them: a generator on the card,
seeded from (seed, step, micro step) through numpy's SeedSequence, and
one uniform draw over the pooled features. Nothing here reads the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import inception_v3 as net

NUM_CLASSES = 3
FEATURES = 2048


def dropout_keep(seed: int, step: int, shape, device, rate: float,
                 micro: int = 0) -> torch.Tensor:
    words = np.random.SeedSequence([seed, step, micro]).generate_state(
        2, np.uint32)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(words[0]) << 31 | int(words[1]) >> 1)
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32) < 1.0 - rate


def learning_rate(cfg: Dict, count: int, steps_per_epoch: int) -> float:
    decay_steps = max(int(steps_per_epoch
                          * cfg["learning_rate_num_epochs_per_decay"]), 1)
    lr = np.float32(cfg["learning_rate"])
    rate = np.float32(cfg["learning_rate_decay_rate"])
    warmup = int(cfg.get("warmup_steps", 0))
    if warmup > 0 and count < warmup:
        frac = np.float32(1) - np.float32(count) / np.float32(warmup)
        return float(np.float32(np.float32(lr / 10 - lr) * frac
                                + np.float32(lr)))
    count -= max(warmup, 0)
    return float(np.float32(lr * np.power(rate, np.float32(
        count // decay_steps))))


def loss(probs, labels, weights, smoothing):
    onehot = F.one_hot(labels.long(), NUM_CLASSES).to(torch.float32)
    onehot = onehot * (1.0 - smoothing) + smoothing / NUM_CLASSES
    logp = torch.log(torch.clamp(probs, 1e-7, 1.0))
    total = torch.sum(-torch.sum(onehot * logp, dim=-1) * weights)
    return total / torch.clamp_min(torch.sum(weights), 1e-6)


class Optimizer:
    """SGD with Nesterov momentum or Adam over {name: tensor} maps."""

    def __init__(self, cfg: Dict, steps_per_epoch: int):
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def step(self, params, grads):
        c = self.cfg
        lr = learning_rate(c, self.count, self.steps_per_epoch)
        self.count += 1
        out = {}
        for k, g in grads.items():
            if c["optimizer"] == "sgd":
                m = c["momentum"]
                trace = g + m * self.mu.get(k, torch.zeros_like(g))
                self.mu[k] = trace
                u = g + m * trace
            elif c["optimizer"] == "adam":
                b1, b2 = c["beta_1"], c["beta_2"]
                mu = (1 - b1) * g + b1 * self.mu.get(k, torch.zeros_like(g))
                nu = (1 - b2) * g * g + b2 * self.nu.get(
                    k, torch.zeros_like(g))
                self.mu[k], self.nu[k] = mu, nu
                n = np.float32(self.count)
                bc1 = float(np.float32(1) - np.power(np.float32(b1), n))
                bc2 = float(np.float32(1) - np.power(np.float32(b2), n))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + c["epsilon"])
                if c.get("optimizer_weight_decay"):
                    u = u + c["optimizer_weight_decay"] * params[k]
            else:
                raise ValueError(f"no reference for {c['optimizer']}")
            out[k] = params[k] + (-lr) * u
        return out


def train_steps(weights: Dict[str, torch.Tensor],
                batches: List[Dict[str, torch.Tensor]], cfg: Dict,
                seed: int, steps_per_epoch: int, quant: Optional[str] = None,
                half_batch: bool = False) -> Dict:
    """Runs one float32 step per batch from `weights` (parameters and
    batch-norm statistics). Returns {"losses": [float], "grads": the
    first step's gradients, "after": {step (from 1): {"params", "ema":
    the parameters' moving average (the parameters themselves without
    EMA), "stats": batch norm's running statistics, "mu", "nu": the
    optimizer's moments (SGD's trace as "mu", no "nu"), "cm": the (3, 3)
    counts of [label, predicted class] over the step's rows}}}. `quant`
    ('fp8', 'int8') computes the convs and the head one precision below
    bfloat16 (the control); `half_batch` trains on the first half of each
    batch's rows only (a planted fault)."""
    params = {k: v for k, v in weights.items() if not net.is_statistic(k)}
    stats = {k: v for k, v in weights.items() if net.is_statistic(k)}
    opt = Optimizer(cfg, steps_per_epoch)
    ema = dict(params)
    decay = cfg["ema_momentum"] if cfg.get("use_ema") else 0.0
    losses, after, first_grads = [], {}, None
    for step, batch in enumerate(batches):
        if half_batch:
            half = batch["labels"].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        keep = dropout_keep(seed, step, (batch["labels"].shape[0], FEATURES),
                            batch["images"].device, cfg["dropout_rate"])
        z, new_stats = net.logits({**leaves, **stats}, batch["images"],
                                  training=True, quant=quant, keep_mask=keep,
                                  dropout_rate=cfg["dropout_rate"],
                                  bn_momentum=cfg["bn_momentum"])
        cm = torch.bincount(
            batch["labels"].long() * NUM_CLASSES + z.detach().argmax(-1),
            minlength=NUM_CLASSES ** 2).view(NUM_CLASSES, NUM_CLASSES)
        data = loss(torch.softmax(z, dim=-1), batch["labels"],
                    batch["sample_weights"], cfg["label_smoothing"])
        penalty = cfg["weight_decay"] * torch.stack(
            [leaves[k].square().sum() for k in leaves
             if net.is_kernel(k)]).sum()
        names = list(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            data + penalty, [leaves[k] for k in names])))
        del z
        losses.append(float(data.detach() + penalty.detach()))
        if first_grads is None:
            first_grads = grads
        with torch.no_grad():
            params = opt.step(params, grads)
            ema = {k: decay * ema[k] + (1.0 - decay) * params[k]
                   for k in params}
        stats = {k: v.detach() for k, v in new_stats.items()}
        after[step + 1] = {"params": params, "ema": ema, "stats": stats,
                           "mu": dict(opt.mu), "nu": dict(opt.nu),
                           "cm": cm}
    return {"losses": losses, "grads": first_grads, "after": after}


def first_gradient(opt_state_leaf: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """The first step's gradient of a leaf from the optimizer's state
    after that step: SGD's trace is the gradient itself, Adam's first
    moment is (1 - beta_1) times it."""
    if cfg["optimizer"] == "sgd":
        return opt_state_leaf
    return opt_state_leaf / (1 - cfg["beta_1"])


"""Small-model training: MLP over candidate summary features.

The port's copy of `deepvariant_tpu.small_model.train`. Reference
parity: small_model/small_model_config.py hyperparameters (relu MLP
(750, 750), adam lr 1e-4 with per-epoch exponential decay 0.99, weight
decay 1e-7) and make_small_model_examples.py's training tf.Example
schema (features/encoded int64 list + one-hot label/encoded, :45-48,
:710-786). The JAX package trains with a jitted optax.adamw loop; here
the loop runs on `device` (the card by default) with optax's formulas:
adamw at its defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, the
weight decay on every leaf, biases included) through
`training.train.Optimizer("adam")`, and `optax.exponential_decay`
WITHOUT staircase, `lr * 0.99 ** (count / steps_per_epoch)` in float32.
The bundle it writes, small_model.msgpack ({"params": {"params":
{...}}, "mean", "scale"}) and small_model.json, is what both packages'
make_examples read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io import flax_msgpack
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.small_model.model import (
    BUNDLE_NAME,
    SmallModelMLP,
    to_flax_variables,
    to_module_state,
)

FEATURES_ENCODED = "features/encoded"
IDS_ENCODED = "ids/encoded"
LABEL_ENCODED = "label/encoded"
GENOTYPE_ENCODED = "genotype/encoded"
NUM_CLASSES = 3
# optax.adamw's default eps, not TrainConfig's 1e-7.
ADAMW_EPSILON = 1e-8


@dataclasses.dataclass
class SmallModelTrainConfig:
    """small_model_config.py:79-110 defaults."""

    hidden_layer_sizes: Tuple[int, ...] = (750, 750)
    learning_rate: float = 1e-4
    learning_rate_decay_rate: float = 0.99
    weight_decay: float = 1e-7
    batch_size: int = 1024
    num_epochs: int = 10


def get_config(name: str = "wgs") -> SmallModelTrainConfig:
    """Presets (wgs/pacbio/ont share hyperparameters; the products
    differ in expand_by_haplotype at example-generation time)."""
    if name not in ("wgs", "pacbio", "ont", "test"):
        raise ValueError(f"unknown small-model config {name!r}")
    if name == "test":
        return SmallModelTrainConfig(
            hidden_layer_sizes=(32, 32), batch_size=16,
            num_epochs=30, learning_rate=1e-2,
        )
    return SmallModelTrainConfig()


# -- training-example codec ---------------------------------------------------

def encode_training_example(
    features: Sequence[int], label: int, ids: Sequence[str] = ()
) -> bytes:
    """tf.Example wire bytes (make_small_model_examples.py:710-755)."""
    one_hot = [0] * NUM_CLASSES
    one_hot[label] = 1
    payload: Dict[str, object] = {
        FEATURES_ENCODED: [int(f) for f in features],
        LABEL_ENCODED: one_hot,
        GENOTYPE_ENCODED: [int(label)],
    }
    if ids:
        payload[IDS_ENCODED] = [s.encode() for s in ids]
    return example_codec.encode_example(payload)


def decode_training_example(buf: bytes) -> Tuple[np.ndarray, int]:
    feats = example_codec.decode_example(buf)
    x = np.asarray(feats[FEATURES_ENCODED], np.float32)
    label = int(np.argmax(feats[LABEL_ENCODED]))
    return x, label


def read_training_examples(path: str):
    """(features (N, F) float32, labels (N,) int32) from TFRecords."""
    xs, ys = [], []
    for p in glob_sharded_inputs(path):
        with TFRecordReader(p) as reader:
            for buf in reader:
                x, y = decode_training_example(buf)
                xs.append(x)
                ys.append(y)
    if not xs:
        return np.zeros((0, 0), np.float32), np.zeros(0, np.int32)
    return np.stack(xs), np.asarray(ys, np.int32)


# -- training loop -------------------------------------------------------------

def exponential_decay(learning_rate: float, transition_steps: int,
                      decay_rate: float):
    """optax.exponential_decay without staircase: count -> float32
    `lr * rate ** (count / transition_steps)`."""
    lr = np.float32(learning_rate)
    rate = np.float32(decay_rate)

    def schedule(count: int) -> np.float32:
        if count <= 0:
            return lr
        p = np.float32(count) / np.float32(transition_steps)
        return np.float32(lr * np.power(rate, p))

    return schedule


def make_optimizer(config: SmallModelTrainConfig, steps_per_epoch: int):
    """optax.adamw(exponential_decay(...), weight_decay=...) at optax's
    defaults, as `training.train.Optimizer("adam")`."""
    from deepvariant_tpu_torch.training.config import TrainConfig
    from deepvariant_tpu_torch.training.train import Optimizer

    adam = TrainConfig(optimizer="adam", beta_1=0.9, beta_2=0.999,
                       epsilon=ADAMW_EPSILON,
                       optimizer_weight_decay=config.weight_decay)
    return Optimizer("adam", adam, exponential_decay(
        config.learning_rate, steps_per_epoch,
        config.learning_rate_decay_rate))


def loss_fn(model: SmallModelMLP, params: Dict[str, torch.Tensor],
            xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
    """The MLP emits probabilities (softmax head); NLL on the clipped
    log-probabilities. The clip is jnp.clip's maximum-then-minimum, so a
    probability at a bound splits its gradient as JAX's does."""
    probs = torch.func.functional_call(model, params, (xb,))
    lo = torch.tensor(1e-9, dtype=probs.dtype, device=probs.device)
    hi = torch.tensor(1.0, dtype=probs.dtype, device=probs.device)
    logp = torch.log(torch.minimum(torch.maximum(probs, lo), hi))
    one_hot = torch.nn.functional.one_hot(
        yb.long(), NUM_CLASSES).to(probs.dtype)
    return -(one_hot * logp).sum(dim=-1).mean()


def train_step(model, optimizer, params, opt_state, xb, yb):
    """One adamw step: (params, opt_state, loss)."""
    from deepvariant_tpu_torch.training.train import apply_updates

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(model, leaves, xb, yb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    grads = dict(zip(leaves, grads))
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    return params, opt_state, loss.detach()


def _predict(model, params, x: torch.Tensor) -> np.ndarray:
    with torch.no_grad():
        probs = torch.func.functional_call(model, params, (x,))
    return probs.argmax(dim=1).cpu().numpy()


def fit(
    x_train: np.ndarray,
    y_train: np.ndarray,
    config: SmallModelTrainConfig,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    initial_variables=None,
    dtype: torch.dtype = torch.float32,
):
    """The training loop over normalized rows on `device`, in `dtype`.
    Returns (model, params {state-dict name: tensor}, the last epoch's
    metrics).

    `initial_variables` (the flax tree {"params": {"Dense_i": ...}})
    starts from given weights: JAX draws its init from
    `model.init(PRNGKey(seed))`, which torch cannot reproduce. Without
    it the weights come from flax's initializers (truncated lecun-normal
    kernels, zero biases) drawn from a torch.Generator seeded with
    `seed`."""
    from deepvariant_tpu_torch.models.inception_v3 import _lecun_normal_

    n, num_features = x_train.shape
    model = SmallModelMLP(num_features, tuple(config.hidden_layer_sizes))
    if initial_variables is not None:
        model.load_state_dict(to_module_state(initial_variables))
    else:
        generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for layer in model.children():
                _lecun_normal_(layer.weight, layer.in_features, generator)
                layer.bias.zero_()
    model = model.to(device=device, dtype=dtype)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    steps_per_epoch = max(1, n // config.batch_size)
    optimizer = make_optimizer(config, steps_per_epoch)
    opt_state = optimizer.init(params)

    x_dev = torch.from_numpy(x_train).to(device=device, dtype=dtype)
    y_dev = torch.from_numpy(y_train).to(device)
    rng_np = np.random.RandomState(seed)
    metrics: Dict[str, float] = {}
    # A corpus smaller than one batch must still train: cap the batch
    # at n (a 1024 default batch over a few hundred rows would take
    # no step and return the random init).
    batch_size = min(config.batch_size, n)
    for epoch in range(config.num_epochs):
        order = rng_np.permutation(n)
        losses = []
        for start in range(0, n - batch_size + 1, batch_size):
            idx = torch.from_numpy(order[start:start + batch_size]).to(device)
            params, opt_state, loss = train_step(
                model, optimizer, params, opt_state, x_dev[idx], y_dev[idx])
            losses.append(loss)
        # One sync per epoch: the float32 losses as Python floats.
        losses = torch.stack(losses).float().tolist() if losses else []
        preds = _predict(model, params, x_dev)
        metrics = {
            "epoch": epoch,
            "train_loss": float(np.mean(losses)) if losses else 0.0,
            "train_accuracy": float((preds == y_train).mean()),
        }
    return model, params, metrics


def train_small_model(
    train_path: str,
    output_dir: str,
    config: Optional[SmallModelTrainConfig] = None,
    tune_path: str = "",
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    initial_variables=None,
) -> Dict[str, float]:
    """Train on `device` in float32 (`fit`, from `initial_variables` or
    a seeded init) and write <output_dir>/small_model.msgpack (+
    features sidecar). Returns final metrics."""
    config = config or get_config()
    device = resolve_device(device)
    x_train, y_train = read_training_examples(train_path)
    if not len(x_train):
        raise ValueError(f"no training examples in {train_path}")
    num_features = x_train.shape[1]
    # Feature normalization: fit mean/scale on train (keras pipelines
    # normalize counts; the inference gate applies the same affine), in
    # numpy float32 as the JAX package does.
    mean = x_train.mean(axis=0)
    scale = x_train.std(axis=0)
    scale[scale == 0] = 1.0
    x_train = (x_train - mean) / scale
    model, params, metrics = fit(x_train, y_train, config, seed, device,
                                 initial_variables)
    if tune_path:
        x_tune, y_tune = read_training_examples(tune_path)
        if len(x_tune):
            x_tune = (x_tune - mean) / scale
            preds = _predict(model, params,
                             torch.from_numpy(x_tune).to(device))
            metrics["tune_accuracy"] = float((preds == y_tune).mean())

    def key_sorted(tree):
        # flax writes a dict's keys in sorted order.
        return {k: key_sorted(tree[k]) if isinstance(tree[k], dict)
                else tree[k] for k in sorted(tree)}

    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, BUNDLE_NAME), "wb") as f:
        f.write(flax_msgpack.pack(key_sorted({
            "params": to_flax_variables(params), "mean": mean,
            "scale": scale})))
    with open(os.path.join(output_dir, "small_model.json"), "w") as f:
        json.dump({
            "num_features": int(num_features),
            "hidden_layer_sizes": list(config.hidden_layer_sizes),
            "metrics": metrics,
        }, f, indent=2)
    return metrics

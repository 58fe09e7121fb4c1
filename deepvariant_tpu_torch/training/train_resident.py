"""Device-resident training: the whole dataset lives in the card's memory.

The port of `deepvariant_tpu/training/train_resident.py`. The reference
streams TFRecords through tf.data into the accelerator every step
(train.py:98-127 + data_providers.py); here

  * the full uint8 example tensor goes to the card ONCE (a corpus of
    ~20k pileups is ~3 GB of the H100's 80 GB);
  * each step gathers its shuffled batch from the resident arrays by
    index on the device and runs the train step of training/train.py;
    the epoch's permutation comes from `np.random.default_rng(seed)`,
    drawn as the JAX package draws it;
  * the tune-best state is kept as a COPY on the device, and fetched to
    the host only at the end.

Per-epoch host traffic: one (steps, B) index tensor up, the mean loss
and two 3x3 confusion matrices down.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Tuple, Union

import numpy as np
import torch

from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
from deepvariant_tpu_torch.device import full_float32_precision, resolve_device
from deepvariant_tpu_torch.io import examples as example_codec
from deepvariant_tpu_torch.io.tfrecord import TFRecordReader
from deepvariant_tpu_torch.models import checkpoint as ckpt_lib
from deepvariant_tpu_torch.training import metrics as metrics_lib
from deepvariant_tpu_torch.training import train as train_lib
from deepvariant_tpu_torch.training.config import TrainConfig
from deepvariant_tpu_torch.training.data import DatasetConfig


def load_dataset_arrays(
    tfrecord_path: str, config: TrainConfig
) -> Dict[str, np.ndarray]:
    """Parse a labeled TFRecord corpus into packed host arrays."""
    class_weights = config.class_weight_list()
    images, labels, vtypes = [], [], []
    for path in glob_sharded_inputs(tfrecord_path):
        with TFRecordReader(path) as reader:
            for buf in reader:
                ex = example_codec.parse_example(buf)
                images.append(ex.image)
                labels.append(int(ex.label or 0))
                vtypes.append(int(ex.variant_type or 0))
    labels_arr = np.asarray(labels, np.int32)
    if class_weights:
        weights = np.asarray(class_weights, np.float32)[
            np.clip(labels_arr, 0, len(class_weights) - 1)
        ]
    else:
        weights = np.ones(len(labels_arr), np.float32)
    return {
        "images": np.stack(images),
        "labels": labels_arr,
        "sample_weights": weights,
        "variant_types": np.asarray(vtypes, np.int32),
    }


def _tune_index_plan(
    n: int, batch_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-shape tune schedule: pad the tail batch with masked rows."""
    steps = max((n + batch_size - 1) // batch_size, 1)
    idx = np.zeros((steps, batch_size), np.int32)
    mask = np.zeros((steps, batch_size), np.float32)
    flat = np.arange(n, dtype=np.int32)
    for s in range(steps):
        chunk = flat[s * batch_size: (s + 1) * batch_size]
        idx[s, : len(chunk)] = chunk
        mask[s, : len(chunk)] = 1.0
    return idx, mask


def _gather(data: Dict[str, torch.Tensor],
            idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: v.index_select(0, idx) for k, v in data.items()}


def snapshot(state: dict) -> dict:
    """The inference part of a state, copied on its device."""
    return {
        "params": {k: v.clone() for k, v in state["params"].items()},
        "batch_stats": {k: v.clone()
                        for k, v in state["batch_stats"].items()},
        "ema_params": {k: v.clone() for k, v in state["ema_params"].items()},
        "step": state["step"].clone(),
    }


def train_resident(
    config: TrainConfig,
    experiment_dir: str,
    device: Union[str, torch.device] = "cuda",
    log_fn=print,
) -> Dict[str, float]:
    """Full device-resident training run; returns final metrics.

    Also reports measured per-epoch wall time and examples per second;
    the epoch's loss is read once at its end, which waits for every
    step of the epoch.
    """
    device = resolve_device(device)
    full_float32_precision()
    train_cfg = DatasetConfig.read(config.train_dataset_config)
    tune_cfg = DatasetConfig.read(config.tune_dataset_config)

    first = train_cfg.tfrecord_path.split(",")[0]
    example_info = example_codec.read_example_info(first)
    input_shape = example_info["shape"]

    host_train = load_dataset_arrays(train_cfg.tfrecord_path, config)
    host_tune = load_dataset_arrays(tune_cfg.tfrecord_path, config)
    # Tune rows carry weight 1 regardless of class weighting: class
    # weights shape the LOSS, not the tune confusion counts.
    host_tune["sample_weights"] = np.ones_like(
        host_tune["sample_weights"]
    )
    n_train = len(host_train["labels"])
    n_tune = len(host_tune["labels"])
    batch = min(config.batch_size, n_train)
    steps_per_epoch = n_train // batch

    model, variables = train_lib.training_model(config, input_shape, device)
    tx, _ = train_lib.make_optimizer(config, steps_per_epoch)
    state = train_lib.init_state(model, variables, tx)
    if config.init_checkpoint:
        state = train_lib.load_checkpoint(config.init_checkpoint, state)

    data = {k: torch.from_numpy(v).to(device) for k, v in host_train.items()}
    tune_data = {k: torch.from_numpy(v).to(device)
                 for k, v in host_tune.items()}
    log_fn(
        f"resident dataset on {device}: train {n_train} x "
        f"{tuple(input_shape)} ({host_train['images'].nbytes / 1e6:.0f}"
        f" MB), tune {n_tune}; batch {batch}, "
        f"{steps_per_epoch} steps/epoch"
    )
    del host_train, host_tune

    train_step = train_lib.make_train_step(model, tx, config)
    eval_step = train_lib.make_eval_step(model, config)
    tune_idx, tune_mask = _tune_index_plan(n_tune, batch)
    tune_idx = torch.from_numpy(tune_idx).long().to(device)
    tune_mask = torch.from_numpy(tune_mask).to(device)

    rng = np.random.default_rng(config.seed)
    best_metric = -float("inf")
    best_state_dev = None
    best_epoch = -1
    patience = 0
    results: Dict[str, float] = {}
    ckpt_dir = os.path.join(experiment_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    history = []

    # The JAX package retries the first epoch's compile, which its
    # remote TPU compiler fails now and then; eager torch compiles
    # nothing, so there is nothing to retry here.
    for epoch in range(config.num_epochs):
        perm = rng.permutation(n_train)[: steps_per_epoch * batch]
        perm = perm.reshape(steps_per_epoch, batch)
        t0 = time.time()
        perm_dev = torch.from_numpy(perm).long().to(device)
        losses = []
        cm_all = metrics_lib.empty_confusion(device)
        for s in range(steps_per_epoch):
            state, loss, cms = train_step(state, _gather(data, perm_dev[s]))
            losses.append(loss)
            cm_all += cms["all"]
        # The scalar read waits for every step of the epoch.
        loss_val = float(torch.stack(losses).mean())
        dt = time.time() - t0
        train_metrics = metrics_lib.metrics_from_confusion(
            cm_all.cpu().numpy(), prefix="train/"
        )
        train_metrics["train/loss"] = loss_val
        train_metrics["train/examples_per_sec"] = (
            steps_per_epoch * batch / max(dt, 1e-9)
        )
        train_metrics["train/epoch_seconds"] = dt

        tune_losses = []
        tune_cm = metrics_lib.empty_confusion(device)
        for step_idx, step_w in zip(tune_idx, tune_mask):
            tune_batch = _gather(tune_data, step_idx)
            tune_batch["sample_weights"] = step_w
            loss, cm = eval_step(state, tune_batch)
            tune_losses.append(loss)
            tune_cm += cm
        tune_metrics = metrics_lib.metrics_from_confusion(
            tune_cm.cpu().numpy(), prefix="tune/"
        )
        tune_metrics["tune/loss"] = float(torch.stack(tune_losses).mean())
        results = {**train_metrics, **tune_metrics}
        history.append({"epoch": epoch, **{
            k: round(float(v), 5) for k, v in results.items()
        }})
        log_fn(f"epoch {epoch}: " + json.dumps(
            {k: round(float(v), 5) for k, v in results.items()}
        ))

        metric_val = results.get(config.best_checkpoint_metric, 0.0)
        if metric_val > best_metric:
            best_metric = metric_val
            best_epoch = epoch
            best_state_dev = snapshot(state)
            patience = 0
        else:
            patience += 1
            if patience >= config.early_stopping_patience:
                log_fn(f"early stopping at epoch {epoch}")
                break

    # The final and the tune-best inference states, fetched at the end.
    final_path = os.path.join(ckpt_dir, "final.msgpack")
    _save_inference_state(final_path, snapshot(state), example_info)
    if best_state_dev is not None:
        _save_inference_state(
            os.path.join(ckpt_dir, "best.msgpack"), best_state_dev,
            example_info,
        )
    with open(os.path.join(experiment_dir, "history.json"), "w") as f:
        json.dump(history, f)
    results["best_epoch"] = best_epoch
    results["best_metric"] = best_metric
    return results


def _save_inference_state(path: str, snap: Dict, example_info: dict):
    """Persist an inference checkpoint {params, batch_stats, ema_params,
    step} in flax's layout, which `models.checkpoint.load_variables_for_*`
    and the JAX package's call_variants read, plus the example_info.json
    contract."""
    ckpt_lib.save_train_state(path, snap)
    info_path = os.path.join(os.path.dirname(path), "example_info.json")
    with open(info_path, "w") as f:
        json.dump(example_info, f)

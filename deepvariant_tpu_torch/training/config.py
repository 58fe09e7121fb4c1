"""Training configuration presets (reference dv_config.py:57-460).

The port's copy of `deepvariant_tpu.training.config`, field by field:
every hyperparameter the reference exposes per product
(wgs/exome/pacbio/ont), with the same defaults, consumable by
`deepvariant_tpu_torch.training.train`. As in the JAX package,
`backbone_dropout_rate`, `denovo_enabled` and `denovo_weight` are read
by nothing (`create_model` builds with the model's 0.2 dropout).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class TrainConfig:
    # Datasets (dataset_config pbtxt equivalents).
    train_dataset_config: str = ""
    tune_dataset_config: str = ""
    init_checkpoint: str = ""
    num_validation_examples: int = 150_000

    best_checkpoint_metric: str = "tune/f1_weighted"
    batch_size: int = 16384
    num_epochs: int = 10

    # Optimizer (dv_config.py:71-78).
    optimizer: str = "sgd"  # sgd | adam | rmsprop
    momentum: float = 0.9
    use_ema: bool = True
    ema_momentum: float = 0.99
    optimizer_weight_decay: float = 0.0
    beta_1: float = 0.9
    beta_2: float = 0.999
    epsilon: float = 1e-7
    rho: float = 0.9

    # L2 on conv/dense kernels (keras_modeling add_l2_regularizers).
    weight_decay: float = 0.0001

    early_stopping_patience: int = 100
    learning_rate: float = 0.01
    # BatchNorm running-average momentum: keras InceptionV3's 0.9997
    # needs thousands of steps to converge; short runs should lower it.
    bn_momentum: float = 0.9997
    learning_rate_num_epochs_per_decay: float = 2.25
    learning_rate_decay_rate: float = 0.9999
    warmup_steps: int = 0

    label_smoothing: float = 0.01
    backbone_dropout_rate: float = 0.2

    use_mixed_precision: bool = True  # bfloat16 convolutions
    # Micro-batching toward the reference's 16384 global batch
    # (dv_config.py:57): the train step splits each batch into this
    # many sequential micro-batches, averages the gradients, and
    # applies ONE optimizer update — effective batch = batch_size,
    # HBM high-water = one micro-batch's activations.
    gradient_accumulation_steps: int = 1
    class_weights: str = ""  # e.g. "1,1,10"
    denovo_enabled: bool = False
    denovo_weight: float = 1.0
    ablation_channels: str = ""

    # Loop mechanics.
    steps_per_iter: int = 128
    shuffle_buffer_elements: int = 100_000
    prefetch_buffer_bytes: int = 16 * 1000 * 1000
    limit: int = 0  # debug: cap steps/epoch
    seed: int = 2101079370

    def class_weight_list(self) -> Optional[List[float]]:
        if not self.class_weights:
            return None
        return [float(w) for w in self.class_weights.split(",")]


def get_config(name: str) -> TrainConfig:
    """Preset lookup mirroring dv_config.get_config (dv_config.py:435)."""
    base = name.split("_")[0].lower()
    cfg = TrainConfig()
    if base in ("wgs", "base"):
        pass  # dataclass defaults are the WGS preset (dv_config.py:57-89)
    elif base in ("exome", "wes"):
        cfg.num_validation_examples = 0
        cfg.num_epochs = 20
        cfg.weight_decay = 0.00001
        cfg.early_stopping_patience = 250
        cfg.learning_rate_decay_rate = 0.5
        cfg.warmup_steps = 5000
    elif base == "pacbio":
        cfg.num_epochs = 8
        cfg.best_checkpoint_metric = "tune/categorical_accuracy"
        cfg.optimizer = "adam"
        cfg.beta_1 = 0.9651804083266324
        cfg.beta_2 = 0.9665259112630292
        cfg.weight_decay = 0.00004
        cfg.class_weights = "1,1,10"
    elif base == "ont":
        cfg.num_epochs = 8
        cfg.class_weights = "1,1,10"
    else:
        raise ValueError(f"unknown config preset: {name}")
    if name.endswith("_test") or name.endswith("_debug"):
        cfg.batch_size = 4
        cfg.num_epochs = 2
        cfg.num_validation_examples = 1
        cfg.warmup_steps = 0
        cfg.limit = 50
        cfg.steps_per_iter = 4
        cfg.shuffle_buffer_elements = 50
        cfg.init_checkpoint = ""
    return cfg

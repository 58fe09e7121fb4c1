"""Streaming classification metrics (reference metrics.py parity).

The port's copy of `deepvariant_tpu.training.metrics`. Per-class F1
(f1_homref/f1_het/f1_homalt), micro/weighted F1, precision/recall/
accuracy, accumulated as a 3x3 confusion matrix per batch on the device
(float32, no host sync per batch) and turned into numbers on the host in
float64.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

NUM_CLASSES = 3
VARIANT_TYPE_SNP = 1
VARIANT_TYPE_INDEL = 2


def confusion_update(
    cm: torch.Tensor,
    labels: torch.Tensor,
    predictions: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Add one batch to a float32 (3,3) confusion matrix [true, pred];
    rows where `mask` is false (or 0) count nothing."""
    weights = torch.ones(labels.shape, dtype=torch.float32,
                         device=labels.device) if mask is None else \
        mask.to(torch.float32)
    cell = labels.long() * NUM_CLASSES + predictions.long()
    counts = torch.zeros(NUM_CLASSES * NUM_CLASSES, dtype=torch.float32,
                         device=labels.device)
    counts.index_add_(0, cell, weights)
    return cm + counts.view(NUM_CLASSES, NUM_CLASSES)


def empty_confusion(device=None) -> torch.Tensor:
    return torch.zeros((NUM_CLASSES, NUM_CLASSES), dtype=torch.float32,
                       device=device)


def metrics_from_confusion(cm: np.ndarray, prefix: str = "") -> Dict[str, float]:
    """Derive accuracy / per-class F1 / weighted F1 from a confusion matrix."""
    cm = np.asarray(cm, np.float64)
    total = cm.sum() or 1.0
    tp = np.diag(cm)
    support = cm.sum(axis=1)
    pred_pos = cm.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_pos > 0, tp / pred_pos, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        f1 = np.where(
            precision + recall > 0,
            2 * precision * recall / (precision + recall),
            0.0,
        )
    weighted_f1 = float((f1 * support).sum() / (support.sum() or 1.0))
    out = {
        f"{prefix}categorical_accuracy": float(tp.sum() / total),
        f"{prefix}f1_homref": float(f1[0]),
        f"{prefix}f1_het": float(f1[1]),
        f"{prefix}f1_homalt": float(f1[2]),
        f"{prefix}f1_micro": float(tp.sum() / total),
        f"{prefix}f1_weighted": weighted_f1,
        f"{prefix}precision": float(
            (precision * support).sum() / (support.sum() or 1.0)
        ),
        f"{prefix}recall": float(
            (recall * support).sum() / (support.sum() or 1.0)
        ),
    }
    return out

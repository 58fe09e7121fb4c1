"""Fused device pileup paint + CNN inference over candidate plans.

Counterpart of `deepvariant_tpu/calling/plan_predictor.py`: workers ship
compact plan payloads (pre-gathered pileup row tensors) instead of
painted images, and the card paints the pileup (the CUDA paint kernel
through `make_examples.pileup_device`), normalizes it and runs
InceptionV3 without the image leaving device memory.

This slice implements the WGS channel set; other presets raise
NotImplementedError when the predictor is built.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from deepvariant_tpu_torch.calling.call_variants import (
    PendingResult,
    Predictor,
    predict_in_order,
)
from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
from deepvariant_tpu_torch.make_examples.pileup_device import (
    make_longread_encode_fn,
)
from deepvariant_tpu_torch.models.inception_v3 import InceptionV3

# Per-plan tensor keys in the encoder's argument order.
PLAN_KEYS = (
    "bases", "quals", "mapq", "rev", "hp", "tlen", "supp", "support",
    "af", "row_valid", "ref_window",
)
ALT_KEYS = ("alt_bases", "alt_row_valid", "alt_ref", "alt_present")


def compact_plan(plan: dict, diff_mode: bool) -> dict:
    """Strip the alt planes when the preset doesn't use them — no point
    shipping (2, R, W) zeros through the worker queue."""
    if diff_mode:
        return plan
    return {k: v for k, v in plan.items() if k not in ALT_KEYS}


@dataclasses.dataclass
class PlannedExample:
    """Device-encode payload for one (candidate, alt-combo) example; the
    same fields as `PlannedExample` in the JAX package's make_examples."""

    plan: dict
    variant: Variant
    alt_indices: List[int]
    variant_type: int
    label: Optional[int] = None


class PlanPredictor:
    """Fused paint + call over plan payloads: plans -> (B, 3) probs."""

    def __init__(
        self,
        model: InceptionV3,
        pileup_options: PileupOptions,
        batch_size: int = 512,
        device: Union[str, torch.device] = "cuda",
        dtype: torch.dtype = torch.bfloat16,
        fold_bn: bool = False,
    ):
        o = pileup_options
        self.encode_fn = make_longread_encode_fn(o)
        self.predictor = Predictor(model, batch_size=batch_size,
                                   device=device, dtype=dtype,
                                   fold_bn=fold_bn)
        self.batch_size = batch_size
        rows = o.height - o.reference_band_height
        # Template zero plan for batch padding.
        self._zero_plan = {
            "bases": np.zeros((rows, o.width), np.uint8),
            "quals": np.zeros((rows, o.width), np.uint8),
            "mapq": np.zeros(rows, np.uint8),
            "rev": np.zeros(rows, bool),
            "hp": np.zeros(rows, np.int8),
            "tlen": np.zeros(rows, np.int32),
            "supp": np.zeros(rows, bool),
            "support": np.zeros(rows, np.int8),
            "af": np.zeros(rows, np.uint8),
            "row_valid": np.zeros(rows, bool),
            "ref_window": np.zeros(o.width, np.uint8),
        }

    def stage(self, plans: List[dict]) -> dict:
        """Stack B plan dicts, padded to batch_size, onto the device."""
        padded = list(plans) + [self._zero_plan] * (
            self.batch_size - len(plans))
        return self.predictor.stager.stage({
            key: [np.asarray(p[key], self._zero_plan[key].dtype)
                  for p in padded]
            for key in PLAN_KEYS
        })

    @torch.inference_mode()
    def encode(self, plans: List[dict]) -> torch.Tensor:
        """plans (<= batch_size dicts) -> (batch_size, H, W, 7) uint8
        images on the device, the padding included."""
        staged = self.stage(plans)
        return self.encode_fn(*[staged[k] for k in PLAN_KEYS])

    def _submit(self, plans: List[dict]) -> PendingResult:
        return PendingResult(self.predictor.forward(self.encode(plans)))

    def __call__(self, plans: List[dict]) -> np.ndarray:
        """plans (<= batch_size dicts) -> (len(plans), 3) float probs."""
        return self._submit(plans).numpy()[: len(plans)].copy()

    def predict_plan_stream(
        self,
        payloads: Iterable,
        prefetch: int = 2,
    ) -> Iterator[Tuple[object, np.ndarray]]:
        """Yield (payload, probs[3]); payloads carry `.plan` dicts
        (PlannedExample or anything with a plan attribute). Up to
        `prefetch` batches stay in flight so the host stacking and the
        copies overlap the device work."""
        return predict_in_order(
            payloads, self.batch_size,
            lambda batch: self._submit([p.plan for p in batch]),
            prefetch,
        )

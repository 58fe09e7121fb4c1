"""Fused device pileup paint + CNN inference over candidate plans.

Counterpart of `deepvariant_tpu/calling/plan_predictor.py`: workers ship
compact plan payloads (pre-gathered pileup row tensors) instead of
painted images, and the card paints the pileup (the CUDA paint kernel
through `make_examples.pileup_device`), normalizes it and runs
InceptionV3 without the image leaving device memory. Any ordered list
of the device channels is painted; with `alt_aligned_pileup`
'diff_channels' the plans also carry the alt tensors (`ALT_KEYS`) and
the image has two more planes, so the model must take
`len(channels) + 2` channels. Over several devices (`devices`, as
`Predictor` takes them) the whole batch is painted on the first device
and each other device's part of it is copied there.
"""

from __future__ import annotations

from typing import (Iterable, Iterator, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from deepvariant_tpu_torch.calling.call_variants import (
    Predictor,
    predict_in_order,
)
# PlannedExample stays importable from here, as in the JAX package.
from deepvariant_tpu_torch.make_examples.examples_builder import (  # noqa: F401
    PlannedExample,
)
from deepvariant_tpu_torch.make_examples.pileup import PileupOptions
from deepvariant_tpu_torch.make_examples.pileup_device import (
    ALT_KEYS,
    PLAN_KEYS,
    make_longread_encode_fn,
)
from deepvariant_tpu_torch.models.inception_v3 import InceptionV3


def compact_plan(plan: dict, diff_mode: bool) -> dict:
    """Strip the alt planes when the preset doesn't use them — no point
    shipping (2, R, W) zeros through the worker queue."""
    if diff_mode:
        return plan
    return {k: v for k, v in plan.items() if k not in ALT_KEYS}


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
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        o = pileup_options
        self.options = o
        self.diff_mode = o.alt_aligned_pileup == "diff_channels"
        self.encode_fn = make_longread_encode_fn(o)
        planes = len(o.channels) + (2 if self.diff_mode else 0)
        if model.num_channels != planes:
            raise ValueError(
                f"the model takes {model.num_channels} channels, the "
                f"pileup options paint {planes}")
        # The keys staged and painted: the alt tensors only in diff mode.
        self._keys = PLAN_KEYS + (ALT_KEYS if self.diff_mode else ())
        self.predictor = Predictor(model, batch_size=batch_size,
                                   device=device, dtype=dtype,
                                   fold_bn=fold_bn, devices=devices)
        self.batch_size = self.predictor.batch_size
        rows = o.height - o.reference_band_height
        # Template zero plan for batch padding / stripped alt keys.
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
            "alt_bases": np.zeros((2, rows, o.width), np.uint8),
            "alt_row_valid": np.zeros((2, rows), bool),
            "alt_ref": np.zeros((2, o.width), np.uint8),
            "alt_present": np.zeros(2, bool),
        }

    def stage(self, plans: List[dict]) -> dict:
        """Stack B plan dicts, padded to batch_size, onto the device. A
        key that a plan lacks (alt tensors stripped by `compact_plan`)
        is staged as zeros."""
        padded = list(plans) + [self._zero_plan] * (
            self.batch_size - len(plans))
        zero = self._zero_plan
        return self.predictor.stager.stage({
            key: [np.asarray(p.get(key, zero[key]), zero[key].dtype)
                  for p in padded]
            for key in self._keys
        })

    @torch.inference_mode()
    def encode(self, plans: List[dict]) -> torch.Tensor:
        """plans (<= batch_size dicts) -> (batch_size, H, W, C) uint8
        images on the device, the padding included."""
        staged = self.stage(plans)
        return self.encode_fn(*[staged[k] for k in self._keys])

    def _submit(self, plans: List[dict]):
        return self.predictor.submit_device_images(self.encode(plans))

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

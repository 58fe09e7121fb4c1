"""The yardstick's arithmetic: operations and bytes counted from shapes,
and the published peaks of one NVIDIA H100 SXM (dense, 700 W).

The FLOPs of InceptionV3 come from the benchmark's own reference model
(`reference/inception_v3.py`), walked on the meta device, so no change
to the port can move them. The paint's bytes count each plan tensor the
kernel reads once and the image it writes once.
"""

from __future__ import annotations

import functools

BF16_PEAK_FLOPS = 989e12     # dense bfloat16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12    # HBM3

# Bytes of one plan's tensors (R read rows, W columns) as the paint
# kernel reads them: (R, W) bases and quals; (R,) mapq, rev, hp, supp,
# support, af, row_valid at a byte each and tlen at four; (W,) reference.
_ROW_BYTES = 1 + 1 + 1 + 4 + 1 + 1 + 1 + 1


def plan_bytes(rows: int, width: int, diff: bool) -> int:
    """Bytes of one plan that the painter reads."""
    n = 2 * rows * width + _ROW_BYTES * rows + width
    if diff:
        # alt_bases (2, R, W), alt_row_valid (2, R), alt_ref (2, W),
        # alt_present (2,).
        n += 2 * rows * width + 2 * rows + 2 * width + 2
    return n


def paint_bytes(n_plans: int, height: int, width: int, planes: int,
                band: int, diff: bool) -> int:
    """Bytes the painting of `n_plans` plans must move: each input read
    once, each (height, width, planes) uint8 image written once."""
    rows = height - band
    return n_plans * (plan_bytes(rows, width, diff)
                      + height * width * planes)


@functools.lru_cache(maxsize=None)
def forward_flops(height: int, width: int, channels: int) -> float:
    """FLOPs (2 x multiply-adds) of one example's InceptionV3 forward."""
    from benchmark.reference.inception_v3 import forward_flops as count

    return count((height, width, channels))


def train_flops(height: int, width: int, channels: int) -> float:
    """FLOPs of one example's training step: forward and a backward of
    twice the forward."""
    return 3.0 * forward_flops(height, width, channels)

"""Genotype-probability rounding for CVO output.

A copy of `round_gls` from `deepvariant_tpu.core.genomics_math`, whose
semantics follow the reference's call_variants.py:248-263.
"""

from __future__ import annotations

from typing import Sequence


def round_gls(gls: Sequence[float], precision: int = 10) -> list:
    """Round genotype probabilities, keeping the sum at 1.

    Verifies the input sums to ~1, rounds each value, and puts the
    residual on the max element so the rounded vector still sums to
    exactly 1.
    """
    gls = list(gls)
    total = sum(gls)
    if abs(total - 1.0) > 1e-6:
        raise ValueError(f"GLs do not sum to 1: {gls} (sum={total})")
    rounded = [round(g, precision) for g in gls]
    resid = 1.0 - sum(rounded)
    imax = rounded.index(max(rounded))
    rounded[imax] = round(rounded[imax] + resid, precision)
    return rounded

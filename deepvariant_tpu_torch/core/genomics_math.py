"""Log-space genotype-likelihood math and phred conversions.

The port's copy of `deepvariant_tpu.core.genomics_math` (semantics of
nucleus genomics_math.py:126,196, re-derived from the published
formulas, in numpy): what the candidate caller and the CVO writer use.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

# Maximum confidence we will emit: caps phred scores at ~99 (reference
# genomics_math.py:100 uses 1.0 - 1.25e-10).
_MAX_CONFIDENCE = 1.0 - 1.25e-10
LOG_10_OF_E = math.log10(math.e)


def perror_to_bounded_log10_perror(
    perror: float, min_prob: float = 1.0 - _MAX_CONFIDENCE
) -> float:
    """log10(p) bounded below by log10(min_prob) (genomics_math.py:106)."""
    if perror > 1.0 or perror < 0.0:
        raise ValueError(f"perror must be in [0,1]: {perror}")
    return math.log10(max(perror, min_prob))


def log10_ptrue_to_phred(log10_ptrue: float, value_if_not_finite: float) -> float:
    """Phred score of (1 - p) where log10(p) is given: -10*log10(1-p)."""
    ptrue = 10.0 ** log10_ptrue
    if ptrue >= 1.0:
        return value_if_not_finite
    result = -10.0 * math.log10(1.0 - ptrue)
    if not math.isfinite(result):
        return value_if_not_finite
    return result


def ptrue_to_bounded_phred(ptrue: float, max_prob: float = _MAX_CONFIDENCE) -> float:
    """-10 log10(1 - min(ptrue, max_prob)) (genomics_math.py:126)."""
    if ptrue > 1.0 or ptrue < 0.0:
        raise ValueError(f"ptrue must be in [0,1]: {ptrue}")
    return -10.0 * math.log10(1.0 - min(ptrue, max_prob))


def phred_to_perror(phred: float) -> float:
    return 10.0 ** (-phred / 10.0)


def perror_to_phred(perror: float) -> float:
    return -10.0 * math.log10(perror)


def log10_binomial(k: int, n: int, p: float) -> float:
    """log10 of the binomial pmf C(n,k) p^k (1-p)^(n-k)
    (genomics_math.py log10_binomial; math.cc Log10Binomial), computed
    with lgamma so large n stays exact to double precision."""
    if not 0 <= k <= n:
        raise ValueError(f"k must be in [0, n]: k={k} n={n}")
    log_comb = (
        math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)
    )
    terms = log_comb * LOG_10_OF_E
    if k > 0:
        terms += k * math.log10(p)
    if n - k > 0:
        terms += (n - k) * math.log10(1.0 - p)
    return terms


def normalize_log10_probs(log10_probs: Sequence[float]) -> np.ndarray:
    """Normalize log10 probabilities so probs sum to 1 (genomics_math.py:196).

    Uses the log-sum-exp trick in base 10.
    """
    arr = np.asarray(log10_probs, dtype=np.float64)
    if np.any(arr > 1e-6):
        raise ValueError(f"log10 probs must be <= 0: {arr}")
    m = np.max(arr)
    lse = m + np.log10(np.sum(10.0 ** (arr - m)))
    return np.minimum(arr - lse, 0.0)


def log10sumexp(log10_probs: Sequence[float]) -> float:
    arr = np.asarray(log10_probs, dtype=np.float64)
    m = np.max(arr)
    return float(m + np.log10(np.sum(10.0 ** (arr - m))))


def round_gls(gls: Sequence[float], precision: int = 10) -> list:
    """Round genotype probabilities, keeping the sum at 1.

    Mirrors the reference's behavior (call_variants.py:248-263): verifies the
    input sums to ~1, rounds each value, and puts the residual on the max
    element so the rounded vector still sums to exactly 1.
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

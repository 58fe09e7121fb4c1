"""The numbers that decide `correct`, worked out from what the timed
path produced and what the reference computed."""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

# A leaf whose reference gradient is under this share of the median
# leaf's is nought to rounding (it moves under Adam by round-off alone)
# and is left out of the gradient and change gaps.
TINY_GRADIENT = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(t.detach().double().norm())


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    norms = {k: _norm(v) for k, v in ref_grads.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= TINY_GRADIENT * median]


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              leaves: List[str]) -> List[float]:
    """For each of `leaves`, | |got| - |want| | / max(|want|, the median
    leaf's |want|): the gap between the two norms of the leaf, against
    the reference's norm of that leaf or of the median leaf."""
    want_norms = {k: _norm(want[k]) for k in leaves}
    median = statistics.median(want_norms.values())
    return [abs(_norm(got[k]) - want_norms[k]) / max(want_norms[k], median)
            for k in leaves]


def leaf_diffs(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
               leaves: List[str]) -> List[float]:
    """For each of `leaves`, |got - want| / max(|want|, the median leaf's
    |want|): the norm of the difference, which a leaf of the right size
    pointing elsewhere cannot pass, against the same scale."""
    want_norms = {k: _norm(want[k]) for k in leaves}
    median = statistics.median(want_norms.values())
    return [_norm(got[k].to(want[k].dtype) - want[k])
            / max(want_norms[k], median, 1e-30) for k in leaves]


def loss_gap(got: List[float], want: List[float]) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def count_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Half the summed gap between two tables of counts over the
    reference's total: the share of rows counted in another cell, or
    missing."""
    got, want = got.double(), want.double().to(got.device)
    return float(((got - want).abs().sum() / 2
                  + (want.sum() - got.sum()).abs() / 2) / want.sum())


def worst_leaves(got, want, leaves, k: int = 8) -> List:
    """The `k` leaves with the widest gaps: [name, gap, |got| / |want|,
    |want| / the median leaf's]."""
    gaps = leaf_gaps(got, want, leaves)
    median = statistics.median(_norm(want[n]) for n in leaves)
    top = sorted(zip(gaps, leaves), reverse=True)[:k]
    return [[n, g, _norm(got[n]) / max(_norm(want[n]), 1e-30),
             _norm(want[n]) / median] for g, n in top]

"""Learned multiallelic genotype resolver.

The reference ships a small trained keras model
(deepvariant/multiallelic_model/, loaded by get_multiallelic_model,
postprocess_variants.py:1034-1054) that maps the three CNN output
distributions of a two-alt site — P(gt | alt1 image), P(gt | alt2
image), P(gt | alt1+alt2 image), 9 floats — to the 6 diploid genotype
probabilities (0/0, 0/1, 1/1, 0/2, 1/2, 2/2).

The architecture is a 9 -> 8 -> 16 -> 8 -> 6 relu MLP with softmax
output; the released weights are bundled as
data/multiallelic_model.npz and evaluated with plain numpy (host-side,
a handful of FLOPs per site — no accelerator involvement wanted in
this string-heavy stage). The numpy forward matches the reference
SavedModel to ~1e-7.

The port's copy of `deepvariant_tpu.postprocess.multiallelic_model`,
with its own copy of the weights file: the same numpy forward on the
same arrays, so the same probabilities bit for bit.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Sequence, Set

import numpy as np

_WEIGHTS_PATH = os.path.join(
    os.path.dirname(__file__), "data", "multiallelic_model.npz"
)
_LAYERS = ("dense", "dense_1", "dense_2", "dense_3")


def load_multiallelic_model(
    weights_path: str = "",
) -> Callable[[np.ndarray], np.ndarray]:
    """Returns fn((N, 9) probs) -> (N, 6) genotype probabilities."""
    data = np.load(weights_path or _WEIGHTS_PATH)
    weights = [
        (data[f"{name}_kernel"], data[f"{name}_bias"])
        for name in _LAYERS
    ]

    def forward(x: np.ndarray) -> np.ndarray:
        h = np.asarray(x, np.float32)
        for i, (kernel, bias) in enumerate(weights):
            h = h @ kernel + bias
            if i < len(weights) - 1:
                h = np.maximum(h, 0.0)
        e = np.exp(h - h.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    return forward


def get_multiallelic_distributions(
    cvos: Sequence, pruned_alleles: Set[str]
) -> Optional[np.ndarray]:
    """(1, 9) model input from a two-alt site's CVOs
    (postprocess_variants.py:973-1031): probs for the alt1 image, the
    alt2 image, then the joint alt1/alt2 image, skipping CVOs that
    reference pruned alleles. Returns None when the expected three
    distributions are not all present."""
    probs_by_key: Dict[object, Sequence[float]] = {}
    first_alt = second_alt = None
    for cvo in cvos:
        indices = list(cvo.alt_allele_indices)
        alleles = [cvo.variant.alternate_bases[i] for i in indices]
        if any(a in pruned_alleles for a in alleles):
            continue
        if len(indices) == 2:
            first_alt, second_alt = min(indices), max(indices)
            probs_by_key[(first_alt, second_alt)] = list(
                cvo.genotype_probabilities
            )
    if first_alt is None:
        return None
    for cvo in cvos:
        indices = list(cvo.alt_allele_indices)
        if len(indices) == 1 and indices[0] in (first_alt, second_alt):
            probs_by_key[indices[0]] = list(cvo.genotype_probabilities)
    if len(probs_by_key) != 3:
        return None
    return np.array([
        probs_by_key[first_alt]
        + probs_by_key[second_alt]
        + probs_by_key[(first_alt, second_alt)]
    ], np.float32)

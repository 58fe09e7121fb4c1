"""The candidate record that the pileup planners read.

A copy of the `DeepVariantCall` dataclass of
`deepvariant_tpu.make_examples.variant_caller`; the caller itself is not
part of the port yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from deepvariant_tpu_torch.core.types import Variant


@dataclasses.dataclass
class DeepVariantCall:
    """A candidate: variant + supporting-read map (deepvariant.proto
    DeepVariantCall semantics; read names replaced by batch read indices)."""

    variant: Variant
    allele_support: Dict[str, List[int]]  # alt string -> read indices
    ref_support: List[int] = dataclasses.field(default_factory=list)
    allele_frequencies: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    # Per-position integer VAF (0-100) over the small-model context
    # window around the candidate; keys are absolute genome positions.
    allele_frequency_at_position: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    # (allele bases, allele type) -> vcf alt string, kept so other
    # samples' read support can be computed for the same candidate.
    allele_keys: Dict[Tuple[str, int], str] = dataclasses.field(
        default_factory=dict
    )

"""The port's copy of `deepvariant_tpu.labeler.combined_labeler`: host code,
with the same dict and sort orders, so its labels and metrics equal the
JAX package's.

Combined positional + haplotype labeler
(reference labeler/combined_labeler.py:37-124).

SNP candidates always take the haplotype labeler's output; indel
candidates take it only when it assigned a non-hom-ref genotype,
falling back to the positional labeler otherwise — the haplotype
matcher is more accurate on complex representations, while the
positional matcher rescues indels the haplotype search zeroed out.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

from deepvariant_tpu_torch.core.ranges import RangeSet
from deepvariant_tpu_torch.core.types import Range, Variant
from deepvariant_tpu_torch.labeler.haplotype_labeler import HaplotypeLabeler
from deepvariant_tpu_torch.labeler.variant_labeler import (
    PositionalVariantLabeler,
    VariantLabel,
)


def _is_snp(variant: Variant) -> bool:
    return (
        len(variant.reference_bases) == 1
        and len(variant.alternate_bases) >= 1
        and all(len(a) == 1 for a in variant.alternate_bases)
    )


class CombinedLabeler:
    """combined_labeler.py:37 CombinedLabeler."""

    def __init__(
        self,
        truth_vcf_reader,
        ref_reader,
        confident_regions: RangeSet,
        **haplotype_kwargs,
    ):
        self._positional = PositionalVariantLabeler(
            truth_vcf_reader, confident_regions
        )
        self._haplotype = HaplotypeLabeler(
            truth_vcf_reader, ref_reader, confident_regions,
            **haplotype_kwargs,
        )

    @property
    def metrics(self):
        """Haplotype-side LabelingMetrics (the primary labeler)."""
        return self._haplotype.metrics

    @staticmethod
    def variant_key(variant: Variant) -> str:
        return (
            f"{variant.reference_name}-{variant.start}-"
            f"{variant.reference_bases}"
        )

    def label_variants(
        self, variants: Sequence[Variant], region: Optional[Range] = None
    ) -> Iterator[VariantLabel]:
        variants = list(variants)
        positional_by_key = {
            self.variant_key(l.variant): l
            for l in self._positional.label_variants(variants, region)
        }
        haplotype_by_key = {
            self.variant_key(l.variant): l
            for l in self._haplotype.label_variants(variants, region)
        }
        for variant in variants:
            key = self.variant_key(variant)
            positional = positional_by_key.get(key)
            haplotype = haplotype_by_key.get(key)
            if not positional and not haplotype:
                continue
            if _is_snp(variant):
                if haplotype:
                    yield haplotype
            elif haplotype and tuple(haplotype.genotype or ()) != (0, 0):
                yield haplotype
            elif positional:
                yield positional

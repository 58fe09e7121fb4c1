"""The port's copy of `deepvariant_tpu.labeler.customized_classes_labeler`: host code,
with the same dict and sort orders, so its labels and metrics equal the
JAX package's.

Customized-classes labeler (reference
labeler/customized_classes_labeler.py): labels come from a truth-VCF
INFO field (e.g. INFO/type in {ref,class1,class2}) instead of genotype
copies — used for models trained to predict custom classes.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.core.ranges import RangeSet
from deepvariant_tpu_torch.core.types import Range, Variant
from deepvariant_tpu_torch.labeler.variant_labeler import (
    PositionalVariantLabeler,
)

DEFAULT_INFO_FIELD_NAME = "type"


class CustomizedClassesVariantLabel:
    """(customized_classes_labeler.py:40-140)."""

    def __init__(self, is_confident: bool, variant: Variant,
                 truth_variant: Optional[Variant], classes_list: str,
                 info_field_name: str):
        self.info_field_name = info_field_name
        self.classes_dict = {
            k: v for v, k in enumerate(classes_list.split(","))
        }
        self.is_confident = is_confident
        self.variant = variant
        self.truth_variant = truth_variant
        # genotype kept for interface parity with VariantLabel.
        self.genotype = tuple(
            truth_variant.calls[0].genotype
        ) if truth_variant and truth_variant.calls else None

    def get_class_status(self, info_field) -> str:
        if self.info_field_name not in info_field:
            raise ValueError(
                "Cannot create class labels: VCF file does not contain "
                f"INFO/{self.info_field_name} field"
            )
        value = info_field[self.info_field_name][0]
        value = value if isinstance(value, str) else str(value)
        if value not in self.classes_dict:
            raise ValueError(
                f"class status '{value}' not in configured classes "
                f"{sorted(self.classes_dict)}"
            )
        return value

    def label_for_alt_alleles(
        self, alt_alleles_indices: Sequence[int]
    ) -> int:
        if not self.truth_variant:
            return 0
        if self.truth_variant.calls and \
                self.truth_variant.calls[0].genotype == [0, 0]:
            return 0
        if self.truth_variant.reference_bases != \
                self.variant.reference_bases:
            return 0
        true_class = self.get_class_status(self.truth_variant.info)
        truth_alt = self.truth_variant.alternate_bases[0]
        label = 0
        for ind in alt_alleles_indices:
            if ind < len(self.variant.alternate_bases) and \
                    self.variant.alternate_bases[ind] == truth_alt:
                label = self.classes_dict[true_class]
        return label


class CustomizedClassesVariantLabeler(PositionalVariantLabeler):
    """Position-matching labeler emitting custom-class labels."""

    def __init__(self, truth_vcf_reader,
                 confident_regions: Optional[RangeSet],
                 classes_list: str,
                 info_field_name: str = DEFAULT_INFO_FIELD_NAME):
        super().__init__(truth_vcf_reader, confident_regions)
        self.classes_list = classes_list
        self.info_field_name = info_field_name

    def label_variants(
        self, variants: Sequence[Variant], region: Optional[Range] = None
    ) -> Iterator[CustomizedClassesVariantLabel]:
        for variant in variants:
            is_confident, truth_variant = self._match(variant)
            # Synthetic hom-ref truths (no INFO field) -> no class.
            if truth_variant is not None and \
                    self.info_field_name not in truth_variant.info:
                truth_variant = None
            yield CustomizedClassesVariantLabel(
                is_confident=is_confident,
                variant=variant,
                truth_variant=truth_variant,
                classes_list=self.classes_list,
                info_field_name=self.info_field_name,
            )

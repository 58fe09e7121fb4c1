"""The port's copy of `deepvariant_tpu.labeler.variant_labeler`: host code,
with the same dict and sort orders, so its labels and metrics equal the
JAX package's.

Training labelers: assign {0,1,2} labels to candidates from truth.

Implements the base VariantLabeler / VariantLabel API
(reference labeler/variant_labeler.py:44-160) and the positional
labeler (labeler/positional_labeler.py:39-250): match candidates to
truth variants by start position, map true genotype alleles onto the
candidate's alts by simplified-allele comparison, and produce the
per-example class = number of copies of the example's alt alleles in
the true genotype (label_for_alt_alleles, variant_labeler.py:68-92).

The haplotype labeler (exhaustive diploid haplotype matching,
labeler/haplotype_labeler.py here) is the reference's default;
make_labeler() dispatches on labeler_algorithm.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.core.ranges import RangeSet
from deepvariant_tpu_torch.core.types import Range, Variant, VariantCall
from deepvariant_tpu_torch.postprocess.genotype import (
    simplify_alleles,
    simplify_variant_alleles,
)


@dataclasses.dataclass
class VariantLabel:
    """Label assignment for one candidate (variant_labeler.py:44)."""

    is_confident: bool
    variant: Variant
    genotype: Optional[Tuple[int, ...]] = None

    def label_for_alt_alleles(self, alt_alleles_indices: Sequence[int]) -> int:
        """Copies of the example's alts in the true genotype
        (variant_labeler.py:68-92)."""
        return sum(
            gt - 1 in alt_alleles_indices
            for gt in (self.genotype or ())
            if gt != 0
        )


def is_filtered(variant: Variant) -> bool:
    """Non-PASS FILTER check (nucleus variant_utils.is_filtered)."""
    return bool(variant.filter) and any(
        f not in ("PASS", ".") for f in variant.filter
    )


class PositionalVariantLabeler:
    """Position-match labeler (positional_labeler.py:39)."""

    def __init__(self, truth_vcf_reader, confident_regions: Optional[RangeSet]):
        if truth_vcf_reader is None:
            raise ValueError("truth_vcf_reader cannot be None")
        self._truth = truth_vcf_reader
        self._confident_regions = confident_regions

    def label_variants(
        self, variants: Sequence[Variant], region: Optional[Range] = None
    ) -> Iterator[VariantLabel]:
        for variant in variants:
            is_confident, truth_variant = self._match(variant)
            genotype = None
            if truth_variant is not None:
                genotype = _genotype_from_matched_truth(
                    variant, truth_variant
                )
            yield VariantLabel(
                is_confident=is_confident,
                variant=variant,
                genotype=genotype,
            )

    def _match(self, variant: Variant):
        variant = simplify_variant_alleles(_copy(variant))
        matched = self._find_matching_variant(variant)
        confident = (
            self._confident_regions is None
            or self._confident_regions.variant_overlaps(variant)
        )
        if matched is None and confident:
            matched = Variant(
                reference_name=variant.reference_name,
                start=variant.start,
                end=variant.end,
                reference_bases=variant.reference_bases,
                alternate_bases=list(variant.alternate_bases),
                calls=[VariantCall(genotype=[0, 0])],
            )
        return confident, matched

    def _get_truth_variants(self, region: Range):
        """Truth records usable for labeling: drops FILTERed truth and
        truth outside the confident regions
        (variant_labeler.py:191-213)."""
        for tv in self._truth.query(region):
            if is_filtered(tv):
                continue
            if (self._confident_regions is not None
                    and not self._confident_regions.variant_overlaps(tv)):
                continue
            yield tv

    def _find_matching_variant(self, variant: Variant):
        region = Range(
            variant.reference_name, variant.start, variant.start + 1
        )
        matches = [
            simplify_variant_alleles(_copy(tv))
            for tv in self._get_truth_variants(region)
            if variant.start == tv.start
        ]
        if not matches:
            return None
        best = None
        for match in matches:
            if (match.alternate_bases == variant.alternate_bases
                    and match.reference_bases == variant.reference_bases):
                best = match  # last exact match wins (reference :152-158)
        return best if best is not None else matches[0]


def _copy(variant: Variant) -> Variant:
    import copy

    return copy.deepcopy(variant)


def _genotype_from_matched_truth(
    candidate_variant: Variant, truth_variant: Variant
) -> Tuple[int, ...]:
    """(positional_labeler.py:182-250)."""
    if candidate_variant is None:
        raise ValueError("variant cannot be None")
    if truth_variant is None:
        raise ValueError("truth_variant cannot be None")
    if len(truth_variant.calls) != 1:
        raise ValueError(
            "Expected exactly one VariantCall in truth_variant "
            f"{truth_variant}"
        )
    gts = truth_variant.calls[0].genotype
    if not any(g >= 0 for g in gts):
        raise ValueError(
            "truth_variant needs genotypes to be used for labeling"
        )

    def match_one_allele(true_allele: str) -> int:
        if true_allele == truth_variant.reference_bases:
            return 0
        simplified_true = simplify_alleles(
            truth_variant.reference_bases, true_allele
        )
        for alt_index, alt_allele in enumerate(
            candidate_variant.alternate_bases
        ):
            simplified_alt = simplify_alleles(
                candidate_variant.reference_bases, alt_allele
            )
            if simplified_true == simplified_alt:
                return alt_index + 1
        return 0

    if not candidate_variant.alternate_bases or \
            candidate_variant.alternate_bases == ["."]:
        return (0, 0)
    truth_alleles = [truth_variant.reference_bases] + list(
        truth_variant.alternate_bases
    )
    # Truth genotype is unphased and the mapped result canonicalized
    # ascending (variant_labeler.py:285-290 sorts the output;
    # positional_labeler.py:244-249 unphases the input).
    gt = sorted(truth_variant.calls[0].genotype)
    return tuple(sorted(
        match_one_allele(truth_alleles[g]) if 0 <= g < len(truth_alleles)
        else 0
        for g in gt
    ))


def make_labeler(options, ref_reader):
    """Build the labeler configured in MakeExamplesOptions."""
    from deepvariant_tpu_torch.io.vcf import VcfReader

    truth = VcfReader(options.truth_variants_filename)
    confident = None
    if options.confident_regions_filename:
        from deepvariant_tpu_torch.core.ranges import read_bed

        confident = RangeSet(
            read_bed(options.confident_regions_filename)
        )
    if options.labeler_algorithm == "positional_labeler":
        return PositionalVariantLabeler(truth, confident)
    if options.labeler_algorithm == "customized_classes_labeler":
        from deepvariant_tpu_torch.labeler.customized_classes_labeler import (
            CustomizedClassesVariantLabeler,
        )

        return CustomizedClassesVariantLabeler(
            truth, confident,
            classes_list=(
                options.customized_classes_labeler_classes_list
                or "ref,class1,class2"
            ),
            info_field_name=(
                options.customized_classes_labeler_info_field_name
                or "type"
            ),
        )
    if options.labeler_algorithm == "soft_labeler":
        from deepvariant_tpu_torch.labeler.soft_labeler import SoftLabeler

        if confident is None:
            return PositionalVariantLabeler(truth, confident)
        return SoftLabeler(truth, ref_reader, confident)
    if options.labeler_algorithm == "combined_labeler":
        from deepvariant_tpu_torch.labeler.combined_labeler import (
            CombinedLabeler,
        )

        if confident is None:
            return PositionalVariantLabeler(truth, confident)
        return CombinedLabeler(truth, ref_reader, confident)
    if options.labeler_algorithm == "haplotype_labeler":
        from deepvariant_tpu_torch.labeler.haplotype_labeler import (
            HaplotypeLabeler,
        )

        if confident is None:
            # Haplotype labeling requires confident regions; fall back to
            # positional matching without them (reference requires the
            # flag in this mode).
            return PositionalVariantLabeler(truth, confident)
        return HaplotypeLabeler(truth, ref_reader, confident)
    raise ValueError(
        f"unknown labeler_algorithm: {options.labeler_algorithm}"
    )


def make_label_fn(options, ref_reader):
    """fn(variant, alt_allele_indices) -> Optional[int] used by the
    ExamplesBuilder in training mode; None = not confident (skip)."""
    labeler = make_labeler(options, ref_reader)

    def label_fn(variant: Variant, alt_allele_indices: List[int]):
        label = next(iter(labeler.label_variants([variant])))
        if not label.is_confident:
            return None
        return label.label_for_alt_alleles(alt_allele_indices)

    return label_fn

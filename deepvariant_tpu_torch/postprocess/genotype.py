"""Genotype resolution from CNN probabilities.

The port's copy of `deepvariant_tpu.postprocess.genotype`, host code in
Python and numpy with the same float operation order.

Behavior mirrors the reference's postprocess_variants.py:
  most_likely_genotype (:380-464), compute_quals (:611-645),
  add_call_to_variant (:555-608), maybe_phase_genotype (:498-553),
  uncall_gt_if_no_ad (:466-473), uncall_homref_gt_if_lowqual (:476-495),
  correct_nonautosome_probabilities (:1070-1091),
  compute_filter_fields (dv_vcf_constants.py:205-227),
  simplify_alleles (nucleus variant_utils.py:496-533).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core import genomics_math
from deepvariant_tpu_torch.core.types import Variant, VariantCall
from deepvariant_tpu_torch.io.vcf import (
    NO_CALL_FILTER,
    PASS_FILTER,
    QUAL_FILTER,
    REF_FILTER,
    UNCALLED_GENOTYPE,
)

# INFO keys used to carry phasing from make_examples
# (dv_constants.py:203-204).
PHASED_GENOTYPE = "ALT_PS"
VARIANT_PHASE_SET = "PS_CONTIG"

_QUAL_PRECISION = 7  # postprocess_variants.py:320
_FILTERED_ALT_PROB = -9.0  # placeholder for soft-filtered alleles (:327)
CNN_HOMREF_CALL_MIN_GQ = 20.0  # flag default (:116-123)

# Format fields indexed by allele, cleaned on allele pruning (:310-318).
_ALT_ALLELE_INDEXED_FORMAT_FIELDS = frozenset([
    ("AD", True),
    ("VAF", False),
    ("MF", True),
    ("MD", True),
    ("NAD", True),
    ("NAF", False),
])


def genotype_order(n_alleles: int) -> Iterator[Tuple[int, int]]:
    """VCF GL ordering for diploid: (j,k) with index k(k+1)/2 + j."""
    for h1 in range(n_alleles):
        for h2 in range(h1 + 1):
            yield h2, h1


def genotype_index(a: int, b: int) -> int:
    """Diploid GL index for genotype a/b (a <= b): b(b+1)/2 + a."""
    if a > b:
        a, b = b, a
    return b * (b + 1) // 2 + a


def most_likely_genotype(
    predictions: Sequence[float], ploidy: int = 2, n_alleles: int = 2
) -> Tuple[int, List[int]]:
    """argmax prediction -> (index, [allele_a, allele_b]) in VCF order."""
    if ploidy != 2:
        raise NotImplementedError("Ploidy != 2 not yet implemented.")
    if n_alleles < 2:
        raise ValueError(f"n_alleles must be >= 2 but got {n_alleles}")
    index_of_max = int(np.argmax(predictions))
    index = 0
    for h1 in range(0, n_alleles + 1):
        for h2 in range(0, h1 + 1):
            if index == index_of_max:
                return index, [h2, h1]
            index += 1
    raise ValueError(
        f"No corresponding GenotypeType for predictions {predictions}"
    )


def compute_quals(
    predictions: Sequence[float], prediction_index: int
) -> Tuple[int, float]:
    """(GQ, QUAL) from the probability distribution."""
    gq = int(
        np.around(
            genomics_math.ptrue_to_bounded_phred(
                predictions[prediction_index]
            )
        )
    )
    qual = genomics_math.ptrue_to_bounded_phred(
        min(sum(predictions[1:]), 1.0)
    )
    return gq, round(qual, _QUAL_PRECISION)


def simplify_alleles(*alleles: str) -> Tuple[str, ...]:
    """Strip common postfix bases, never emptying an allele."""
    postfix_len = 0
    min_len = min(len(a) for a in alleles)
    while postfix_len < min_len - 1:
        chars = {a[len(a) - postfix_len - 1] for a in alleles}
        if len(chars) != 1:
            break
        postfix_len += 1
    if postfix_len == 0:
        return tuple(alleles)
    return tuple(a[: len(a) - postfix_len] for a in alleles)


def simplify_variant_alleles(variant: Variant) -> Variant:
    simplified = simplify_alleles(
        variant.reference_bases, *variant.alternate_bases
    )
    variant.reference_bases = simplified[0]
    variant.alternate_bases = list(simplified[1:])
    variant.end = variant.start + len(variant.reference_bases)
    return variant


def only_call(variant: Variant) -> VariantCall:
    if len(variant.calls) != 1:
        raise ValueError(
            f"expected exactly one call, got {len(variant.calls)}"
        )
    return variant.calls[0]


def genotype_type(variant: Variant) -> str:
    """'no_call' | 'hom_ref' | 'het' | 'hom_alt' (variant_utils parity)."""
    if not variant.calls or not variant.calls[0].genotype:
        return "no_call"
    gt = variant.calls[0].genotype
    if any(g == UNCALLED_GENOTYPE for g in gt):
        return "no_call"
    if all(g == 0 for g in gt):
        return "hom_ref"
    alts = {g for g in gt if g > 0}
    if len(set(gt)) == 1:
        return "hom_alt"
    return "het"


def compute_filter_fields(variant: Variant, min_quality: float) -> List[str]:
    gtype = genotype_type(variant)
    if gtype == "no_call":
        return [NO_CALL_FILTER]
    if gtype == "hom_ref":
        return [REF_FILTER]
    if variant.quality < min_quality:
        return [QUAL_FILTER]
    return [PASS_FILTER]


def maybe_phase_genotype(
    variant: Variant, genotype: List[int]
) -> Tuple[bool, List[int]]:
    """Order genotype alleles by haplotype using ALT_PS phase info."""
    if not (variant.info.get(VARIANT_PHASE_SET)
            and variant.info.get(PHASED_GENOTYPE)):
        return False, genotype
    phase_info = [int(p) for p in variant.info[PHASED_GENOTYPE]]
    if max(genotype) >= len(phase_info):
        return False, genotype
    allele_1_hap = phase_info[genotype[0]]
    allele_2_hap = phase_info[genotype[1]]
    is_phased = (
        0 not in (allele_1_hap, allele_2_hap)
        and allele_1_hap != allele_2_hap
    )
    if is_phased:
        genotype = [genotype[allele_1_hap - 1], genotype[allele_2_hap - 1]]
    return is_phased, genotype


def determine_methylation_type(
    mf_values, low_threshold: float = 0.2, high_threshold: float = 0.8
) -> str:
    """MT from MF values (variantcall_utils.py:461-486): '0/1' when one
    allele is low and another high, '1/1' fully methylated, else '0/0'."""
    if not mf_values:
        return ""
    below_low = any(mf <= low_threshold for mf in mf_values)
    above_high = any(mf >= high_threshold for mf in mf_values)
    if below_low and above_high:
        return "0/1"
    if above_high:
        return "1/1"
    return "0/0"


def uncall_gt_if_no_ad(variant: Variant) -> None:
    call = only_call(variant)
    ad = call.info.get("AD", [])
    if sum(int(a) for a in ad) == 0:
        call.genotype = [UNCALLED_GENOTYPE, UNCALLED_GENOTYPE]
        call.genotype_likelihood = [0.0, 0.0]
        call.info["GQ"] = [0]


def uncall_homref_gt_if_lowqual(
    variant: Variant, min_homref_gq: float
) -> None:
    call = only_call(variant)
    gq = call.info.get("GQ", [0])[0]
    if variant.filter == [REF_FILTER] and gq < min_homref_gq:
        call.genotype = [UNCALLED_GENOTYPE, UNCALLED_GENOTYPE]
        variant.filter = [NO_CALL_FILTER]


def add_call_to_variant(
    variant: Variant,
    predictions: Sequence[float],
    qual_filter: float,
    sample_name: Optional[str],
    cnn_homref_call_min_gq: float = CNN_HOMREF_CALL_MIN_GQ,
) -> Variant:
    """Fill GT/GQ/GL/QUAL/FILTER on `variant` from `predictions`."""
    call = only_call(variant)
    n_alleles = len(variant.alternate_bases) + 1
    index, genotype = most_likely_genotype(predictions, n_alleles=n_alleles)
    gq, variant.quality = compute_quals(predictions, index)
    call.call_set_name = sample_name or call.call_set_name
    call.is_phased, genotype = maybe_phase_genotype(variant, genotype)
    if any(float(f) > 0 for f in call.info.get("MF", [])):
        # Methylation type from per-allele fractions
        # (postprocess_variants.py:593-598, is_methylated :864).
        call.info["MT"] = [
            determine_methylation_type(
                [float(f) for f in call.info["MF"]]
            )
        ]
    call.genotype = genotype
    call.info["GQ"] = [gq]
    call.genotype_likelihood = [
        genomics_math.perror_to_bounded_log10_perror(gp)
        for gp in predictions
    ]
    uncall_gt_if_no_ad(variant)
    variant.filter = compute_filter_fields(variant, qual_filter)
    uncall_homref_gt_if_lowqual(variant, cnn_homref_call_min_gq)
    return variant


def correct_nonautosome_probabilities(
    probabilities: List[float], variant: Variant
) -> List[float]:
    """Zero het probabilities for haploid contigs, renormalize."""
    n_alleles = len(variant.alternate_bases) + 1
    index = 0
    for h1 in range(0, n_alleles):
        for h2 in range(0, h1 + 1):
            if h2 != h1:
                if len(probabilities) <= index:
                    raise ValueError(
                        "Probabilities array doesn't match alt alleles."
                    )
                probabilities[index] = 0
            index += 1
    new_sum = sum(probabilities) or 1.0
    return [p / new_sum for p in probabilities]


def normalize_predictions(predictions: Sequence[float]) -> List[float]:
    """Normalize, treating _FILTERED_ALT_PROB entries as prob 0."""
    if sum(predictions) == 0:
        predictions = [1.0] * len(predictions)
    denominator = sum(
        p if p != _FILTERED_ALT_PROB else 0.0 for p in predictions
    ) or 1.0
    return [
        p / denominator if p != _FILTERED_ALT_PROB else 0.0
        for p in predictions
    ]

"""Multiallelic CVO merging (reference postprocess_variants.py:753-1310).

The port's copy of `deepvariant_tpu.postprocess.merge`.

Groups of CallVariantsOutput for one locus (one per alt-allele combination,
from ADD_HET_ALT_IMAGES pileups) are merged into a single Variant +
genotype-probability vector:

  * biallelic: probabilities pass through (with non-autosome correction);
  * multiallelic: low-qual alleles pruned (`get_alt_alleles_to_remove`),
    then either min-alt flattening over the flattened allele-pair dict
    (default) or the "product" overlap-count fusion mode
    (postprocess_variants.py:1238-1290).
"""

from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import CallVariantsOutput, Variant
from deepvariant_tpu_torch.postprocess import genotype as gt

_FILTERED_ALT_PROB = gt._FILTERED_ALT_PROB
_NUM_GENOTYPE_PROBABILITIES = 3


def expected_alt_allele_indices(num_alternate_bases: int) -> List[List[int]]:
    num_alleles = num_alternate_bases + 1
    combos = [
        sorted(set(x) - {0})
        for x in itertools.combinations(range(num_alleles), 2)
    ]
    return sorted([[i - 1 for i in combo] for combo in combos])


def _check_alt_allele_indices(
    cvos: Sequence[CallVariantsOutput],
) -> bool:
    all_indices = sorted(
        [list(cvo.alt_allele_indices) for cvo in cvos]
    )
    return all_indices == expected_alt_allele_indices(
        len(cvos[0].variant.alternate_bases)
    )


def is_valid_call_variants_outputs(
    cvos: Sequence[CallVariantsOutput],
) -> bool:
    if not cvos:
        return True
    if not _check_alt_allele_indices(cvos):
        return False
    first = cvos[0].variant
    for other in cvos[1:]:
        v = other.variant
        if (v.reference_name != first.reference_name
                or v.start != first.start or v.end != first.end
                or v.reference_bases != first.reference_bases
                or v.alternate_bases != first.alternate_bases):
            return False
    return True


def get_alt_alleles_to_remove(
    cvos: Sequence[CallVariantsOutput], qual_filter: Optional[float]
) -> Set[str]:
    """Alt alleles whose single-allele QUAL (1 - p(ref/ref)) < filter."""
    to_remove: Set[str] = set()
    if not qual_filter or not cvos:
        return to_remove
    max_qual, max_qual_allele = None, None
    canonical = cvos[0].variant
    for cvo in cvos:
        if len(cvo.alt_allele_indices) == 1:
            _, qual = gt.compute_quals(
                cvo.genotype_probabilities, prediction_index=0
            )
            allele = canonical.alternate_bases[cvo.alt_allele_indices[0]]
            if max_qual is None or max_qual < qual:
                max_qual, max_qual_allele = qual, allele
            if qual < qual_filter:
                to_remove.add(allele)
    if len(to_remove) == len(canonical.alternate_bases):
        to_remove -= {max_qual_allele}
    return to_remove


class AlleleRemapper:
    """Removal bookkeeping for allele-indexed FORMAT fields."""

    def __init__(self, original_alts: Sequence[str],
                 alleles_to_remove: Set[str]):
        self.original_alts = list(original_alts)
        self.alleles_to_remove = set(alleles_to_remove)

    def keep_index(self, allele_index: int, ref_is_zero: bool = False) -> bool:
        if ref_is_zero:
            return True if allele_index == 0 else self.keep_index(
                allele_index - 1
            )
        return self.original_alts[allele_index] not in self.alleles_to_remove

    def retained_alt_alleles(self) -> List[str]:
        return [a for a in self.original_alts
                if a not in self.alleles_to_remove]

    def reindex_allele_indexed_fields(self, variant: Variant, fields):
        for field, ref_is_zero in fields:
            for call in variant.calls:
                if field in call.info:
                    call.info[field] = [
                        v for i, v in enumerate(call.info[field])
                        if self.keep_index(i, ref_is_zero=ref_is_zero)
                    ]


def prune_alleles(
    variant: Variant, alt_alleles_to_remove: Set[str]
) -> Variant:
    if not alt_alleles_to_remove:
        return variant
    import copy

    new_variant = copy.deepcopy(variant)
    remapper = AlleleRemapper(variant.alternate_bases, alt_alleles_to_remove)
    remapper.reindex_allele_indexed_fields(
        new_variant, gt._ALT_ALLELE_INDEXED_FORMAT_FIELDS
    )
    new_variant.alternate_bases = remapper.retained_alt_alleles()
    return new_variant


def convert_cvos_to_probs_dict(
    canonical_variant: Variant,
    cvos: Sequence[CallVariantsOutput],
    alt_alleles_to_remove: Set[str],
    keep_filtered: bool = False,
) -> Dict[Tuple[str, str], List[float]]:
    """{(allele1, allele2): [probs]} flattening of the per-image probs.
    `keep_filtered` (--debug_output_all_candidates=ALT) keeps pruned
    alleles with the _FILTERED_ALT_PROB placeholder
    (postprocess_variants.py:783-793)."""
    flattened: Dict[Tuple[str, str], List[float]] = collections.defaultdict(
        list
    )
    for cvo in cvos:
        allele_set1 = frozenset([canonical_variant.reference_bases])
        allele_set2 = frozenset(
            canonical_variant.alternate_bases[i]
            for i in cvo.alt_allele_indices
        )
        has_alleles_to_rm = bool(
            alt_alleles_to_remove.intersection(allele_set2)
        )
        if has_alleles_to_rm and not keep_filtered:
            continue
        if has_alleles_to_rm:
            p11 = p12 = p22 = _FILTERED_ALT_PROB
        else:
            p11, p12, p22 = cvo.genotype_probabilities
        for set1, set2, p in [
            (allele_set1, allele_set1, p11),
            (allele_set1, allele_set2, p12),
            (allele_set2, allele_set2, p22),
        ]:
            for indices in itertools.product(set1, set2):
                flattened[indices].append(p)
    return flattened


def genotype_ordering_in_likelihoods(variant: Variant):
    """Yields (i, j, allele_i, allele_j) in VCF GL order."""
    alleles = [variant.reference_bases] + list(variant.alternate_bases)
    n_alts = len(variant.alternate_bases)
    for j in range(n_alts + 1):
        for i in range(j + 1):
            yield i, j, alleles[i], alleles[j]


def _merge_product_mode(
    cvos: Sequence[CallVariantsOutput],
    canonical_variant: Variant,
    alt_alleles_to_remove: Set[str],
    keep_filtered: bool = False,
) -> List[float]:
    """'product' fusion: per-genotype overlap-count prob product.
    `keep_filtered` keeps pruned-allele examples with placeholder
    probs (postprocess_variants.py:1243-1253,
    --debug_output_all_candidates=ALT)."""
    example_info = []
    original_variant = cvos[0].variant
    for cvo in cvos:
        example_alts = frozenset(
            original_variant.alternate_bases[i]
            for i in cvo.alt_allele_indices
        )
        pruned = bool(alt_alleles_to_remove.intersection(example_alts))
        if pruned and not keep_filtered:
            continue
        probs = ((_FILTERED_ALT_PROB,) * 3 if pruned
                 else cvo.genotype_probabilities)
        example_info.append({"probs": probs, "alts": example_alts})
    predictions = []
    for _, _, allele1, allele2 in genotype_ordering_in_likelihoods(
        canonical_variant
    ):
        probs_for_genotype = []
        for example in example_info:
            overlap = int(allele1 in example["alts"]) + int(
                allele2 in example["alts"]
            )
            probs_for_genotype.append(example["probs"][overlap])
        if _FILTERED_ALT_PROB in probs_for_genotype:
            predictions.append(_FILTERED_ALT_PROB)
        else:
            predictions.append(float(np.prod(probs_for_genotype)))
    return gt.normalize_predictions(predictions)


def merge_predictions(
    cvos: Sequence[CallVariantsOutput],
    qual_filter: Optional[float] = None,
    multiallelic_mode: str = "product",
    haploid_contigs: Optional[Set[str]] = None,
    par_regions=None,
    multiallelic_model=None,
    debug_output_all_candidates: Optional[str] = None,
) -> Tuple[Variant, List[float]]:
    """Merge one locus's CVOs -> (canonical variant, genotype probs).

    `debug_output_all_candidates` ('ALT'|'INFO'|None,
    postprocess_variants.py:212-224): INFO records the full candidate
    alt list in an INFO field before pruning; ALT keeps pruned alleles
    in the output ALTs with zeroed probabilities."""
    if not cvos:
        raise ValueError("Expected 1 or more call_variants_outputs.")
    if not is_valid_call_variants_outputs(cvos):
        raise ValueError("`call_variants_outputs` did not pass sanity check.")

    def non_autosome(variant):
        if not haploid_contigs or variant.reference_name not in \
                haploid_contigs:
            return False
        if par_regions is not None and par_regions.variant_overlaps(variant):
            return False
        return True

    first_call, other_calls = cvos[0], cvos[1:]
    canonical_variant = first_call.variant
    if not other_calls:
        canonical_variant = gt.simplify_variant_alleles(canonical_variant)
        probs = list(first_call.genotype_probabilities)
        if non_autosome(canonical_variant):
            return canonical_variant, gt.correct_nonautosome_probabilities(
                probs, canonical_variant
            )
        return canonical_variant, probs

    alt_alleles_to_remove = get_alt_alleles_to_remove(cvos, qual_filter)
    keep_filtered = debug_output_all_candidates == "ALT"
    flattened = convert_cvos_to_probs_dict(
        canonical_variant, cvos, alt_alleles_to_remove,
        keep_filtered=keep_filtered,
    )
    if debug_output_all_candidates == "INFO":
        canonical_variant.info["CANDIDATES"] = [
            "|".join(canonical_variant.alternate_bases)
        ]
    if not keep_filtered:
        canonical_variant = prune_alleles(
            canonical_variant, alt_alleles_to_remove
        )

    if (multiallelic_model is not None
            and len(canonical_variant.alternate_bases) == 2):
        # Learned resolver for two-alt sites
        # (postprocess_variants.py:1228-1233): the three CVO
        # distributions feed the trained MLP directly.
        from deepvariant_tpu_torch.postprocess.multiallelic_model import (
            get_multiallelic_distributions,
        )

        cvo_probs = get_multiallelic_distributions(
            cvos, alt_alleles_to_remove
        )
        if cvo_probs is None:
            raise ValueError(
                "two-alt site missing expected CVO distributions"
            )
        normalized = [
            float(x) for x in multiallelic_model(cvo_probs)[0]
        ]
    elif multiallelic_mode == "product":
        normalized = _merge_product_mode(
            cvos, canonical_variant, alt_alleles_to_remove,
            keep_filtered=keep_filtered,
        )
    else:
        def min_alt_filter(probs):
            return min(
                [x for x in probs if x != _FILTERED_ALT_PROB] or [0]
            )

        predictions = [
            min_alt_filter(flattened[(m, n)])
            for _, _, m, n in genotype_ordering_in_likelihoods(
                canonical_variant
            )
        ]
        if sum(predictions) == 0:
            predictions = [1.0] * len(predictions)
        normalized = gt.normalize_predictions(predictions)

    canonical_variant = gt.simplify_variant_alleles(canonical_variant)
    if non_autosome(canonical_variant):
        return canonical_variant, gt.correct_nonautosome_probabilities(
            normalized, canonical_variant
        )
    return canonical_variant, normalized

"""Population allele frequencies for candidates.

The port's copy of `deepvariant_tpu.make_examples.allele_frequency`
(behavior of the reference's allele_frequency.py:43-421): candidates
match population-VCF ("cohort") variants by *haplotype* rather than
position — each alt of candidate and cohort variants is substituted
into a shared reference haplotype window; exact haplotype equality
transfers the cohort AF, REF frequency comes from the matching cohort
variant, inexact (REF-only) matches update just the REF frequency, and
unmatched alts get AF 0.  The frequencies feed the allele_frequency
pileup channel (enum 8).
"""

from __future__ import annotations

import collections
import math
from typing import DefaultDict, Dict, Iterable, Iterator, List, Optional, Sequence

from deepvariant_tpu_torch.core.types import Range, Variant
from deepvariant_tpu_torch.make_examples.variant_caller import DeepVariantCall
from deepvariant_tpu_torch.postprocess.genotype import simplify_variant_alleles


def get_allele_frequency(variant: Variant, index: int) -> float:
    """AF of the index-th alt (allele_frequency.py:43-67)."""
    af = variant.info.get("AF")
    if af:
        if index < len(af):
            return float(af[index])
        raise ValueError(
            f"Invalid index {index} for the info[AF] field {af}"
        )
    raise ValueError("Variant does not have an AF field")


def get_ref_allele_frequency(variant: Variant) -> float:
    return 1 - sum(
        get_allele_frequency(variant, i)
        for i in range(len(variant.alternate_bases))
    )


def get_ref_haplotype_and_offset(dv_variant, cohort_variants, ref_reader):
    min_start = min(
        dv_variant.start, min(cv.start for cv in cohort_variants)
    )
    max_end = max(dv_variant.end, max(cv.end for cv in cohort_variants))
    region = Range(dv_variant.reference_name, min_start, max_end)
    if not ref_reader.is_valid(region):
        raise ValueError("Invalid reference region", region)
    return ref_reader.query(region), min_start


def update_haplotype(
    variant: Variant, reference_haplotype: str, reference_offset: int
) -> List[dict]:
    """One substituted haplotype per alt (allele_frequency.py:118-166)."""
    if variant.start < reference_offset:
        raise ValueError(
            "variant starts before the reference haplotype offset",
            variant.start, reference_offset,
        )
    offset_start = variant.start - reference_offset
    offset_suffix = (
        variant.start + len(variant.reference_bases) - reference_offset
    )
    out = []
    for alt in variant.alternate_bases:
        out.append({
            "haplotype": (
                reference_haplotype[:offset_start] + alt
                + reference_haplotype[offset_suffix:]
            ),
            "alt": alt,
            "variant": variant,
        })
    return out


def match_candidate_and_cohort_haplotypes(
    candidate_haps: List[dict], cohort_haps: List[dict]
) -> Dict[str, float]:
    """(allele_frequency.py:168-245)."""
    dict_allele_frequency: Dict[str, float] = {}
    for candidate_obj in candidate_haps:
        candidate_haplotype = candidate_obj["haplotype"]
        candidate_alt = candidate_obj["alt"]
        candidate_variant = candidate_obj["variant"]
        for cohort_obj in cohort_haps:
            if candidate_haplotype == cohort_obj["haplotype"]:
                cohort_variant = cohort_obj["variant"]
                dict_allele_frequency[candidate_alt] = \
                    get_allele_frequency(
                        cohort_variant,
                        list(cohort_variant.alternate_bases).index(
                            cohort_obj["alt"]
                        ),
                    )
                if not dict_allele_frequency.get(
                    candidate_variant.reference_bases
                ):
                    dict_allele_frequency[
                        candidate_variant.reference_bases
                    ] = get_ref_allele_frequency(cohort_variant)
        if not dict_allele_frequency.get(candidate_alt):
            dict_allele_frequency[candidate_alt] = 0

    if sum(dict_allele_frequency.values()) == 0:
        import copy

        candidate = candidate_haps[0]["variant"]
        s_candidate = simplify_variant_alleles(copy.deepcopy(candidate))
        for cohort_obj in cohort_haps:
            s_cohort = simplify_variant_alleles(
                copy.deepcopy(cohort_obj["variant"])
            )
            if (s_candidate.start == s_cohort.start
                    and s_candidate.reference_bases
                    == s_cohort.reference_bases):
                dict_allele_frequency[s_candidate.reference_bases] = \
                    get_ref_allele_frequency(s_cohort)
        if not dict_allele_frequency.get(candidate.reference_bases):
            dict_allele_frequency[candidate.reference_bases] = 1
    return dict_allele_frequency


def find_matching_allele_frequency(
    variant: Variant,
    population_vcf_reader,
    ref_reader,
    padding_bases: int = 0,
) -> Dict[str, float]:
    """(allele_frequency.py:247-330)."""
    query_region = Range(
        variant.reference_name,
        variant.start - padding_bases,
        variant.end + padding_bases,
    )
    cohort_variants = [
        v for v in population_vcf_reader.query(query_region)
        if v.info.get("AF")
    ]
    dict_allele_frequency = {a: 0 for a in variant.alternate_bases}
    if not cohort_variants:
        dict_allele_frequency[variant.reference_bases] = 1
        return dict_allele_frequency
    try:
        reference_haplotype, reference_offset = \
            get_ref_haplotype_and_offset(
                variant, cohort_variants, ref_reader
            )
    except ValueError:
        dict_allele_frequency = {variant.reference_bases: 1}
        for alt in variant.alternate_bases:
            dict_allele_frequency[alt] = 0
        return dict_allele_frequency
    candidate_haps = update_haplotype(
        variant, reference_haplotype, reference_offset
    )
    cohort_haps: List[dict] = []
    for cohort_variant in cohort_variants:
        cohort_haps.extend(update_haplotype(
            cohort_variant, reference_haplotype, reference_offset
        ))
    return match_candidate_and_cohort_haplotypes(
        candidate_haps, cohort_haps
    )


def make_population_vcf_readers(
    population_vcf_filenames: Sequence[str],
):
    """Per-contig reader map (allele_frequency.py:333-385)."""
    from deepvariant_tpu_torch.io.vcf import VcfReader

    if len(population_vcf_filenames) == 1:
        reader = VcfReader(population_vcf_filenames[0])
        return collections.defaultdict(lambda: reader)
    readers: DefaultDict = collections.defaultdict(lambda: None)
    for filename in population_vcf_filenames:
        reader = VcfReader(filename)
        reference_name = None
        for var in reader:
            reference_name = var.reference_name
            break
        if reference_name is None:
            continue
        if readers.get(reference_name):
            raise ValueError(
                f"Variants on {reference_name} are included in "
                "multiple VCFs"
            )
        readers[reference_name] = reader
    return readers


def add_allele_frequencies_to_candidates(
    candidates: Iterable[DeepVariantCall],
    population_vcf_reader,
    ref_reader,
) -> Iterator[DeepVariantCall]:
    """(allele_frequency.py:387-421)."""
    for candidate in candidates:
        if population_vcf_reader:
            dict_allele_frequency = find_matching_allele_frequency(
                candidate.variant, population_vcf_reader, ref_reader
            )
        else:
            dict_allele_frequency = {
                candidate.variant.reference_bases: 1
            }
            for alt in candidate.variant.alternate_bases:
                dict_allele_frequency[alt] = 0
        candidate.allele_frequencies = dict_allele_frequency
        yield candidate

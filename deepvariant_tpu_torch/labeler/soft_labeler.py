"""The port's copy of `deepvariant_tpu.labeler.soft_labeler`: host code,
with the same dict and sort orders, so its labels and metrics equal the
JAX package's.

Soft labeler (reference labeler/soft_labeler.py).

Haplotype-based labeling that additionally explores *modified* truth
indel alleles (trailing bases added/removed, penalty |i|/10 per base,
modify_truth_variant, soft_labeler.py:1179-1231) and keeps every
equally-best haplotype match. Ambiguous multiallelic indel candidates
with full ALT_PS phasing receive soft (HomRef, Het, HomAlt)
probability labels scaled by the modification penalty; everything else
keeps hard one-hot labels (:1266-1285).
"""

from __future__ import annotations

import copy
from typing import Iterator, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.core.ranges import RangeSet
from deepvariant_tpu_torch.core.types import Range, Variant
from deepvariant_tpu_torch.labeler import haplotype_labeler as hl
from deepvariant_tpu_torch.labeler.variant_labeler import VariantLabel


def modify_truth_variant(tv: Variant, ref: hl.ReferenceRegion):
    """Yield (modified_truth, penalty) indel perturbations
    (soft_labeler.py:1179-1231)."""
    for allele_index, allele_orig in enumerate(tv.alternate_bases):
        ref_bases_orig = tv.reference_bases
        is_insertion = len(allele_orig) > len(ref_bases_orig)
        is_deletion = len(ref_bases_orig) > len(allele_orig)
        if not is_insertion and not is_deletion:
            continue
        for i in (-2, -1, 1, 2):
            penalty = abs(i) / 10.0
            mod_tv = copy.deepcopy(tv)
            if is_insertion:
                allele = allele_orig
                if i > 0:
                    if not allele:
                        continue
                    allele = allele + allele[-1] * i
                else:
                    if len(allele) <= -i:
                        continue
                    allele = allele[:i]
                mod_tv.alternate_bases[allele_index] = allele
                yield mod_tv, penalty
            else:
                ref_bases = ref_bases_orig
                if i > 0:
                    if len(ref_bases) - i < len(allele_orig):
                        continue
                    ref_bases = ref_bases[:-i]
                else:
                    bases_to_add = -i
                    if ref.end < tv.end + bases_to_add:
                        continue
                    ref_bases = ref_bases + ref.bases(
                        tv.end, tv.end + bases_to_add
                    )
                mod_tv.reference_bases = ref_bases
                mod_tv.end = mod_tv.start + len(ref_bases)
                yield mod_tv, penalty


def _is_ambiguous_indel(variant: Variant) -> bool:
    is_indel = any(
        len(variant.reference_bases) != len(alt)
        for alt in variant.alternate_bases
    )
    return len(variant.alternate_bases) > 1 and is_indel


def _get_candidate_probs(genotype, penalty) -> Tuple[float, float, float]:
    if sum(genotype) == 0:
        return (1.0, 0.0, 0.0)
    if genotype[0] == genotype[1]:
        return (penalty, 0.0, 1.0 - penalty)
    return (penalty, 1.0 - penalty, 0.0)


def _hard_probs(genotype) -> Tuple[float, float, float]:
    if sum(genotype) == 0:
        return (1.0, 0.0, 0.0)
    if genotype[0] == genotype[1]:
        return (0.0, 0.0, 1.0)
    return (0.0, 1.0, 0.0)


def _fully_phased(variant: Variant, genotype) -> bool:
    alt_ps = variant.info.get("ALT_PS")
    if not alt_ps:
        return False
    return all(
        float(alt_ps[allele_idx - 1]) != 0.0
        for allele_idx in genotype
        if allele_idx > 0 and allele_idx - 1 < len(alt_ps)
    )


def find_all_matching_haplotypes(candidates, truths, ref):
    """All equally-best matches, including penalized modified-truth
    rounds (soft_labeler.py find_best_matching_haplotypes +
    select change :1405-1411). Returns [] when nothing matches."""
    candidates = list(candidates)
    truths = list(truths)

    def enum_or_homref(variants, non_empty_enum):
        return non_empty_enum if variants else \
            hl.EnumerationType.ONLY_HOM_REF

    variant_haplotypes = hl.enumerate_all_possible_haplotypes(
        candidates, ref,
        enum_or_homref(truths, hl.EnumerationType.CANDIDATES),
    )

    found: List[hl.HaplotypeMatch] = []

    def match_round(current_truths, penalties, is_soft, penalty):
        truth_haplotypes = hl.deduplicate_haplotypes(
            hl.enumerate_all_possible_haplotypes(
                current_truths, ref,
                enum_or_homref(candidates, hl.EnumerationType.TRUTH),
            )
        )
        for vh, vgt_list in variant_haplotypes.items():
            tgt = truth_haplotypes.get(vh)
            if tgt is None:
                continue
            for vgt in vgt_list:
                probs = None
                if is_soft:
                    probs = []
                    for cand_idx, gt in enumerate(vgt):
                        cand = candidates[cand_idx]
                        if _is_ambiguous_indel(cand) and \
                                _fully_phased(cand, gt):
                            probs.append(
                                _get_candidate_probs(gt, penalty)
                            )
                        else:
                            probs.append(_hard_probs(gt))
                found.append(hl.HaplotypeMatch(
                    haplotypes=vh,
                    candidates=candidates,
                    candidate_genotypes=vgt,
                    truths=truths,
                    truth_genotypes=tgt,
                    truth_mod_penalties=list(penalties),
                    is_soft_label=is_soft,
                    candidate_probabilities=probs,
                ))

    match_round(truths, [0.0] * len(truths), False, 0.0)
    for i, tv in enumerate(truths):
        truths_copy = list(truths)
        for tv_mod, penalty in modify_truth_variant(tv, ref):
            truths_copy[i] = tv_mod
            penalties = [0.0] * len(truths)
            penalties[i] = penalty
            match_round(truths_copy, penalties, True, penalty)
    if not found:
        return []
    best = min(m.match_metrics for m in found)
    return [m for m in found if m.match_metrics == best]


class SoftLabeler(hl.HaplotypeLabeler):
    """Yields labels for every equally-best match (soft_labeler.py:101)."""

    def label_variants(
        self, variants: Sequence[Variant], region: Range
    ) -> Iterator[VariantLabel]:
        truths = list(self._get_truth_variants(region))
        truths = [
            t for t in truths
            if sum(hl._variant_genotypes([t])[0]) > 0
        ]
        grouped = hl.group_variants(
            candidates=list(variants),
            truths=truths,
            max_group_size=self.max_group_size,
            max_separation=self.max_separation,
            max_gt_options_product=self.max_gt_options_product,
        )
        for candidates_group, truth_group in grouped:
            if not candidates_group:
                continue
            ref = self.make_labeler_ref(candidates_group, truth_group)
            all_labeled = find_all_matching_haplotypes(
                candidates_group, truth_group, ref
            )
            if not all_labeled:
                raise ValueError(
                    "Failed to assign labels for variants",
                    candidates_group, truth_group,
                )
            for labeling in all_labeled:
                self._update_metrics(labeling)
                for labeled in (
                    labeling.candidates_with_assigned_genotypes()
                ):
                    yield VariantLabel(
                        is_confident=(
                            self._confident_regions.variant_overlaps(
                                labeled
                            )
                        ),
                        variant=labeled,
                        genotype=tuple(labeled.calls[0].genotype),
                    )

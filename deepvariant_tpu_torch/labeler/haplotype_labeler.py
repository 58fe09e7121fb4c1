"""The port's copy of `deepvariant_tpu.labeler.haplotype_labeler`: host code,
with the same dict and sort orders, so its labels and metrics equal the
JAX package's.

Haplotype-based training labeler.

Behavior parity with reference labeler/haplotype_labeler.py: assign
genotypes to candidate and truth variants so both sets imply the same
diploid haplotype sequences; candidates' assigned genotypes become
training labels.

Key pieces mirrored:
  * group_variants greedy grouping (:365-539; max 8 variants/type,
    max 30bp separation, genotype-options product cap 100000,
    same-end variants grouped atomically);
  * enumerate_all_possible_haplotypes (:581-653) with CANDIDATES /
    TRUTH (false-negative-expanded, :541-572) / ONLY_HOM_REF genotype
    enumerations;
  * build_haplotype's deletion + common-suffix handling (:850-965);
  * HaplotypeMatch selection by (FN, FP, TP) metrics (:968-1255).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import heapq
import itertools
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Set, Tuple

from deepvariant_tpu_torch.core.ranges import RangeSet
from deepvariant_tpu_torch.core.types import Range, Variant, VariantCall
from deepvariant_tpu_torch.labeler.variant_labeler import VariantLabel

MAX_GROUP_SIZE = 8
MAX_SEPARATION_WITHIN_VARIANT_GROUP = 30
MAX_GT_OPTIONS_PRODUCT = 100000
FORCE_GROUP_WITHIN_BP = 0

VariantAndGenotypes = collections.namedtuple(
    "VariantAndGenotypes", ["variant", "genotypes"]
)
_VariantToGroup = collections.namedtuple(
    "_VariantToGroup", ["start", "type", "variant"]
)
_CANDIDATE_MARKER = "candidate"
_TRUTH_MARKER = "truth"


class ImpossibleHaplotype(Exception):
    pass


class ReferenceRegion:
    """Cached reference interval with bases(start, end) lookup."""

    def __init__(self, bases: str, start: int):
        self._bases = bases
        self.start = start
        self.end = start + len(bases)

    def bases(self, start: int, end: int) -> str:
        return self._bases[start - self.start:end - self.start]


def _variant_genotypes(variants, missing=(-1, -1)):
    return [
        tuple(v.calls[0].genotype) if v.calls and v.calls[0].genotype
        else missing
        for v in variants
    ]


def n_zeroes(gt) -> int:
    return sum(1 for g in gt if g == 0)


def _allele_from_index(variant: Variant, index: int) -> str:
    if index == 0:
        return variant.reference_bases
    return variant.alternate_bases[index - 1]


def _variants_overlap(a: Variant, b: Variant) -> bool:
    return a.start < b.end and b.start < a.end


def with_false_negative_genotypes(gt) -> List[Tuple[int, int]]:
    """(:541-572)."""
    alts = set(gt) - {0}
    return sorted({(0, 0), tuple(gt)} | {(0, alt) for alt in alts})


class EnumerationType:
    CANDIDATES = 1
    TRUTH = 2
    ONLY_HOM_REF = 3


def genotype_options_for_variants(variants, enumeration_type):
    if enumeration_type == EnumerationType.TRUTH:
        return [with_false_negative_genotypes(g)
                for g in _variant_genotypes(variants)]
    if enumeration_type == EnumerationType.CANDIDATES:
        return [
            {(i, j)
             for j in range(len(v.alternate_bases) + 1)
             for i in range(j + 1)}
            for v in variants
        ]
    if enumeration_type == EnumerationType.ONLY_HOM_REF:
        return [{(0, 0)}] * len(variants)
    raise ValueError(f"Unexpected EnumerationType {enumeration_type}")


def split_independent_variants(variants_and_genotypes):
    """(:744-757): leading mutually-overlapping group + the rest."""
    if not variants_and_genotypes:
        raise ValueError("Expected at least one value")
    overlaps = [variants_and_genotypes[0]]
    for i in range(1, len(variants_and_genotypes)):
        vgi = variants_and_genotypes[i].variant
        if any(_variants_overlap(vg.variant, vgi) for vg in overlaps):
            overlaps.append(variants_and_genotypes[i])
        else:
            return overlaps, variants_and_genotypes[i:]
    return overlaps, []


def _longest_common_suffix(a: str, b: str) -> int:
    n = 0
    i, j = len(a), len(b)
    while i > 0 and j > 0 and a[i - 1] == b[j - 1]:
        i -= 1
        j -= 1
        n += 1
    return n


def build_haplotype(variants, allele_indices, ref: ReferenceRegion,
                    ref_start: int, ref_end: int) -> Optional[str]:
    """(:850-965): haplotype string for one phased genotype choice."""
    if len(variants) != len(allele_indices):
        raise ValueError("variants and allele_indices length mismatch")
    if ref_start < 0 or ref_start >= ref_end:
        raise ValueError(f"expected ref_start {ref_start} < {ref_end}")
    parts = []
    position = ref_start
    for variant, allele_index in zip(variants, allele_indices):
        if variant.start < position:
            if allele_index != 0:
                return None
        else:
            ref_prefix = ref.bases(position, variant.start)
            reference_allele = variant.reference_bases
            allele = _allele_from_index(variant, allele_index)
            lcs = _longest_common_suffix(reference_allele, allele)
            if allele_index == 0:
                allele = allele[0]
                position = variant.start + 1
            elif (len(reference_allele) == 1 or len(allele) == 1
                  or lcs == 0):
                position = variant.end
            else:
                allele = allele[:-lcs]
                position = variant.end - lcs
            parts.append(ref_prefix + allele)
    if position < ref_end:
        parts.append(ref.bases(position, ref_end))
    return "".join(parts)


def phased_genotypes_to_haplotypes(variants_and_genotypes, start, ref):
    """(:795-826)."""
    genotypes_to_haplotypes = {}
    genotypes = [vg.genotypes for vg in variants_and_genotypes]
    variants = [vg.variant for vg in variants_and_genotypes]
    end = max(v.end for v in variants)
    for phased in sorted(set(itertools.product(*genotypes))):
        haplotype = build_haplotype(variants, phased, ref, start, end)
        if haplotype:
            genotypes_to_haplotypes[phased] = haplotype
    return genotypes_to_haplotypes, end


def all_diploid_haplotypes(variants_and_genotypes, genotypes2haplotype):
    """(:656-673)."""

    def complement(haploid_genotype, genotypes):
        return tuple(
            g1[1] if hg1 == g1[0] and len(g1) == 2 else g1[0]
            for hg1, g1 in zip(haploid_genotype, genotypes)
        )

    genotypes = [vg.genotypes for vg in variants_and_genotypes]
    generated = set()
    for haploid_genotype, haplotype in genotypes2haplotype.items():
        comp = complement(haploid_genotype, genotypes)
        comp_haplotype = genotypes2haplotype.get(comp)
        if comp_haplotype is not None and comp not in generated:
            generated.add(haploid_genotype)
            yield {haplotype, comp_haplotype}


def extend_haplotypes(prefix_haplotypes_list, haplotypes):
    """(:759-792)."""
    if not prefix_haplotypes_list:
        raise ValueError("need at least one prefix haplotype set to extend")
    if len(haplotypes) not in {1, 2}:
        raise ValueError(
            f"expected 1 or 2 extension haplotypes, got {len(haplotypes)}"
        )
    for prefix_haplotypes in prefix_haplotypes_list:
        if len(prefix_haplotypes) == 1:
            (f,) = prefix_haplotypes
            yield {f + h for h in haplotypes}
        else:
            f1, f2 = sorted(prefix_haplotypes)
            if len(haplotypes) == 1:
                (h,) = haplotypes
                yield {f1 + h, f2 + h}
            else:
                h1, h2 = sorted(haplotypes)
                yield {f1 + h1, f2 + h2}
                yield {f1 + h2, f2 + h1}


def enumerate_all_possible_haplotypes(variants, ref, enumeration_type):
    """(:581-653): {frozenset(haplotypes): [genotype-assignments]}."""

    def create_haplotypes_recursive(variants_and_genotypes, last_pos):
        if not variants_and_genotypes:
            yield {ref.bases(last_pos, ref.end)} if last_pos != ref.end \
                else {""}
        else:
            group, remaining = split_independent_variants(
                variants_and_genotypes
            )
            group_haplotypes, next_pos = phased_genotypes_to_haplotypes(
                group, last_pos, ref
            )
            prefix_haplotypes = list(
                all_diploid_haplotypes(group, group_haplotypes)
            )
            if not prefix_haplotypes:
                raise ImpossibleHaplotype
            for haplotypes in create_haplotypes_recursive(
                remaining, next_pos
            ):
                yield from extend_haplotypes(prefix_haplotypes, haplotypes)

    def create_haplotypes(variants_and_genotypes, last_pos):
        try:
            yield from create_haplotypes_recursive(
                variants_and_genotypes, last_pos
            )
        except ImpossibleHaplotype:
            pass

    genotype_options = genotype_options_for_variants(
        variants, enumeration_type
    )
    result: "collections.OrderedDict[FrozenSet[str], List]" = \
        collections.OrderedDict()
    for genotypes in itertools.product(*genotype_options):
        paired = [VariantAndGenotypes(v, g)
                  for v, g in zip(variants, genotypes)]
        for haplotypes in create_haplotypes(paired, ref.start):
            key = frozenset(haplotypes)
            result.setdefault(key, []).append(genotypes)
    return result


def deduplicate_haplotypes(d):
    return {k: v[-1] for k, v in d.items()}


class HaplotypeMatch:
    """(:968-1107)."""

    def __init__(self, haplotypes, candidates, candidate_genotypes,
                 truths, truth_genotypes, truth_mod_penalties=None,
                 is_soft_label=False, candidate_probabilities=None):
        if len(haplotypes) not in {1, 2}:
            raise ValueError("Expected 1 or 2 haplotypes")
        self.haplotypes = sorted(haplotypes)
        self.candidates = candidates
        self.truths = truths
        self.candidate_genotypes = candidate_genotypes
        self.truth_genotypes = truth_genotypes
        # Soft-labeling extras (soft_labeler.py:988-1025): penalty per
        # truth for allele modifications, and per-candidate
        # (HomRef, Het, HomAlt) probability tuples.
        self.truth_mod_penalties = (
            truth_mod_penalties
            if truth_mod_penalties is not None
            else [0.0] * len(truths)
        )
        self.is_soft_label = is_soft_label
        self.candidate_probabilities = candidate_probabilities

    @property
    def original_truth_genotypes(self):
        return _variant_genotypes(self.truths)

    @property
    def n_false_positives(self):
        return sum(sum(gt) == 0 for gt in self.candidate_genotypes)

    @property
    def n_true_positives(self):
        return len(self.candidate_genotypes) - self.n_false_positives

    @property
    def n_false_negatives(self):
        return sum(
            n_zeroes(assigned) - n_zeroes(original)
            for original, assigned in zip(
                self.original_truth_genotypes, self.truth_genotypes
            )
        )

    @property
    def match_metrics(self):
        return (self.n_false_negatives, self.n_false_positives,
                self.n_true_positives)

    def candidates_with_assigned_genotypes(self) -> List[Variant]:
        out = [copy.deepcopy(v) for v in self.candidates]
        for variant, gt in zip(out, self.candidate_genotypes):
            if not variant.calls:
                variant.calls.append(VariantCall())
            variant.calls[0].genotype = list(gt)
        return out


def select_best_haplotype_match(all_matches):
    return sorted(all_matches, key=lambda x: x.match_metrics)[0]


def find_best_matching_haplotypes(candidates, truths, ref):
    """(:1148-1226)."""
    candidates = list(candidates)
    truths = list(truths)

    def enum_or_homref(variants, non_empty_enum):
        return non_empty_enum if variants else EnumerationType.ONLY_HOM_REF

    truth_haplotypes = deduplicate_haplotypes(
        enumerate_all_possible_haplotypes(
            truths, ref, enum_or_homref(candidates, EnumerationType.TRUTH)
        )
    )
    variant_haplotypes = enumerate_all_possible_haplotypes(
        candidates, ref,
        enum_or_homref(truths, EnumerationType.CANDIDATES),
    )
    found = []
    for vh, vgt_list in variant_haplotypes.items():
        tgt = truth_haplotypes.get(vh)
        if tgt is None:
            continue
        for vgt in vgt_list:
            found.append(HaplotypeMatch(
                haplotypes=vh,
                candidates=candidates,
                candidate_genotypes=vgt,
                truths=truths,
                truth_genotypes=tgt,
            ))
    if not found:
        return None
    return select_best_haplotype_match(found)


def group_variants(
    candidates,
    truths,
    max_group_size=MAX_GROUP_SIZE,
    max_separation=MAX_SEPARATION_WITHIN_VARIANT_GROUP,
    max_gt_options_product=MAX_GT_OPTIONS_PRODUCT,
    force_group_within_bp=FORCE_GROUP_WITHIN_BP,
):
    """(:365-539)."""

    def num_genotypes(variant):
        n = len(variant.alternate_bases) + 1
        return (n + 1) * n / 2

    def to_grouped(variants, vtype):
        return [_VariantToGroup(v.start, vtype, v) for v in variants]

    def of_type(group, required):
        return [g.variant for g in group if g.type == required]

    def include_in_group(group, group_variant, new_product):
        if not group:
            return True
        if new_product >= max_gt_options_product:
            return False
        n_of_type = sum(1 for g in group if g.type == group_variant.type)
        if n_of_type >= max_group_size:
            return False
        return any(
            group_variant.variant.start - g.variant.end + 1
            <= max_separation
            for g in group
        )

    def include_group_by_end(group, group_by_end, new_product):
        return all(
            include_in_group(group, v, new_product) for v in group_by_end
        )

    merged = list(heapq.merge(
        to_grouped(candidates, _CANDIDATE_MARKER),
        to_grouped(truths, _TRUTH_MARKER),
    ))
    if force_group_within_bp < 0:
        by_end = [[v] for v in merged]
    else:
        by_end = [
            list(g) for _, g in itertools.groupby(
                merged, key=lambda t: t.variant.end
            )
        ]

    groups = []
    current: List[_VariantToGroup] = []
    current_product = 1.0
    previous_pos_end = 0
    for group_by_end in by_end:
        new_product = current_product
        for gv in group_by_end:
            new_product *= num_genotypes(gv.variant)
        distance = group_by_end[0].variant.end - previous_pos_end
        if include_group_by_end(current, group_by_end, new_product) or \
                distance <= force_group_within_bp:
            current.extend(group_by_end)
            current_product = new_product
        else:
            groups.append(current)
            current = list(group_by_end)
            current_product = 1.0
            for gv in group_by_end:
                current_product *= num_genotypes(gv.variant)
        previous_pos_end = group_by_end[0].variant.end
    if current:
        groups.append(current)
    return [
        (of_type(g, _CANDIDATE_MARKER), of_type(g, _TRUTH_MARKER))
        for g in groups
    ]


@dataclasses.dataclass
class LabelingMetrics:
    """Counts implied by labeling candidates against truth
    (deepvariant.proto:1097-1226 LabelingMetrics; counts only, so
    shards can be summed). Sites count records; alleles count distinct
    non-ref alt alleles."""

    n_truth_variant_sites: int = 0
    n_truth_variant_alleles: int = 0
    n_candidate_variant_sites: int = 0
    n_candidate_variant_alleles: int = 0
    n_non_confident_candidate_variant_sites: int = 0
    n_true_positive_sites: int = 0
    n_true_positive_alleles: int = 0
    n_false_negative_sites: int = 0
    n_false_negative_alleles: int = 0
    n_false_positive_sites: int = 0
    n_false_positive_alleles: int = 0
    n_inexact_position_matches: int = 0
    n_exact_position_matches: int = 0
    n_exact_position_and_allele_matches: int = 0
    n_exact_position_and_allele_and_genotype_matches: int = 0
    n_truth_multiallelics_sites_with_missed_alleles: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class HaplotypeLabeler:
    """(:101): default DeepVariant training labeler."""

    def __init__(
        self,
        truth_vcf_reader,
        ref_reader,
        confident_regions: RangeSet,
        max_group_size: int = MAX_GROUP_SIZE,
        max_separation: int = MAX_SEPARATION_WITHIN_VARIANT_GROUP,
        max_gt_options_product: int = MAX_GT_OPTIONS_PRODUCT,
    ):
        if confident_regions is None:
            raise ValueError(
                "confident_regions cannot be None for HaplotypeLabeler."
            )
        self._truth = truth_vcf_reader
        self._ref_reader = ref_reader
        self._confident_regions = confident_regions
        self._metrics = LabelingMetrics()
        self.max_group_size = max_group_size
        self.max_separation = max_separation
        self.max_gt_options_product = max_gt_options_product

    def _get_truth_variants(self, region: Range):
        for tv in self._truth.query(region):
            if self._confident_regions.variant_overlaps(tv):
                yield tv

    def make_labeler_ref(self, candidates, true_variants, bufsize=20):
        all_variants = candidates + true_variants
        contig = all_variants[0].reference_name
        start = min(x.start for x in all_variants)
        end = max(x.end for x in all_variants)
        contig_nbp = self._ref_reader.contig_length(contig)
        region = Range(
            contig, max(start - 1, 0), min(end + bufsize, contig_nbp)
        )
        return ReferenceRegion(
            self._ref_reader.query(region), start=region.start
        )

    @property
    def metrics(self) -> LabelingMetrics:
        """LabelingMetrics accumulated so far (haplotype_labeler.py:199)."""
        return self._metrics

    def _update_metrics(self, labeling) -> None:
        """Accumulate counts from one HaplotypeMatch
        (haplotype_labeler.py:204-308)."""
        m = self._metrics

        def n_alts(gt):
            return len({g for g in gt if g > 0})

        def is_hom_ref(gt):
            return all(g == 0 for g in gt)

        def has_alt(gt):
            return any(g > 0 for g in gt)

        for truth, original_gt, assigned_gt in zip(
            labeling.truths,
            labeling.original_truth_genotypes,
            labeling.truth_genotypes,
        ):
            n_alts_original = n_alts(original_gt)
            m.n_truth_variant_sites += 1
            m.n_truth_variant_alleles += n_alts_original
            m.n_true_positive_sites += has_alt(assigned_gt)
            m.n_false_negative_sites += is_hom_ref(assigned_gt)
            if n_alts_original > 1 and \
                    n_alts(assigned_gt) < n_alts_original:
                m.n_truth_multiallelics_sites_with_missed_alleles += 1
            for og, ag in zip(original_gt, assigned_gt):
                if og > 0:
                    if ag > 0:
                        m.n_true_positive_alleles += 1
                    else:
                        m.n_false_negative_alleles += 1

        truth_by_pos = {
            truth.start: (truth, gt)
            for truth, gt in zip(
                labeling.truths, labeling.truth_genotypes
            )
        }
        for candidate, genotype in zip(
            labeling.candidates, labeling.candidate_genotypes
        ):
            if not self._confident_regions.variant_overlaps(candidate):
                m.n_non_confident_candidate_variant_sites += 1
                continue
            n_alt_alleles = len(candidate.alternate_bases)
            m.n_candidate_variant_sites += 1
            m.n_candidate_variant_alleles += n_alt_alleles
            m.n_false_positive_sites += is_hom_ref(genotype)
            m.n_false_positive_alleles += (
                n_alt_alleles - n_alts(genotype)
            )
            truth, assigned_gt = truth_by_pos.get(
                candidate.start, (None, None)
            )
            if truth:
                m.n_exact_position_matches += 1
                if sorted(candidate.alternate_bases) == sorted(
                    truth.alternate_bases
                ):
                    m.n_exact_position_and_allele_matches += 1
                    if sorted(genotype) == sorted(assigned_gt):
                        m.n_exact_position_and_allele_and_genotype_matches += 1
            elif has_alt(genotype):
                m.n_inexact_position_matches += 1

    def label_variants(
        self, variants: Sequence[Variant], region: Range
    ) -> Iterator[VariantLabel]:
        truths = list(self._get_truth_variants(region))
        if truths:
            truths = [
                t for t in truths
                if sum(_variant_genotypes([t])[0]) > 0
            ]
        grouped = group_variants(
            candidates=list(variants),
            truths=truths,
            max_group_size=self.max_group_size,
            max_separation=self.max_separation,
            max_gt_options_product=self.max_gt_options_product,
        )
        for candidates_group, truth_group in grouped:
            if not candidates_group and not truth_group:
                continue
            if not candidates_group:
                continue
            ref = self.make_labeler_ref(candidates_group, truth_group)
            labeling = find_best_matching_haplotypes(
                candidates_group, truth_group, ref
            )
            if labeling is None:
                raise ValueError(
                    "Failed to assign labels for variants",
                    candidates_group, truth_group,
                )
            self._update_metrics(labeling)
            for labeled in labeling.candidates_with_assigned_genotypes():
                yield VariantLabel(
                    is_confident=self._confident_regions.variant_overlaps(
                        labeled
                    ),
                    variant=labeled,
                    genotype=tuple(labeled.calls[0].genotype),
                )

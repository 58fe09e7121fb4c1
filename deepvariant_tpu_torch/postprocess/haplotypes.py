"""Resolve incompatible overlapping genotype calls into valid haplotypes.

The port's copy of `deepvariant_tpu.postprocess.haplotypes`.

Behavior mirrors the reference's haplotypes.py (:69-539): overlapping
variants whose called genotypes imply more than `ploidy` alternate
haplotypes at any reference position are re-genotyped by maximizing the
joint likelihood over all *compatible* genotype configurations; if the
joint argmax agrees with the per-variant marginal argmax, the resolved
genotypes and rescaled GLs are emitted, otherwise the originals pass
through unchanged.
"""

from __future__ import annotations

import copy
import itertools
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core import genomics_math
from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.postprocess import genotype as gt

# 3^12 = 531,441 configurations max (haplotypes.py:64).
_MAX_OVERLAPPING_VARIANTS_TO_RESOLVE = 12


def _only_call(variant: Variant):
    return gt.only_call(variant)


def _nonref_genotype_count(variant: Variant) -> int:
    return sum(g > 0 for g in _only_call(variant).genotype)


def allele_indices_with_num_alts(
    variant: Variant, num_alts: int, ploidy: int = 2
) -> List[Tuple[int, int]]:
    """All diploid genotypes of `variant` with `num_alts` non-ref alleles."""
    if ploidy != 2:
        raise NotImplementedError("Only diploid supported.")
    max_allele = len(variant.alternate_bases)
    if num_alts == 0:
        return [(0, 0)]
    if num_alts == 1:
        return [(0, i) for i in range(1, max_allele + 1)]
    if num_alts == 2:
        return [
            (i, j)
            for i in range(1, max_allele + 1)
            for j in range(i, max_allele + 1)
        ]
    raise ValueError(f"Invalid num_alts: {num_alts}")


def _genotype_likelihood(call, allele_indices: Tuple[int, int]) -> float:
    return call.genotype_likelihood[gt.genotype_index(*allele_indices)]


def group_overlapping_variants(
    sorted_variants: Iterable[Variant],
) -> Iterator[List[Variant]]:
    curr: List[Variant] = []
    prev_chrom = None
    prev_max_end = -1
    for variant in sorted_variants:
        if variant.reference_name != prev_chrom or \
                variant.start >= prev_max_end:
            if curr:
                yield curr
            curr = [variant]
            prev_chrom = variant.reference_name
            prev_max_end = variant.end
        else:
            curr.append(variant)
            prev_max_end = max(prev_max_end, variant.end)
    if curr:
        yield curr


class VariantCompatibilityCalculator:
    """Checks that per-base non-ref allele counts never exceed ploidy."""

    def __init__(self, overlapping_variants: Sequence[Variant]):
        min_start = min(v.start for v in overlapping_variants)
        self.variant_indices = [
            (v.start - min_start, v.end - min_start)
            for v in overlapping_variants
        ]
        self.size = max(v.end - min_start for v in overlapping_variants)

    def all_variants_compatible(
        self, nonref_genotype_counts: Sequence[int], ploidy: int = 2
    ) -> bool:
        if len(nonref_genotype_counts) != len(self.variant_indices):
            raise ValueError(
                "Variant counts must have same length as variant indices."
            )
        if not all(0 <= c <= ploidy for c in nonref_genotype_counts):
            raise ValueError(
                f"Invalid count for ploidy {ploidy}: "
                f"{nonref_genotype_counts}"
            )
        alts_in_span = np.zeros(self.size, dtype=int)
        for cnt, (start, end) in zip(
            nonref_genotype_counts, self.variant_indices
        ):
            alts_in_span[start:end] += cnt
        return bool(np.all(alts_in_span <= ploidy))


class LikelihoodAggregator:
    """Marginal GL accumulation over configurations (log10, log-sum-exp)."""

    def __init__(self, num_alts: int):
        self._num_likelihoods = gt.genotype_index(num_alts, num_alts) + 1
        self._containers: List[List[float]] = [
            [] for _ in range(self._num_likelihoods)
        ]

    def add(self, allele_indices: Tuple[int, int], likelihood: float):
        self._containers[gt.genotype_index(*allele_indices)].append(
            likelihood
        )

    def scaled_likelihoods(self) -> np.ndarray:
        if not all(bool(x) for x in self._containers):
            raise ValueError(
                f"All genotypes must have some probability mass: "
                f"{self._containers}"
            )
        return genomics_math.normalize_log10_probs(
            [genomics_math.log10sumexp(c) for c in self._containers]
        )

    def most_likely_allele_indices(self) -> Tuple[int, int]:
        ix = int(np.argmax(self.scaled_likelihoods()))
        # Invert diploid GL index -> (a, b).
        index = 0
        for h1 in range(self._num_likelihoods):
            for h2 in range(h1 + 1):
                if index == ix:
                    return (h2, h1)
                index += 1
        raise ValueError(f"bad GL index {ix}")


def _get_all_allele_indices_configurations(
    variants: Sequence[Variant], nonref_count_configuration: Sequence[int]
):
    if len(variants) != len(nonref_count_configuration):
        raise ValueError("lengths must match")
    configs = [
        allele_indices_with_num_alts(v, num_alts, ploidy=2)
        for v, num_alts in zip(variants, nonref_count_configuration)
    ]
    return itertools.product(*configs)


def _allele_indices_configuration_likelihood(
    variants: Sequence[Variant], allele_indices_config
) -> float:
    total = 0.0
    for variant, alleles in zip(variants, allele_indices_config):
        total += _genotype_likelihood(_only_call(variant), alleles)
    return total


def _resolve_overlapping_variants(
    overlapping_variants: List[Variant], qual_filter: float
) -> Iterator[Variant]:
    if len(overlapping_variants) == 1:
        yield overlapping_variants[0]
        return
    calculator = VariantCompatibilityCalculator(overlapping_variants)
    nonref_counts = [_nonref_genotype_count(v)
                     for v in overlapping_variants]
    if calculator.all_variants_compatible(nonref_counts):
        yield from overlapping_variants
        return
    if len(overlapping_variants) > _MAX_OVERLAPPING_VARIANTS_TO_RESOLVE:
        yield from overlapping_variants
        return

    valid_nonref_count_configurations = [
        conf
        for conf in itertools.product(
            [0, 1, 2], repeat=len(overlapping_variants)
        )
        if calculator.all_variants_compatible(conf)
    ]
    likelihood_aggregators = [
        LikelihoodAggregator(len(v.alternate_bases))
        for v in overlapping_variants
    ]
    most_likely_config = None
    most_likely_likelihood = None
    for nonref_count_config in valid_nonref_count_configurations:
        for allele_indices_config in _get_all_allele_indices_configurations(
            overlapping_variants, nonref_count_config
        ):
            config_likelihood = _allele_indices_configuration_likelihood(
                overlapping_variants, allele_indices_config
            )
            if (most_likely_likelihood is None
                    or config_likelihood > most_likely_likelihood):
                most_likely_likelihood = config_likelihood
                most_likely_config = allele_indices_config
            for agg, allele_indices in zip(
                likelihood_aggregators, allele_indices_config
            ):
                agg.add(allele_indices, config_likelihood)

    marginal_config = tuple(
        agg.most_likely_allele_indices() for agg in likelihood_aggregators
    )
    if marginal_config == most_likely_config:
        scaled_gls = [agg.scaled_likelihoods()
                      for agg in likelihood_aggregators]
        for variant, allele_indices, gls in zip(
            overlapping_variants, most_likely_config, scaled_gls
        ):
            newvariant = copy.deepcopy(variant)
            call = _only_call(newvariant)
            call.genotype = list(allele_indices)
            call.genotype_likelihood = [float(g) for g in gls]
            newvariant.filter = gt.compute_filter_fields(
                newvariant, qual_filter
            )
            yield newvariant
    else:
        yield from overlapping_variants


def _maybe_resolve_mixed_calls(
    overlapping_candidates: List[Variant], qual_filter: float
) -> Iterator[Variant]:
    if len(overlapping_candidates) == 1:
        yield overlapping_candidates[0]
        return
    reference_calls = [
        c for c in overlapping_candidates if _nonref_genotype_count(c) == 0
    ]
    variant_calls = [
        v for v in overlapping_candidates if _nonref_genotype_count(v) > 0
    ]
    resolved: List[Variant] = []
    for variant_group in group_overlapping_variants(variant_calls):
        resolved.extend(
            _resolve_overlapping_variants(variant_group, qual_filter)
        )
    for variant in sorted(
        reference_calls + resolved,
        key=lambda v: (v.reference_name, v.start, v.end),
    ):
        yield variant


def maybe_resolve_conflicting_variants(
    sorted_variants: Iterable[Variant],
    qual_filter: float = 1.0,
    disable: bool = False,
) -> Iterator[Variant]:
    """Main entry (haplotypes.py:69): fix conflicting haplotypes in order."""
    if disable:
        yield from sorted_variants
        return
    for overlapping in group_overlapping_variants(sorted_variants):
        yield from _maybe_resolve_mixed_calls(overlapping, qual_filter)

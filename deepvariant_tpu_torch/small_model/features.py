"""Small-model feature extraction.

The port's copy of `deepvariant_tpu.small_model.features`, host code
with the same integer semantics (floor-divided means, 100x
percentages), so its feature rows equal the JAX package's byte for byte
as float32.

Behavior parity with reference small_model/make_small_model_examples.py:
the per-candidate scalar feature vector (BaseFeature :83-98 computed
over ref/alt supporting reads, VariantFeature :100-109, context allele
frequencies, and optional per-haplotype feature copies).

Read attributes come from the ReadBatch (the reference embeds them in
DeepVariantCall.ReadSupport protos; here supports are read indices into
the region's batch).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.io.bam import ReadBatch
from deepvariant_tpu_torch.make_examples.variant_caller import DeepVariantCall

GENOTYPE_CLASSES = 3  # ref / het / hom-alt

BASE_FEATURES = [
    "num_reads_supports_ref",
    "num_reads_supports_alt",
    "alt_indices_depth",
    "total_depth",
    "variant_allele_frequency",
    "alt_indices_variant_allele_frequency",
    "ref_mapping_quality",
    "alt_mapping_quality",
    "ref_base_quality",
    "alt_base_quality",
    "ref_reverse_strand_ratio",
    "alt_reverse_strand_ratio",
]

VARIANT_FEATURES = [
    "is_snp",
    "is_insertion",
    "is_deletion",
    "insertion_length",
    "deletion_length",
    "is_multiallelic",
    "is_multiple_alt_alleles",
]


def _mean(values: Sequence[float], multiplier: int = 1) -> int:
    if not len(values):
        return 0
    return int(multiplier * int(np.sum(values))) // len(values)


@dataclasses.dataclass
class ReadInfo:
    mapping_quality: int
    average_base_quality: int
    is_reverse_strand: bool


def read_infos_from_batch(
    batch: ReadBatch, read_ids: Sequence[int]
) -> List[ReadInfo]:
    out = []
    for rid in read_ids:
        quals = batch.qual_of(rid)
        out.append(ReadInfo(
            mapping_quality=int(batch.mapq[rid]),
            average_base_quality=int(np.mean(quals)) if len(quals) else 0,
            is_reverse_strand=bool(batch.is_reverse()[rid]),
        ))
    return out


class FeatureEncoder:
    """Feature vector for one (candidate, alt_allele_indices) pair."""

    def __init__(
        self,
        candidate: DeepVariantCall,
        alt_allele_indices: Tuple[int, ...],
        batch: ReadBatch,
        haplotype: Optional[int] = None,
        read_phases: Optional[Sequence[int]] = None,
    ):
        self.candidate = candidate
        self.alt_allele_indices = alt_allele_indices
        variant = candidate.variant
        ref_ids = list(candidate.ref_support)
        alt_ids = self._alt_read_ids(alt_allele_indices)
        if haplotype is not None and read_phases is not None:
            ref_ids = [r for r in ref_ids
                       if read_phases[r] == haplotype]
            alt_ids = [r for r in alt_ids
                       if read_phases[r] == haplotype]
        self.ref_read_infos = read_infos_from_batch(batch, ref_ids)
        self.alt_read_infos = read_infos_from_batch(batch, alt_ids)

    def _alt_read_ids(self, indices: Tuple[int, ...]) -> List[int]:
        ids: List[int] = []
        for i in indices:
            alt = self.candidate.variant.alternate_bases[i]
            ids.extend(self.candidate.allele_support.get(alt, []))
        return ids

    # -- base features ------------------------------------------------------

    def total_depth(self) -> int:
        return len(self.candidate.ref_support) + sum(
            len(r) for a, r in self.candidate.allele_support.items()
        )

    def base_feature_values(self) -> List[int]:
        n_ref = len(self.ref_read_infos)
        n_alt = len(self.alt_read_infos)
        alt_indices_depth = n_ref + n_alt
        total = self.total_depth()
        mq = lambda infos: _mean([r.mapping_quality for r in infos])
        bq = lambda infos: _mean([r.average_base_quality for r in infos])
        rs = lambda infos: _mean(
            [int(r.is_reverse_strand) for r in infos], 100
        )
        return [
            n_ref,
            n_alt,
            alt_indices_depth,
            total,
            100 * n_alt // total if total else 0,
            100 * n_alt // alt_indices_depth if alt_indices_depth else 0,
            mq(self.ref_read_infos),
            mq(self.alt_read_infos),
            bq(self.ref_read_infos),
            bq(self.alt_read_infos),
            rs(self.ref_read_infos),
            rs(self.alt_read_infos),
        ]

    # -- variant features ---------------------------------------------------

    def variant_feature_values(self) -> List[int]:
        v = self.candidate.variant
        ref_len = len(v.reference_bases)
        alts = [v.alternate_bases[i] for i in self.alt_allele_indices]
        alt_len = max((len(a) for a in alts), default=0)
        is_snp = int(ref_len == 1 and all(len(a) == 1 for a in alts)
                     and bool(alts))
        is_insertion = int(any(len(a) > ref_len for a in alts))
        is_deletion = int(any(len(a) < ref_len for a in alts))
        return [
            is_snp,
            is_insertion,
            is_deletion,
            max(0, alt_len - ref_len),
            max(0, ref_len - alt_len),
            int(len(v.alternate_bases) > 1),
            int(len(self.alt_allele_indices) > 1),
        ]


class SmallModelExampleFactory:
    """Assembles model feature rows (make_small_model_examples.py:572)."""

    def __init__(
        self,
        vaf_context_window_size: int = 0,
        expand_by_haplotype: bool = False,
    ):
        self.vaf_context_window_size = vaf_context_window_size
        self.expand_by_haplotype = expand_by_haplotype

    def model_feature_names(self) -> List[str]:
        names = list(BASE_FEATURES) + list(VARIANT_FEATURES)
        if self.vaf_context_window_size:
            half = self.vaf_context_window_size // 2
            names += [
                f"variant_allele_frequency_at_{'minus' if o < 0 else 'plus'}"
                f"_{abs(o)}" if o else "variant_allele_frequency_at_0"
                for o in range(-half, half + 1)
            ]
        if self.expand_by_haplotype:
            for hp in range(3):
                names += [f"{n}_hp_{hp}" for n in BASE_FEATURES]
        return names

    def encode(
        self,
        candidate: DeepVariantCall,
        alt_allele_indices: Tuple[int, ...],
        batch: ReadBatch,
        context_vafs: Optional[Sequence[int]] = None,
        read_phases: Optional[Sequence[int]] = None,
    ) -> np.ndarray:
        encoder = FeatureEncoder(candidate, alt_allele_indices, batch)
        features = (encoder.base_feature_values()
                    + encoder.variant_feature_values())
        if self.vaf_context_window_size:
            ctx = list(context_vafs or [])
            # Offsets are range(-w//2, w//2 + 1): 2*(w//2)+1 entries
            # (reference _get_context_allele_frequency_offsets,
            # make_small_model_examples.py:159-166) — w+1 only for
            # even w; the production window (51) is odd.
            want = 2 * (self.vaf_context_window_size // 2) + 1
            ctx = (ctx + [0] * want)[:want]
            features += ctx
        if self.expand_by_haplotype:
            if read_phases is None:
                # The JAX package indexes an empty list here and raises
                # IndexError (ROADMAP.md Queue 3, training rows with
                # --phase_reads).
                raise ValueError(
                    "expand_by_haplotype needs the reads' phases")
            for hp in range(3):
                hp_encoder = FeatureEncoder(
                    candidate, alt_allele_indices, batch,
                    haplotype=hp, read_phases=read_phases,
                )
                features += hp_encoder.base_feature_values()
        return np.asarray(features, np.float32)

    def alt_index_sets(
        self, candidate: DeepVariantCall
    ) -> List[Tuple[int, ...]]:
        """All biallelic + pairwise multiallelic index sets
        (get_set_of_allele_indices)."""
        n = len(candidate.variant.alternate_bases)
        return [(i,) for i in range(n)] + list(
            itertools.combinations(range(n), 2)
        )

"""Methylation-aware read phasing (5mC Wilcoxon extension).

The port's copy of `deepvariant_tpu.phasing.methylation_aware_phasing`:
Python on the host, as there, with the same dict and sort orders. It
re-implements the reference's methylation_aware_phasing.cc: after
SNP-based DirectPhasing, reads that remained unphased are assigned to
haplotypes using allele-specific methylation. Per methylated reference
site, the two haplotypes' 5mC levels are compared with a Wilcoxon
rank-sum test (normal approximation, methylation_aware_phasing.cc:29-87);
sites that separate the haplotypes (p < 0.05 after coverage / mean-diff
/ stddev filters, :157-230) become "informative". Each unphased read
then votes per informative site for the haplotype whose mean methylation
is closer to its own level; >= 3 votes and a majority assign the phase
(:89-147). The loop repeats until no new reads phase (max_iter,
:252-330).

Site representation: instead of materializing '.'-alt pseudo-candidates
(the reference's methylated-reference-site DeepVariantCalls fed through
ref_support_ext), sites are extracted directly from the columnar
ReadBatch: a MethylatedRefSite holds {read index -> methylation level
in [0, 1]} for the reads covering a CpG. This carries the same
information without the proto detour. CpG handling: forward reads carry
the 5mC probability on the C; reverse reads carry it on the aligned G
(the complement strand's C), i.e. one base to the right of the CpG's C
(TransferMethylationToPrevC semantics, variant_calling_multisample.cc
:1434-1470 — there G-site marks transfer to the preceding C site).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

P_THRESHOLD = 0.05  # methylation_aware_phasing.cc:26 kPThreshold
_RANK_SUM_VARIANCE_DENOM = 12.0
# Informative-site filter block (methylation_aware_phasing.cc:185-216).
MIN_READS_PER_HAP = 2
MIN_TOTAL_READS = 6
MIN_MEAN_DIFF = 0.25
MAX_WITHIN_HAP_STDDEV = 0.2
MIN_VOTES = 3  # HaplotypeVoteWithMethylation:145-146
DEFAULT_MAX_ITER = 3
# A base is "methylated" when its MM/ML probability exceeds this
# (reference methylation_calling_threshold default 0.5).
DEFAULT_METHYLATION_THRESHOLD = 0.5


@dataclasses.dataclass
class MethylatedRefSite:
    """One methylated reference site: per-read 5mC levels in [0, 1]."""

    position: int
    levels: Dict[int, float]  # read index -> methylation level
    p_value: float = -1.0


def wilcoxon_rank_sum_test(
    hap1_methyl: Sequence[float], hap2_methyl: Sequence[float]
) -> float:
    """Two-sided Mann-Whitney U p-value via normal approximation
    (methylation_aware_phasing.cc:29-87). Returns -1 on empty input."""
    n1, n2 = len(hap1_methyl), len(hap2_methyl)
    if n1 == 0 or n2 == 0:
        return -1.0
    values = np.concatenate([
        np.asarray(hap1_methyl, np.float64),
        np.asarray(hap2_methyl, np.float64),
    ])
    groups = np.concatenate([np.zeros(n1, np.int8), np.ones(n2, np.int8)])
    order = np.argsort(values, kind="stable")
    values = values[order]
    groups = groups[order]
    # Average ranks over ties (1-based).
    ranks = np.empty(n1 + n2, np.float64)
    i = 0
    n = n1 + n2
    while i < n:
        j = i
        while j + 1 < n and values[j + 1] == values[i]:
            j += 1
        ranks[i : j + 1] = (i + j + 2) / 2.0
        i = j + 1
    rank_sum_1 = float(ranks[groups == 0].sum())
    u1 = rank_sum_1 - n1 * (n1 + 1) / 2.0
    u2 = n1 * n2 - u1
    u = min(u1, u2)
    mean_u = n1 * n2 / 2.0
    std_u = math.sqrt(n1 * n2 * (n1 + n2 + 1) / _RANK_SUM_VARIANCE_DENOM)
    z = (u - mean_u) / std_u
    # 2 * (1 - Phi(|z|)) == erfc(|z| / sqrt(2))
    return math.erfc(abs(z) / math.sqrt(2.0))


def identify_informative_sites(
    hap1_reads: frozenset,
    hap2_reads: frozenset,
    sites: Sequence[MethylatedRefSite],
) -> List[MethylatedRefSite]:
    """Filter + test block (methylation_aware_phasing.cc:157-230).
    Mutates each site's p_value when the test runs."""
    informative = []
    for site in sites:
        hap1 = [m for r, m in site.levels.items() if r in hap1_reads]
        hap2 = [m for r, m in site.levels.items() if r in hap2_reads]
        if len(hap1) < MIN_READS_PER_HAP or len(hap2) < MIN_READS_PER_HAP:
            continue
        if len(hap1) + len(hap2) < MIN_TOTAL_READS:
            continue
        mean1 = sum(hap1) / len(hap1)
        mean2 = sum(hap2) / len(hap2)
        if abs(mean1 - mean2) < MIN_MEAN_DIFF:
            continue
        std1 = math.sqrt(sum((v - mean1) ** 2 for v in hap1) / len(hap1))
        std2 = math.sqrt(sum((v - mean2) ** 2 for v in hap2) / len(hap2))
        if std1 > MAX_WITHIN_HAP_STDDEV or std2 > MAX_WITHIN_HAP_STDDEV:
            continue
        p = wilcoxon_rank_sum_test(hap1, hap2)
        site.p_value = p
        if 0 <= p < P_THRESHOLD:
            informative.append(site)
    return informative


def haplotype_vote(
    read_idx: int,
    informative_sites: Sequence[MethylatedRefSite],
    hap1_reads: frozenset,
    hap2_reads: frozenset,
) -> int:
    """Vote an unphased read onto the haplotype whose per-site mean
    methylation is closer (methylation_aware_phasing.cc:89-147).
    Returns 1 / 2, or 0 when below MIN_VOTES or tied."""
    hap1_votes = hap2_votes = 0
    for site in informative_sites:
        read_methyl = site.levels.get(read_idx)
        if read_methyl is None:
            continue
        hap1 = [m for r, m in site.levels.items() if r in hap1_reads]
        hap2 = [m for r, m in site.levels.items() if r in hap2_reads]
        if not hap1 or not hap2:
            continue
        mean1 = sum(hap1) / len(hap1)
        mean2 = sum(hap2) / len(hap2)
        if abs(read_methyl - mean1) < abs(read_methyl - mean2):
            hap1_votes += 1
        else:
            hap2_votes += 1
    if hap1_votes >= MIN_VOTES and hap1_votes > hap2_votes:
        return 1
    if hap2_votes >= MIN_VOTES and hap2_votes > hap1_votes:
        return 2
    return 0


def perform_methylation_aware_phasing(
    num_reads: int,
    initial_phases: Sequence[int],
    sites: Sequence[MethylatedRefSite],
    max_iter: int = DEFAULT_MAX_ITER,
) -> Tuple[List[int], List[float]]:
    """Iterative phase completion (methylation_aware_phasing.cc:252-330).

    Returns (phases, p_values) with p_values aligned to `sites`
    (-1 where the test never ran)."""
    phases = list(initial_phases)
    for _ in range(max_iter):
        hap1_reads = frozenset(
            i for i, p in enumerate(phases) if p == 1
        )
        hap2_reads = frozenset(
            i for i, p in enumerate(phases) if p == 2
        )
        unphased = [i for i in range(num_reads) if phases[i] == 0]
        if not unphased:
            break
        informative = identify_informative_sites(
            hap1_reads, hap2_reads, sites
        )
        newly_phased = 0
        for i in unphased:
            vote = haplotype_vote(i, informative, hap1_reads, hap2_reads)
            if vote:
                phases[i] = vote
                newly_phased += 1
        if newly_phased == 0:
            break
    return phases, [s.p_value for s in sites]


def extract_methylated_ref_sites(
    batch,
    region_start: int,
    region_end: int,
    threshold: float = DEFAULT_METHYLATION_THRESHOLD,
    min_methylated_reads: int = 1,
) -> List[MethylatedRefSite]:
    """Methylated reference sites from a ReadBatch's MM/ML decodes.

    For each read with 5mC data, walk its aligned M/=/X bases and
    deposit the per-base probability (0-255 -> [0, 1]) at the CpG's C
    position: forward reads at the aligned position itself, reverse
    reads shifted one left (their probability sits on the aligned G;
    TransferMethylationToPrevC, variant_calling_multisample.cc:1434).
    A position becomes a site when >= min_methylated_reads reads carry
    a probability >= threshold there."""
    if not getattr(batch, "meth", None):
        return []
    from deepvariant_tpu_torch.io.bam import FLAG_REVERSE

    _OP_M, _OP_I, _OP_D, _OP_N, _OP_S = 1, 2, 3, 4, 5
    _OP_EQ, _OP_X = 8, 9
    levels_by_pos: Dict[int, Dict[int, float]] = {}
    for ri in range(len(batch)):
        meth = batch.meth[ri]
        if meth is None:
            continue
        shift = -1 if (batch.flag[ri] & FLAG_REVERSE) else 0
        co = batch.cigar_offsets
        ops = batch.cigar_ops[co[ri] : co[ri + 1]]
        lens = batch.cigar_lens[co[ri] : co[ri + 1]]
        ref_i = int(batch.pos[ri])
        read_i = 0
        for op, op_len in zip(ops, lens):
            op_len = int(op_len)
            if op in (_OP_M, _OP_EQ, _OP_X):
                block = meth[read_i : read_i + op_len]
                for k in np.nonzero(block)[0]:
                    pos = ref_i + int(k) + shift
                    if region_start <= pos < region_end:
                        levels_by_pos.setdefault(pos, {})[ri] = (
                            float(block[k]) / 255.0
                        )
                ref_i += op_len
                read_i += op_len
            elif op in (_OP_I, _OP_S):
                read_i += op_len
            elif op in (_OP_D, _OP_N):
                ref_i += op_len
    sites = []
    for pos in sorted(levels_by_pos):
        levels = levels_by_pos[pos]
        n_methylated = sum(1 for m in levels.values() if m >= threshold)
        if n_methylated >= min_methylated_reads:
            sites.append(MethylatedRefSite(pos, levels))
    return sites

"""Direct read phasing from SNP candidates.

The port's copy of `deepvariant_tpu.phasing.direct_phasing`: Python on
the host, as there, with the same dict, set and sort orders, so the same
phases and phased variants from the same candidates.

Behavior parity with reference direct_phasing.{h,cc}:
  * Build an allele graph: one vertex per allele (REF vertex requires
    >= 3 supporting reads, kMinRefAlleleDepth direct_phasing.cc:68) of
    every *phasable* candidate — heterozygous SNPs not overlapped by
    indels (CandidateFilter, :789-817); edges connect consecutive
    positions via shared supporting reads with weights 0.5/0.25 by read
    quality (:641-648).
  * Dynamic program over positions: a partition score for every ordered
    pair of same-position alleles; transition adds the count of reads
    continuing on both phase paths plus half-credit for reads starting
    here (CalculateScore, :499-560); positions where the score cannot
    advance (or all scores tie within 1) restart a phase block
    (:168-178).
  * Backtrack assigns phases 1/2 to the argmax partition per block
    (AssignPhasesToVertices, :304-398; deterministic tie-break on
    allele bases, CompareVertexPairByBases :227-244).
  * Reads get the majority phase of their overlapped alleles
    (AssignPhasesToReads, :429-463).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

from deepvariant_tpu_torch.make_examples.variant_caller import (
    DeepVariantCall,
    SUPPORTING_UNCALLED_ALLELE,
)

MIN_REF_ALLELE_DEPTH = 3  # direct_phasing.cc:68
REF_BASES = "REF"
NUM_PHASES = 2

# Allele classification (direct_phasing.cc:904-955 free helpers).
SUBSTITUTION = 1
INSERTION = 2
DELETION = 3


def allele_type_from_candidate(bases: str,
                               candidate: DeepVariantCall) -> int:
    """AlleleTypeFromCandidate (direct_phasing.cc:904-916): classify by
    allele length vs the candidate's reference span."""
    span = candidate.variant.end - candidate.variant.start
    if len(bases) > span:
        return INSERTION
    if len(bases) < span:
        return DELETION
    return SUBSTITUTION


def num_of_substitution_alleles(candidate: DeepVariantCall) -> int:
    """NumOfSubstitutionAlleles (direct_phasing.cc:918-928)."""
    return sum(
        1 for bases in candidate.allele_support
        if bases != SUPPORTING_UNCALLED_ALLELE
        and allele_type_from_candidate(bases, candidate) == SUBSTITUTION
    )


def num_of_indel_alleles(candidate: DeepVariantCall) -> int:
    """NumOfIndelAlleles (direct_phasing.cc:930-942)."""
    return sum(
        1 for bases in candidate.allele_support
        if bases != SUPPORTING_UNCALLED_ALLELE
        and allele_type_from_candidate(bases, candidate)
        in (INSERTION, DELETION)
    )


def substitution_alleles_depth(candidate: DeepVariantCall) -> int:
    """SubstitutionAllelesDepth (direct_phasing.cc:944-955); counts
    every supporting read, including low-quality ones."""
    return sum(
        len(reads) for bases, reads in candidate.allele_support.items()
        if bases != SUPPORTING_UNCALLED_ALLELE
        and allele_type_from_candidate(bases, candidate) == SUBSTITUTION
    )


@dataclasses.dataclass
class DirectPhasingOptions:
    min_alleles_to_phase: int = 1  # make_examples_options.py:676-683
    phase_max_candidates: int = 100


@dataclasses.dataclass
class AlleleVertex:
    position: int
    bases: str
    read_support: List[int]  # read indices (high-quality only)
    phase: int = 0
    is_first_in_block: bool = False
    # per-read flag: is this the first allele this read supports
    first_allele_reads: Set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class PhasedVariant:
    position: int
    phase_1_bases: str
    phase_2_bases: str
    # True when this variant starts a new phasing block
    # (direct_phasing.h:86,94 allele_info.is_first_in_block).
    is_first_in_block: bool = False


@dataclasses.dataclass
class _Score:
    score: int
    from_pair: Optional[Tuple[int, int]]  # vertex ids
    read_support: Tuple[Set[int], Set[int]]


def _candidate_filter(candidate: DeepVariantCall,
                      indel_end: List[int]) -> bool:
    """Keep only heterozygous SNP candidates clear of indels."""
    called = [a for a in candidate.allele_support
              if a != SUPPORTING_UNCALLED_ALLELE]
    if len(called) <= 1 and len(candidate.ref_support) < \
            MIN_REF_ALLELE_DEPTH:
        return False
    v = candidate.variant
    for allele in called:
        if v.end <= indel_end[0] or len(allele) != v.end - v.start:
            if indel_end[0] < v.end:
                indel_end[0] = v.end
            return False
    return True


class DirectPhasing:
    """Per-region read phaser."""

    def __init__(self, options: Optional[DirectPhasingOptions] = None):
        self.options = options or DirectPhasingOptions()
        self._clear()

    def _clear(self):
        self.vertices: List[AlleleVertex] = []
        self.positions: List[int] = []
        self.vertices_by_position: Dict[int, List[int]] = {}
        self.edges: Dict[Tuple[int, int], float] = {}
        self.in_edges: Dict[int, List[int]] = {}
        self.read_to_alleles: Dict[int, List[int]] = {}
        self.scores: Dict[Tuple[int, int], _Score] = {}

    # -- graph construction -------------------------------------------------

    def _add_vertex(self, position: int, bases: str,
                    read_support: Sequence[int]) -> int:
        vid = len(self.vertices)
        vertex = AlleleVertex(position, bases, list(read_support))
        self.vertices.append(vertex)
        self.vertices_by_position.setdefault(position, []).append(vid)
        for rid in vertex.read_support:
            if rid not in self.read_to_alleles:
                vertex.first_allele_reads.add(rid)
            self.read_to_alleles.setdefault(rid, []).append(vid)
        return vid

    def _add_edge(self, u: int, v: int, weight: float):
        self.edges[(u, v)] = self.edges.get((u, v), 0.0) + weight
        ins = self.in_edges.setdefault(v, [])
        if u not in ins:
            ins.append(u)

    def _add_candidate(self, candidate: DeepVariantCall):
        v = candidate.variant
        if len(candidate.ref_support) >= MIN_REF_ALLELE_DEPTH:
            self._add_vertex(v.start, REF_BASES, candidate.ref_support)
        for allele in sorted(candidate.allele_support):
            if allele == SUPPORTING_UNCALLED_ALLELE:
                continue
            self._add_vertex(
                v.start, allele, candidate.allele_support[allele]
            )

    def build(self, candidates: Sequence[DeepVariantCall]):
        self._clear()
        indel_end = [0]
        prev_start = None
        for candidate in candidates:
            # Candidates must arrive in strictly increasing position
            # order (direct_phasing.cc:846 CHECK_LT).
            if prev_start is not None and \
                    candidate.variant.start <= prev_start:
                raise ValueError(
                    "phasing candidates must be ordered by position: "
                    f"{candidate.variant.start} after {prev_start}"
                )
            prev_start = candidate.variant.start
            if _candidate_filter(candidate, indel_end):
                self._add_candidate(candidate)
                self.positions.append(candidate.variant.start)
        pos_index = {p: i for i, p in enumerate(self.positions)}
        # Edges between alleles at consecutive positions via shared reads.
        for rid, allele_vids in self.read_to_alleles.items():
            prev_vid = None
            for vid in allele_vids:
                if prev_vid is not None:
                    cur_pos = self.vertices[vid].position
                    prev_pos = self.vertices[prev_vid].position
                    i = pos_index[cur_pos]
                    if i > 0 and self.positions[i - 1] == prev_pos:
                        self._add_edge(prev_vid, vid, 1.0)
                prev_vid = vid

    # -- scoring DP ---------------------------------------------------------

    def _starting_score(self, vids: List[int]):
        for v1 in vids:
            for v2 in vids:
                self.scores.pop((v1, v2), None)
        for i, v1 in enumerate(vids):
            for v2 in vids[i:]:
                s1 = set(self.vertices[v1].read_support)
                s2 = set(self.vertices[v2].read_support)
                score = len(s1) if s1 == s2 else len(s1) + len(s2)
                self.scores[(v1, v2)] = _Score(score, None, (s1, s2))

    def _find_supporting_reads(
        self, vid: int, prev_score: _Score, phase: int
    ) -> Tuple[Set[int], Set[int]]:
        vertex = self.vertices[vid]
        continuing: Set[int] = set()
        starting: Set[int] = set()
        for rid in vertex.read_support:
            if rid in vertex.first_allele_reads:
                starting.add(rid)
            if rid in prev_score.read_support[phase]:
                continuing.add(rid)
        return continuing, starting

    def _calculate_score(self, e1: Tuple[int, int],
                         e2: Tuple[int, int]) -> Optional[_Score]:
        from_pair = (e1[0], e2[0])
        prev = self.scores.get(from_pair)
        if prev is None:
            return None
        to_vids = (e1[1], e2[1])
        per_phase = [
            self._find_supporting_reads(to_vids[p], prev, p)
            for p in range(NUM_PHASES)
        ]
        all_continuing = per_phase[0][0] | per_phase[1][0]
        all_starting = per_phase[0][1] | per_phase[1][1]
        score = prev.score + len(all_continuing) + len(all_starting) // 2
        if len(per_phase[0][0]) < 2 and len(per_phase[1][0]) < 2:
            score = prev.score
        return _Score(
            score,
            from_pair,
            (per_phase[0][0] | per_phase[0][1],
             per_phase[1][0] | per_phase[1][1]),
        )

    def _bases(self, vid: Optional[int]) -> str:
        return self.vertices[vid].bases if vid is not None else ""

    def _pair_greater(self, a: Tuple[Optional[int], Optional[int]],
                      b: Tuple[Optional[int], Optional[int]]) -> bool:
        """CompareVertexPairByBases: deterministic tie-break."""
        if a[0] is None or a[1] is None:
            return False
        if b[0] is None or b[1] is None:
            return True
        if self._bases(a[0]) > self._bases(b[0]):
            return True
        if self._bases(a[0]) < self._bases(b[0]):
            return False
        return self._bases(a[1]) > self._bases(b[1])

    def _run_dp(self):
        for i, pos in enumerate(self.positions):
            vids = self.vertices_by_position[pos]
            if i == 0:
                self._starting_score(vids)
                continue
            has_incoming = any(self.in_edges.get(v) for v in vids)
            if not has_incoming:
                self._starting_score(vids)
                continue
            # Connect orphan vertices to all previous-position vertices.
            incoming: List[Tuple[int, int]] = []
            for v in vids:
                ins = self.in_edges.get(v, [])
                if not ins:
                    for prev_v in self.vertices_by_position[
                        self.positions[i - 1]
                    ]:
                        self._add_edge(prev_v, v, 0.0)
                    ins = self.in_edges.get(v, [])
                for u in ins:
                    incoming.append((u, v))
            keyed_edges: Dict[Tuple[str, str], Tuple[int, int]] = {}
            for u, v in sorted(incoming):
                keyed_edges[(self._bases(u), self._bases(v))] = (u, v)
            found_advancing = False
            edges_sorted = [keyed_edges[k] for k in sorted(keyed_edges)]
            for e1 in edges_sorted:
                for e2 in edges_sorted:
                    prev = self.scores.get((e1[0], e2[0]))
                    if prev is None:
                        continue
                    score = self._calculate_score(e1, e2)
                    if score is None:
                        continue
                    if prev.score < score.score:
                        found_advancing = True
                    key = (e1[1], e2[1])
                    existing = self.scores.get(key)
                    if existing is None or existing.score < score.score:
                        self.scores[key] = score
                    elif existing.score == score.score:
                        if self._pair_greater(
                            score.from_pair or (None, None),
                            existing.from_pair or (None, None),
                        ):
                            self.scores[key] = score
            if i < len(self.positions) - 1 and (
                not found_advancing or self._all_scores_same(edges_sorted)
            ):
                self._starting_score(vids)

    def _all_scores_same(self, edges) -> bool:
        lo, hi = 1 << 30, 0
        for e1 in edges:
            for e2 in edges:
                s = self.scores.get((e1[1], e2[1]))
                if s is None:
                    continue
                lo = min(lo, s.score)
                hi = max(hi, s.score)
        return hi - lo <= 1

    # -- backtrack ----------------------------------------------------------

    def _max_score_at(self, i: int):
        vids = self.vertices_by_position[self.positions[i]]
        best_key, best = None, 0
        for v1 in vids:
            for v2 in vids:
                s = self.scores.get((v1, v2))
                if s is None:
                    continue
                if s.score > best:
                    best_key, best = (v1, v2), s.score
                elif s.score == best and best_key is not None:
                    if self._pair_greater((v1, v2), best_key):
                        best_key = (v1, v2)
                elif s.score == best and best_key is None:
                    best_key = (v1, v2)
        if best_key is None:
            return None
        # All-equal check: unphasable position.
        all_equal = True
        for v1 in vids:
            for v2 in vids:
                s = self.scores.get((v1, v2))
                if s is not None and s.score != best:
                    all_equal = False
                    break
            if not all_equal:
                break
        return None if all_equal else best_key

    def _assign_phases_to_vertices(self):
        if not self.scores:
            return
        i = len(self.positions) - 1
        prev_key = None
        while i >= 0:
            key = None
            while i >= 0:
                key = self._max_score_at(i)
                if key is None:
                    i -= 1
                else:
                    break
            if key is None:
                break
            if prev_key is not None:
                self.vertices[prev_key[0]].is_first_in_block = True
                self.vertices[prev_key[1]].is_first_in_block = True
            num_in_block = 0
            while key is not None:
                num_in_block += 1
                score = self.scores[key]
                if key[0] != key[1]:
                    self.vertices[key[0]].phase = 1
                    self.vertices[key[1]].phase = 2
                else:
                    self.vertices[key[0]].phase = 0
                if prev_key is not None and key != prev_key and \
                        num_in_block > 1 and \
                        score.score == self.scores[prev_key].score:
                    self.vertices[key[0]].phase = 0
                    self.vertices[key[1]].phase = 0
                    i -= 1
                    break
                nxt = score.from_pair
                if nxt is None or nxt not in self.scores:
                    if num_in_block == 1:
                        self.vertices[key[0]].phase = 0
                        self.vertices[key[1]].phase = 0
                    i -= 1
                    prev_key = key
                    key = None
                    break
                if nxt == key:
                    i -= 1
                    break
                prev_key = key
                key = nxt
                i -= 1
        if prev_key is not None:
            self.vertices[prev_key[0]].is_first_in_block = True
            self.vertices[prev_key[1]].is_first_in_block = True

    # -- public API ---------------------------------------------------------

    def phase_reads(
        self, candidates: Sequence[DeepVariantCall], num_reads: int
    ) -> List[int]:
        """Returns a phase (0/1/2) per read index [0, num_reads)."""
        self.build(candidates)
        self._run_dp()
        self._assign_phases_to_vertices()
        phases = [0] * num_reads
        min_alleles = self.options.min_alleles_to_phase
        for rid in range(num_reads):
            allele_vids = self.read_to_alleles.get(rid)
            if not allele_vids:
                continue
            counts = [0, 0, 0]
            for vid in allele_vids:
                counts[self.vertices[vid].phase] += 1
            if counts[1] > counts[2] and counts[1] >= min_alleles:
                phases[rid] = 1
            elif counts[2] > counts[1] and counts[2] >= min_alleles:
                phases[rid] = 2
        return phases

    def phased_variants(self) -> List[PhasedVariant]:
        out = []
        for pos in self.positions:
            bases = ["", ""]
            for vid in self.vertices_by_position.get(pos, []):
                vertex = self.vertices[vid]
                if vertex.phase == 1:
                    bases[0] = vertex.bases
                elif vertex.phase == 2:
                    bases[1] = vertex.bases
            if bases[0] and bases[1]:
                first = any(
                    self.vertices[vid].is_first_in_block
                    for vid in self.vertices_by_position.get(pos, [])
                    if self.vertices[vid].phase in (1, 2)
                )
                out.append(
                    PhasedVariant(pos, bases[0], bases[1], first)
                )
        return out

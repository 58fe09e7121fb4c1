"""Fast read-to-haplotype realignment.

Behavior parity with reference fast_pass_aligner.{h,cc}:
  1. k-mer index over the window's reads (BuildIndex, :611-617);
  2. exact/fast pass: for each haplotype position whose k-mer hits the
     index, whole-read comparison with <= max_num_of_mismatches
     mismatches; best score kept per read (FastAlignReadsToHaplotype,
     :227-301 — minus its coverage gate, which the goldens contradict;
     see the note in _fast_align_reads_to_haplotype);
  3. haplotypes align to the window reference with SSW
     (AlignHaplotypesToReference, :364-409); per-haplotype
     hap->ref position-shift maps (SetPositionsMap, :619-666);
  4. reads with no fast-pass alignment SSW-align to each supported
     haplotype (SswAlignReadsToHaplotypes, :411-457);
  5. each read adopts its best haplotype alignment (non-ref preferred on
     ties, GetBestReadAlignment, :673-697), with the read->ref CIGAR
     produced by merging read->hap with hap->ref ops
     (CalculateReadToRefAlignment, :861-993 + MergeCigarOp) and dropped
     if the result is not left-normalized (IsAlignmentNormalized).

The port's copy of `deepvariant_tpu.realign.fast_pass_aligner`, in Python
and numpy on the host, held to what that package gives with its native
library loaded. That decides step 4: the fallback first scores every
(haplotype, read) pair with `ssw.local_scores`, where an N never matches,
picks each read's winner from those scores, and only then runs the full
alignment for the winner with `align(known_score=...)`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.cigar import CHAR_TO_PROTO_OP
from deepvariant_tpu_torch.core.types import Read
from deepvariant_tpu_torch.realign.config import AlignerOptions
from deepvariant_tpu_torch.realign.ssw import SswAligner, local_scores

# proto op codes (reads.proto CigarUnit)
OP_M = CHAR_TO_PROTO_OP["M"]
OP_I = CHAR_TO_PROTO_OP["I"]
OP_D = CHAR_TO_PROTO_OP["D"]
OP_S = CHAR_TO_PROTO_OP["S"]

_CIGAR_RE = re.compile(r"(\d+)([XIDS=M])")

NOT_ALIGNED = -1


def cigar_string_to_ops(cigar: str) -> List[List[int]]:
    """'10=2I3X' -> [[op, len], ...] with =/X/M -> OP_M."""
    ops = []
    for length, op_char in _CIGAR_RE.findall(cigar):
        if op_char in "=XM":
            op = OP_M
        elif op_char == "I":
            op = OP_I
        elif op_char == "D":
            op = OP_D
        else:
            op = OP_S
        ops.append([op, int(length)])
    return ops


@dataclasses.dataclass(slots=True)
class ReadAlignment:
    score: int = 0
    position: int = NOT_ALIGNED
    cigar: str = ""


class HaplotypeReadsAlignment:
    def __init__(self, haplotype_index: int, haplotype_score: int,
                 read_alignments: List[ReadAlignment]):
        self.haplotype_index = haplotype_index
        self.haplotype_score = haplotype_score
        self.read_alignments = read_alignments
        self.is_reference = False
        self.cigar = ""
        self.cigar_ops: List[List[int]] = []
        self.ref_pos = 0
        self.hap_to_ref_positions_map: List[int] = []


def set_positions_map(haplotype_size: int,
                      hap_alignment: HaplotypeReadsAlignment):
    """hap position -> ref-shift map (fast_pass_aligner.cc:619-666)."""
    positions_map = [0] * haplotype_size
    cur_shift = 0
    hap_pos = 0
    for length, op in _CIGAR_RE.findall(hap_alignment.cigar):
        length = int(length)
        if op in "=XM":
            for _ in range(length):
                positions_map[hap_pos] = cur_shift
                hap_pos += 1
        elif op == "S":
            cur_shift -= length
            for _ in range(length):
                positions_map[hap_pos] = cur_shift
                hap_pos += 1
        elif op == "D":
            cur_shift += length
        elif op == "I":
            for _ in range(length):
                positions_map[hap_pos] = cur_shift
                cur_shift -= 1
                hap_pos += 1
    hap_alignment.hap_to_ref_positions_map = positions_map


def aligned_length(cigar: List[List[int]]) -> int:
    return sum(l for op, l in cigar if op != OP_D)


def merge_cigar_op(op: List[int], read_len: int, cigar: List[List[int]]):
    """MergeCigarOp (fast_pass_aligner.cc:712-776): merge a (possibly
    one-base) op into the output cigar, with INS/DEL annihilation."""
    last_op = cigar[-1][0] if cigar else None
    aligned_before = aligned_length(cigar)
    if op[0] != OP_D:
        new_len = min(op[1], read_len - aligned_before)
    else:
        new_len = op[1]
    if new_len <= 0 or aligned_before == read_len:
        return
    if (op[0] == OP_I and last_op == OP_D) or \
            (op[0] == OP_D and last_op == OP_I):
        # INS and DEL cancel one base; insert/extend a MATCH before the
        # trailing indel.
        if len(cigar) > 1 and cigar[-2][0] == OP_M:
            cigar[-2][1] += 1
        else:
            cigar.insert(len(cigar) - 1, [OP_M, 1])
        if cigar[-1][1] == 1:
            cigar.pop()
        else:
            cigar[-1][1] -= 1
    elif op[0] == last_op:
        cigar[-1][1] += new_len
    else:
        cigar.append([op[0], new_len])


def left_trim_hap_to_ref(
    hap_to_ref: List[List[int]], read_to_hap_pos: int
) -> List[List[int]]:
    """LeftTrimHaplotypeToRefAlignment (fast_pass_aligner.cc:783-822)."""
    ops = [list(x) for x in hap_to_ref]
    cur_pos = 0
    while cur_pos != read_to_hap_pos:
        assert ops, "ran out of cigar while trimming"
        cur = ops.pop(0)
        if cur[0] in (OP_M, OP_S, OP_I):
            if cur[1] + cur_pos > read_to_hap_pos:
                ops.insert(0, [cur[0],
                               cur[1] - (read_to_hap_pos - cur_pos)])
            cur_pos = min(cur[1] + cur_pos, read_to_hap_pos)
    if ops and ops[0][0] == OP_D:
        ops.pop(0)
    return ops


def _merge_one_base(cur_read_to_hap: List[int], cur_hap_to_ref: List[int],
                    read_len: int, out: List[List[int]]):
    """MergeOneBaseOperations: priority S > D > I > M."""
    for op in (OP_S, OP_D, OP_I, OP_M):
        if cur_read_to_hap[0] == op or cur_hap_to_ref[0] == op:
            merge_cigar_op([op, 1], read_len, out)
            return


def calculate_read_to_ref_alignment(
    read_seq: str,
    read_alignment: ReadAlignment,
    hap_to_ref_ops: List[List[int]],
) -> List[List[int]]:
    """Merge read->hap and hap->ref cigars
    (CalculateReadToRefAlignment, fast_pass_aligner.cc:861-993)."""
    read_len = len(read_seq)
    read_to_hap = cigar_string_to_ops(read_alignment.cigar)
    hap_to_ref = left_trim_hap_to_ref(hap_to_ref_ops,
                                      read_alignment.position)
    assert hap_to_ref, "read must overlap haplotype"
    out: List[List[int]] = []

    if read_to_hap and read_to_hap[0][0] == OP_S:
        merge_cigar_op([OP_S, read_to_hap[0][1]], read_len, out)
        read_to_hap.pop(0)

    cur_rh = [0, 0]  # [op, remaining]
    cur_hr = [0, 0]
    while (read_to_hap or hap_to_ref) and aligned_length(out) < read_len:
        if read_to_hap and not hap_to_ref and cur_hr[1] == 0:
            merge_cigar_op(read_to_hap.pop(0), read_len, out)
            continue
        if not read_to_hap and cur_rh[1] == 0 and hap_to_ref:
            break
        if cur_rh[1] == 0:
            cur_rh = list(read_to_hap.pop(0))
        if cur_hr[1] == 0:
            cur_hr = list(hap_to_ref.pop(0))
        while cur_rh[1] > 0 and cur_hr[1] > 0:
            if cur_rh[0] == OP_M and cur_hr[0] == OP_M:
                # Bulk the dominant match x match stretch: each
                # per-base iteration would emit [M, 1] and decrement
                # both ops, so emitting [M, n] at once is identical.
                n = min(cur_rh[1], cur_hr[1])
                merge_cigar_op([OP_M, n], read_len, out)
                cur_rh[1] -= n
                cur_hr[1] -= n
                continue
            if (cur_rh[0] == OP_D and cur_hr[0] == OP_I) or \
                    (cur_rh[0] == OP_I and cur_hr[0] == OP_D):
                cur_hr[1] -= 1
                cur_rh[1] -= 1
                if cur_hr[0] == OP_D:
                    hap_to_ref.insert(0, [OP_M, 1])
                    read_to_hap.insert(0, [OP_M, 1])
                continue
            _merge_one_base(cur_rh, cur_hr, read_len, out)
            if cur_rh[0] == OP_I:
                cur_rh[1] -= 1
            elif cur_hr[0] == OP_D:
                cur_hr[1] -= 1
            else:
                cur_hr[1] -= 1
                cur_rh[1] -= 1

    if cur_rh[1] > 0 and cur_rh[0] == OP_S:
        while cur_rh[1] > 0:
            _merge_one_base(cur_rh, cur_hr, read_len, out)
            cur_rh[1] -= 1

    if read_to_hap or cur_rh[1] > 0:
        return []
    return out


class FastPassAligner:
    """Realigns one window's reads against its candidate haplotypes."""

    def __init__(self, options: Optional[AlignerOptions] = None):
        self.options = options or AlignerOptions()
        self.reference = ""
        self.haplotypes: List[str] = []
        self.region_chromosome = ""
        self.region_position_in_chr = 0
        self.ref_prefix_len = 0
        self.ref_suffix_len = 0
        self.normalize_reads = False
        self._reads: List[str] = []
        self._kmer_index: Dict[str, List[Tuple[int, int]]] = {}
        self._hap_alignments: List[HaplotypeReadsAlignment] = []

    # -- setup --------------------------------------------------------------

    def set_reference(self, reference: str):
        self.reference = reference

    def set_ref_start(self, chromosome: str, position: int):
        self.region_chromosome = chromosome
        self.region_position_in_chr = position

    def set_haplotypes(self, haplotypes: Sequence[str]):
        self.haplotypes = list(haplotypes)

    def set_ref_prefix_len(self, n: int):
        self.ref_prefix_len = n

    def set_ref_suffix_len(self, n: int):
        self.ref_suffix_len = n

    def _ssw_score_threshold(self) -> int:
        o = self.options
        t = o.match * o.read_size * o.realignment_similarity_threshold \
            - o.mismatch * o.read_size * \
            (1 - o.realignment_similarity_threshold)
        return 1 if t < 0 else int(t)

    # -- indexing -----------------------------------------------------------

    def _build_index(self):
        k = self.options.kmer_size
        self._kmer_index = {}
        for read_id, read in enumerate(self._reads):
            if len(read) <= k:
                continue
            for i in range(len(read) - k + 1):
                self._kmer_index.setdefault(read[i:i + k], []).append(
                    (read_id, i)
                )

    # -- fast pass ----------------------------------------------------------

    def _fast_align_strings(self, s1: str, s2: str,
                            max_mismatches: int) -> Tuple[int, int]:
        """(score, num_mismatches); score 0 if cap hit
        (FastAlignStrings, :304-327)."""
        num_mismatches = 0
        num_matches = 0
        for c1, c2 in zip(s1, s2):
            if c1 != c2 and c1 != "N" and c2 != "N":
                num_mismatches += 1
                if num_mismatches == max_mismatches:
                    return 0, num_mismatches
            else:
                num_matches += 1
        return (num_matches * self.options.match
                - num_mismatches * self.options.mismatch), num_mismatches

    def _fast_align_reads_to_haplotype(
        self, haplotype: str, read_alignments: List[ReadAlignment]
    ) -> int:
        k = self.options.kmer_size
        hap_len = len(haplotype)
        haplotype_score = 0
        last_pos = hap_len - k
        max_mm = self.options.max_num_of_mismatches
        match = self.options.match
        kmer_get = self._kmer_index.get
        reads = self._reads
        # A (read, target position) pair compares the same way every
        # time one of the read's k-mers brings it up again, and a repeat
        # can never raise the read's score, so each pair is compared
        # once.
        compared = set()
        for i in range(last_pos + 1):
            hits = kmer_get(haplotype[i:i + k])
            if hits:
                for read_id, read_pos in hits:
                    target_start = i - read_pos
                    if target_start < 0:
                        target_start = 0
                    read = reads[read_id]
                    span = len(read)
                    if target_start + span > hap_len:
                        continue
                    key = (read_id, target_start)
                    if key in compared:
                        continue
                    compared.add(key)
                    ra = read_alignments[read_id]
                    if ra.position == target_start:
                        continue
                    if haplotype.startswith(read, target_start):
                        score, mismatches = span * match, 0
                    else:
                        score, mismatches = self._fast_align_strings(
                            haplotype[target_start:target_start + span],
                            read, max_mm + 1,
                        )
                    if mismatches <= max_mm:
                        if ra.score < score:
                            haplotype_score += score - ra.score
                            ra.score = score
                            ra.position = target_start
                            ra.cigar = f"{span}="
        # NOTE on the reference's coverage gate: today's
        # FastAlignReadsToHaplotype (fast_pass_aligner.cc:293-299)
        # discards any non-reference haplotype whose scan reaches a
        # target position with zero fast-aligned read coverage. The
        # golden examples contradict that gate twice over: windows
        # whose first target positions are uncovered (partition-edge
        # windows get no reads left of the boundary) still realign
        # reads against non-reference haplotypes, and haplotypes whose
        # only tail support surfaces one k-mer past a read mismatch
        # stay alive. The goldens are the acceptance bar, so no
        # coverage-based haplotype discard is applied here; a
        # haplotype with no fast-aligned reads at all naturally scores
        # 0 and is skipped by the SSW fallback.
        return haplotype_score

    # -- main ---------------------------------------------------------------

    def realign_reads(self, reads: Sequence[Read]) -> List[Read]:
        """AlignReads (fast_pass_aligner.cc:131-175).

        Hot-loop design: per-(haplotype, read) alignment state lives in
        (n_haps, n_reads) score/position matrices; ReadAlignment objects
        are materialized only for each read's winning haplotype in
        _realign_reads_to_reference."""
        self._reads = [r.aligned_sequence.upper() for r in reads]
        if self._reads:
            self.options.read_size = len(self._reads[0])
        score_threshold = self._ssw_score_threshold()
        n_reads = len(self._reads)
        n_haps = len(self.haplotypes)
        if n_haps == 0:
            return [
                Read() if self.options.force_alignment else r
                for r in reads
            ]
        # Fast pass per haplotype.
        self._build_index()
        self._hap_alignments = []
        scores = np.zeros((n_haps, n_reads), np.int64)
        positions = np.full((n_haps, n_reads), NOT_ALIGNED, np.int64)
        for hap_index, haplotype in enumerate(self.haplotypes):
            read_alignments = [ReadAlignment() for _ in self._reads]
            hap_score = self._fast_align_reads_to_haplotype(
                haplotype, read_alignments
            )
            if hap_score != 0:
                for r, ra in enumerate(read_alignments):
                    if ra.score > 0:
                        scores[hap_index, r] = ra.score
                        positions[hap_index, r] = ra.position
            self._hap_alignments.append(
                HaplotypeReadsAlignment(hap_index, hap_score, [])
            )

        # Align haplotypes to the reference
        # (AlignHaplotypesToReference, fast_pass_aligner.cc:364-409).
        # Hot-loop design: the full SSW DP with traceback is deferred
        # until a haplotype actually wins a read projection
        # (_ensure_hap_ref_alignment) — typically 2-3 of ~12 haps.
        # Only `is_reference` is needed eagerly (the fallback loop and
        # the best-alignment tie-break read it), and a haplotype is
        # reference-identical iff it occurs verbatim in the window
        # reference: then SSW's optimum is the unique full-length "="
        # match, which is exactly the eager criterion
        # `cigar == f"{len(hap)}="`.
        self._ref_ssw = None
        for ha in self._hap_alignments:
            hap = self.haplotypes[ha.haplotype_index]
            idx = self.reference.find(hap)
            if idx >= 0:
                ha.is_reference = True
                ha.cigar = f"{len(hap)}="
                ha.ref_pos = idx
                ha.cigar_ops = cigar_string_to_ops(ha.cigar)
                set_positions_map(len(hap), ha)
            else:
                ha.needs_ref_alignment = True

        # SSW fallback for unaligned reads. Only the best-scoring
        # haplotype alignment of a read is ever projected back to the
        # reference, so the all-pairs sweep needs scores only
        # (ssw.local_scores, every fallback read against one haplotype
        # per call), and the full DP with traceback runs once per read
        # on the winner (_materialize_ssw_alignment).
        fallback_ids = np.nonzero(scores.max(axis=0) <= 0)[0]
        o = self.options
        if len(fallback_ids):
            fallback_reads = [self._reads[i] for i in fallback_ids]
            for hi, ha in enumerate(self._hap_alignments):
                forced = bool(o.force_alignment and ha.is_reference)
                if ha.haplotype_score == 0 and not forced:
                    continue
                srow = local_scores(
                    self.haplotypes[ha.haplotype_index], fallback_reads,
                    o.match, o.mismatch, o.gap_open, o.gap_extend,
                )
                ok = (srow > 0) & ((srow >= score_threshold) | forced)
                sel = fallback_ids[ok]
                scores[hi, sel] = srow[ok]
                positions[hi, sel] = NOT_ALIGNED  # cigar made on the winner

        # Winner per read over haplotypes in ascending-haplotype_score
        # order (the reference sorts, then iterates; ties prefer the
        # last non-reference haplotype — GetBestReadAlignment,
        # fast_pass_aligner.cc:673-697).
        order = sorted(
            range(n_haps),
            key=lambda h: self._hap_alignments[h].haplotype_score,
        )
        order_arr = np.asarray(order, np.int64)
        s_o = scores[order_arr]
        is_ref_o = np.array(
            [self._hap_alignments[h].is_reference for h in order], bool
        )
        top = s_o.max(axis=0)
        eligible = (s_o == top[None, :]) & (top[None, :] > 0)
        nonref = eligible & ~is_ref_o[:, None]
        has_nonref = nonref.any(axis=0)
        idx_last_nonref = n_haps - 1 - np.argmax(nonref[::-1], axis=0)
        idx_first = np.argmax(eligible, axis=0)
        best_orig = order_arr[
            np.where(has_nonref, idx_last_nonref, idx_first)
        ]
        valid = top > 0

        return self._realign_reads_to_reference(
            reads, scores, positions, best_orig, valid
        )

    def _is_alignment_normalized(
        self, cigar: List[List[int]], ref_offset: int, read_seq: str
    ) -> bool:
        """IsAlignmentNormalized (fast_pass_aligner.cc:459-520)."""
        if ref_offset < 0:
            return True
        cur_ref = ref_offset
        cur_read = 0
        for op, length in cigar:
            if op == OP_S:
                cur_read += length
                continue
            if op != OP_M:
                if op == OP_D:
                    if cur_ref + length > len(self.reference):
                        return False
                    op_seq = self.reference[cur_ref:cur_ref + length]
                else:
                    op_seq = read_seq[cur_read:cur_read + length]
                if not op_seq:
                    return False
                if (cur_ref > 0 and op == OP_I
                        and op_seq[-1] == self.reference[cur_ref - 1]) or \
                   (cur_read > 0 and op == OP_D
                        and op_seq[-1] == read_seq[cur_read - 1]):
                    return False
            if op != OP_I:
                cur_ref += length
            if op != OP_D:
                cur_read += length
        return True

    def _ensure_hap_ref_alignment(
        self, ha: HaplotypeReadsAlignment
    ) -> None:
        """Run the deferred hap->ref SSW for a winning haplotype.

        Produces byte-identical state to the former eager loop: the
        sw_score>0 guard, cigar_ops, and positions_map all match
        (AlignHaplotypesToReference, fast_pass_aligner.cc:364-409)."""
        if not getattr(ha, "needs_ref_alignment", False):
            return
        ha.needs_ref_alignment = False
        hap = self.haplotypes[ha.haplotype_index]
        if self._ref_ssw is None:
            self._ref_ssw = SswAligner(
                self.options.match, self.options.mismatch,
                self.options.gap_open, self.options.gap_extend,
            )
            self._ref_ssw.set_reference_sequence(self.reference)
        alignment = self._ref_ssw.align(hap)
        if alignment.sw_score > 0:
            ha.is_reference = alignment.cigar_string == f"{len(hap)}="
            ha.cigar = alignment.cigar_string
            ha.ref_pos = alignment.ref_begin
        ha.cigar_ops = cigar_string_to_ops(ha.cigar)
        set_positions_map(len(hap), ha)

    def _materialize_ssw_alignment(
        self, ha: HaplotypeReadsAlignment, ra: ReadAlignment,
        read_id: int
    ) -> None:
        cache = getattr(self, "_lazy_ssw", None)
        if cache is None:
            cache = self._lazy_ssw = {}
        aligner = cache.get(ha.haplotype_index)
        if aligner is None:
            aligner = SswAligner(
                self.options.match, self.options.mismatch,
                self.options.gap_open, self.options.gap_extend,
            )
            aligner.set_reference_sequence(
                self.haplotypes[ha.haplotype_index]
            )
            cache[ha.haplotype_index] = aligner
        alignment = aligner.align(
            self._reads[read_id], known_score=ra.score
        )
        ra.cigar = alignment.cigar_string
        ra.position = alignment.ref_begin

    def _realign_reads_to_reference(
        self, reads: Sequence[Read], scores: np.ndarray,
        positions: np.ndarray, best_orig: np.ndarray,
        valid: np.ndarray,
    ) -> List[Read]:
        out: List[Read] = []
        for read_id, read in enumerate(reads):
            if not valid[read_id]:
                # force_alignment keeps indices aligned with empty reads
                # (RealignReadsToReference, fast_pass_aligner.cc:582-590).
                out.append(Read() if self.options.force_alignment else read)
                continue
            hi = int(best_orig[read_id])
            ha = self._hap_alignments[hi]
            self._ensure_hap_ref_alignment(ha)
            score = int(scores[hi, read_id])
            pos_m = int(positions[hi, read_id])
            # Fast path: full-match read->hap on an all-M hap->ref
            # cigar (the overwhelmingly common case — reference-equal
            # haps align as one "=" run and SNP-alt haps as =X= runs,
            # all of which parse to OP_M units). The general merge
            # reduces to [[M, n]] when the read fits, [] otherwise,
            # and the positions-map shift is zero everywhere.
            all_match_len = getattr(ha, "_all_match_len", -2)
            if all_match_len == -2:
                ops = ha.cigar_ops
                all_match_len = (
                    sum(l for _, l in ops)
                    if ops and all(op == OP_M for op, _ in ops) else -1
                )
                ha._all_match_len = all_match_len
            if (pos_m != NOT_ALIGNED
                    and all_match_len >= 0
                    and 0 <= pos_m < len(ha.hap_to_ref_positions_map)):
                n = len(self._reads[read_id])
                if pos_m + n <= all_match_len:
                    new_position = (
                        self.region_position_in_chr + ha.ref_pos + pos_m
                    )
                    if (read.position == new_position
                            and len(read.cigar) == 1
                            and read.cigar[0][0] == OP_M
                            and read.cigar[0][1] == n):
                        out.append(read)
                    else:
                        out.append(dataclasses.replace(
                            read, position=new_position,
                            cigar=[(OP_M, n)],
                        ))
                else:
                    out.append(read)
                continue
            if pos_m == NOT_ALIGNED:
                # The fallback stored only the score; run the full DP
                # once for the winning haplotype.
                ra = ReadAlignment(score, NOT_ALIGNED, "")
                self._materialize_ssw_alignment(ha, ra, read_id)
            else:
                ra = ReadAlignment(
                    score, pos_m, f"{len(self._reads[read_id])}="
                )
            read_to_hap_pos = ra.position
            if not (0 <= read_to_hap_pos <
                    len(ha.hap_to_ref_positions_map)):
                out.append(read)
                continue
            hap_to_ref_shift = \
                ha.hap_to_ref_positions_map[read_to_hap_pos]
            new_position = (
                self.region_position_in_chr + ha.ref_pos
                + read_to_hap_pos + hap_to_ref_shift
            )
            try:
                new_cigar = calculate_read_to_ref_alignment(
                    self._reads[read_id], ra, ha.cigar_ops
                )
            except AssertionError:
                new_cigar = []
            if new_cigar and not self.normalize_reads:
                if not self._is_alignment_normalized(
                    new_cigar,
                    ha.ref_pos + read_to_hap_pos + hap_to_ref_shift,
                    self._reads[read_id],
                ):
                    new_cigar = []
            if new_cigar:
                new_read = dataclasses.replace(
                    read,
                    position=new_position,
                    cigar=[tuple(c) for c in new_cigar],
                )
                out.append(new_read)
            else:
                out.append(read)
        return out

"""Vectorized allele counting over a genomic interval.

Re-implements the semantics of the reference's C++ AlleleCounter
(deepvariant/allelecounter.{h,cc}; CIGAR walk at allelecounter.cc:860-980,
indel allele construction at :402-465, dedup + aggregation at :471-520) as a
columnar numpy program over a ReadBatch:

- M/=/X bases become REFERENCE or SUBSTITUTION events at their interval
  offset; base must be canonical (ACGT); a base with quality below
  min_base_quality is flagged low-quality (still recorded, excluded from
  counts — the non-legacy behavior).
- I/S/D become indel events anchored at interval_offset-1 ("VCF convention"):
  bases = prev_base + inserted/clipped read bases (I/S) or + deleted ref
  bases (D). prev_base comes from the read (or the reference when the op is
  the first thing in the read). Events with non-canonical bases are dropped.
  Indel low-quality flag: sum(quals) < min_base_quality * len (deletions are
  never low-quality; their quality is the anchor base's).
- If two consecutive events of one read share a position (indel anchored on a
  match base), the earlier event is dropped.
- Per position: REFERENCE events increment ref_supporting_read_count; non-ref
  events are recorded per read.

The match-base scan is fully vectorized (one pass over all reads); only indel
CIGAR units (rare) take a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import Range
from deepvariant_tpu_torch.io.bam import ReadBatch

# Allele types (mirror DeepVariant's AlleleType enum semantics).
REFERENCE = 0
SUBSTITUTION = 1
INSERTION = 2
DELETION = 3
SOFT_CLIP = 4

_IS_CANONICAL = np.zeros(256, dtype=bool)
for _b in b"ACGT":
    _IS_CANONICAL[_b] = True

# CIGAR proto op codes.
_OP_M, _OP_I, _OP_D, _OP_N, _OP_S, _OP_H, _OP_P, _OP_EQ, _OP_X = range(1, 10)
_MATCH_OPS = np.zeros(10, dtype=bool)
_MATCH_OPS[[_OP_M, _OP_EQ, _OP_X]] = True
_READ_CONSUME = np.zeros(10, dtype=np.int8)
_READ_CONSUME[[_OP_M, _OP_I, _OP_S, _OP_EQ, _OP_X]] = 1
_REF_CONSUME = np.zeros(10, dtype=np.int8)
_REF_CONSUME[[_OP_M, _OP_D, _OP_N, _OP_EQ, _OP_X]] = 1


def build_unit_table(batch: ReadBatch, read_indices: np.ndarray,
                     interval_start: int):
    """Global per-unit metadata for all cigar units of the selected
    reads, fully vectorized (segmented cumsums): per unit its read
    index, op, length, interval-relative reference start, read-offset
    start, and within-read cigar index. Shared by the allele counter's
    match/indel event extraction and the window selector's scoring."""
    co = batch.cigar_offsets
    unit_counts = (co[read_indices + 1] - co[read_indices]).astype(
        np.int64
    )
    if unit_counts.sum() == 0:
        return None
    # Flattened unit indices for selected reads.
    unit_first = co[read_indices]
    cum_units = np.concatenate([[0], np.cumsum(unit_counts)])
    total_units = int(cum_units[-1])
    unit_read_sel = np.repeat(
        np.arange(len(read_indices)), unit_counts
    )  # index into read_indices
    intra_unit = (
        np.arange(total_units) - cum_units[unit_read_sel]
    )
    unit_global = unit_first[unit_read_sel] + intra_unit
    ops = batch.cigar_ops[unit_global]
    lens = batch.cigar_lens[unit_global].astype(np.int64)
    ref_consume = _REF_CONSUME[ops] * lens
    read_consume = _READ_CONSUME[ops] * lens
    # Segmented exclusive prefix sums within each read.
    gref = np.concatenate([[0], np.cumsum(ref_consume)])
    gread = np.concatenate([[0], np.cumsum(read_consume)])
    seg_base_ref = gref[cum_units[unit_read_sel]]
    seg_base_read = gread[cum_units[unit_read_sel]]
    ref_starts = (
        batch.pos[read_indices][unit_read_sel]
        - interval_start
        + gref[np.arange(total_units)]
        - seg_base_ref
    )
    read_starts = gread[np.arange(total_units)] - seg_base_read
    return {
        "read": read_indices[unit_read_sel].astype(np.int64),
        "ops": ops,
        "lens": lens,
        "ref_starts": ref_starts,
        "read_starts": read_starts,
        "intra": intra_unit,
    }


@dataclasses.dataclass
class AlleleCounterOptions:
    min_base_quality: int = 10
    min_mapping_quality: int = 5
    keep_legacy_behavior: bool = False
    track_ref_reads: bool = False


@dataclasses.dataclass
class ReadAlleleRecord:
    """A non-reference allele observed in one read at one position."""

    read_idx: int
    bases: str
    type: int
    is_low_quality: bool
    mapping_quality: int
    avg_base_quality: int
    is_reverse_strand: bool


class PositionCount:
    """All allele observations at one interval position."""

    __slots__ = ("ref_supporting_read_count", "read_alleles",
                 "ref_supporting_read_ids")

    def __init__(self):
        self.ref_supporting_read_count = 0
        self.read_alleles: Dict[int, ReadAlleleRecord] = {}
        self.ref_supporting_read_ids: List[int] = []


@dataclasses.dataclass
class Allele:
    bases: str
    type: int
    count: int
    read_ids: List[int]
    is_low_quality: bool = False

    @property
    def is_indel(self) -> bool:
        return self.type in (INSERTION, DELETION)


class AlleleCounter:
    """Counts alleles over `interval` given reads and reference bases."""

    def __init__(
        self,
        ref_bases_interval: np.ndarray,
        interval: Range,
        options: Optional[AlleleCounterOptions] = None,
        ref_prev_base: str = "N",
        ref_bases_after: Optional[np.ndarray] = None,
    ):
        """`ref_bases_interval`: uint8 ASCII ref bases covering interval.
        `ref_prev_base`: the reference base just before interval.start (used
        when an indel starts exactly at the interval boundary).
        `ref_bases_after`: reference bases following interval.end, used by
        deletions anchored inside the interval that extend past its end
        (the reference fetches these from the full reference reader,
        allelecounter.cc RefBases:371-384; only a deletion spanning off
        the CONTIG drops the allele)."""
        assert len(ref_bases_interval) == len(interval)
        self.interval = interval
        self.options = options or AlleleCounterOptions()
        self.ref = ref_bases_interval
        self._ref_after = (
            ref_bases_after if ref_bases_after is not None
            else np.empty(0, np.uint8)
        )
        self._prev_base = ref_prev_base
        width = len(interval)
        self.ref_count = np.zeros(width, np.int32)
        self._positions: Dict[int, PositionCount] = {}
        self.n_reads_counted = 0
        self._batch: Optional[ReadBatch] = None

    # -- event generation -------------------------------------------------------

    def add_batch(self, batch: ReadBatch) -> None:
        """Add all reads in a batch (the hot path, vectorized)."""
        self._batch = batch
        opts = self.options
        n = len(batch)
        if n == 0:
            return
        keep = batch.mapq >= opts.min_mapping_quality
        read_indices = np.nonzero(keep)[0]
        if len(read_indices) == 0:
            return
        self.n_reads_counted += len(read_indices)

        units = self._unit_table(batch, read_indices)
        if units is None:
            return
        ev_read, ev_pos, ev_order, ev_kind, ev_payload = self._match_events(
            batch, units
        )
        indel_events = self._indel_events(batch, units)

        # Merge match + indel events, ordered (read, cigar order).
        # Match events already come sorted by (read, order). Indel events are
        # interleaved via a stable merge on the order key.
        self._apply_events(
            batch, ev_read, ev_pos, ev_order, ev_kind, ev_payload,
            indel_events,
        )

    def _unit_table(self, batch: ReadBatch, read_indices: np.ndarray):
        return build_unit_table(batch, read_indices, self.interval.start)

    def _match_events(self, batch: ReadBatch, units: dict):
        """Vectorized per-base events for all M/=/X cigar units.

        Returns (read_idx, interval_pos, order_key, kind, payload) arrays
        where kind is 0=ref, 1=sub (payload = read base byte) and order_key
        orders events within a read by cigar position.
        """
        ops = units["ops"]
        m = _MATCH_OPS[ops]
        u_read = units["read"][m]
        u_len = units["lens"][m]
        u_ref = units["ref_starts"][m]
        u_rd = units["read_starts"][m]
        u_ord = units["intra"][m]
        if len(u_read) == 0:
            empty = np.empty(0, np.int64)
            return empty, empty, empty, empty, empty

        # Expand units to per-base events.
        total = int(u_len.sum())
        if total == 0:
            empty = np.empty(0, np.int64)
            return empty, empty, empty, empty, empty
        rep = u_len.astype(np.int64)
        base_read = np.repeat(u_read, rep)
        # intra-unit offsets: arange within each unit.
        cum = np.concatenate([[0], np.cumsum(rep)[:-1]])
        intra = np.arange(total, dtype=np.int64) - np.repeat(cum, rep)
        base_pos = np.repeat(u_ref, rep) + intra
        base_readoff = np.repeat(u_rd, rep) + intra
        # order key: (cigar unit index << 32) + intra keeps cigar order.
        base_order = (np.repeat(u_ord, rep) << 32) + intra

        seq_global = batch.seq_offsets[base_read] + base_readoff
        bases = batch.seq[seq_global]
        quals = batch.qual[seq_global]

        # Filter: in-interval + canonical read base.
        width = len(self.interval)
        ok = (base_pos >= 0) & (base_pos < width) & _IS_CANONICAL[bases]
        base_read = base_read[ok]
        base_pos = base_pos[ok]
        base_order = base_order[ok]
        bases = bases[ok]
        quals = quals[ok]

        ref_at = self.ref[base_pos]
        is_sub = bases != ref_at
        low_q = quals < self.options.min_base_quality
        if self.options.keep_legacy_behavior:
            keep2 = ~low_q
            base_read, base_pos, base_order = (
                base_read[keep2], base_pos[keep2], base_order[keep2]
            )
            bases, quals, is_sub = bases[keep2], quals[keep2], is_sub[keep2]
            low_q = low_q[keep2]

        # kind: 0 = ref (not low q), 1 = sub, 2 = ref low-q, 3 = sub low-q
        kind = is_sub.astype(np.int64) + 2 * low_q.astype(np.int64)
        payload = (bases.astype(np.int64) << 8) | quals.astype(np.int64)
        return base_read, base_pos, base_order, kind, payload

    def _indel_events(
        self, batch: ReadBatch, units: dict
    ) -> List[tuple]:
        """Python loop over I/D/S cigar units only (rare), pulled from
        the shared unit table with bulk tolist() conversion — no
        per-read numpy slicing. Returns event tuples
        (read_idx, interval_pos, order_key, record)."""
        events: List[tuple] = []
        so = batch.seq_offsets
        width = len(self.interval)
        min_q = self.options.min_base_quality
        all_ops = units["ops"]
        mask = (
            (all_ops == _OP_I) | (all_ops == _OP_D) | (all_ops == _OP_S)
        )
        if not mask.any():
            return events
        idx = np.nonzero(mask)[0]
        u_read = units["read"][idx]
        r_list = u_read.tolist()
        op_list = all_ops[idx].tolist()
        len_list = units["lens"][idx].tolist()
        refoff_list = units["ref_starts"][idx].tolist()
        readoff_list = units["read_starts"][idx].tolist()
        k_list = units["intra"][idx].tolist()
        mapq_list = batch.mapq[u_read].tolist()
        rev_list = ((batch.flag[u_read] & 0x10) != 0).tolist()
        seqoff_list = so[u_read].tolist()
        seq_all = batch.seq
        qual_all = batch.qual
        for r, op, op_len, interval_offset, read_offset, k, mapq, \
                reverse, sbase in zip(
                    r_list, op_list, len_list, refoff_list,
                    readoff_list, k_list, mapq_list, rev_list,
                    seqoff_list):
            anchor_pos = interval_offset - 1
            # prev base: from read, or from reference at interval-1.
            if read_offset == 0:
                if interval_offset == 0:
                    prev = self._prev_base
                elif 0 < interval_offset <= width:
                    prev = chr(self.ref[interval_offset - 1])
                else:
                    prev = "N"
            else:
                prev = chr(seq_all[sbase + read_offset - 1])
            if prev not in "ACGT":
                continue
            low_q = False
            if op == _OP_D:
                atype = DELETION
                if interval_offset < 0 or (
                    interval_offset + op_len
                    > width + len(self._ref_after)
                ):
                    # Deletion starts before the window or spans past
                    # the available reference tail (the reference only
                    # drops alleles whose deleted bases run off the
                    # contig, allelecounter.cc:426-443).
                    continue
                if interval_offset + op_len > width:
                    del_ref = np.concatenate([
                        self.ref[interval_offset:],
                        self._ref_after[
                            : interval_offset + op_len - width
                        ],
                    ])
                else:
                    del_ref = self.ref[
                        interval_offset : interval_offset + op_len
                    ]
                if not _IS_CANONICAL[del_ref].all():
                    continue
                bases = prev + del_ref.tobytes().decode()
                avg_q = int(qual_all[sbase + max(0, read_offset - 1)])
            else:
                atype = INSERTION if op == _OP_I else SOFT_CLIP
                ins = seq_all[
                    sbase + read_offset : sbase + read_offset + op_len
                ]
                insq = qual_all[
                    sbase + read_offset : sbase + read_offset + op_len
                ]
                if not _IS_CANONICAL[ins].all():
                    continue
                qsum = int(insq.sum())
                if self.options.keep_legacy_behavior:
                    if (insq < min_q).any():
                        continue
                elif qsum < min_q * op_len:
                    low_q = True
                bases = prev + ins.tobytes().decode()
                avg_q = qsum // max(1, op_len)
            rec = ReadAlleleRecord(
                read_idx=r,
                bases=bases,
                type=atype,
                is_low_quality=low_q,
                mapping_quality=mapq,
                avg_base_quality=avg_q,
                is_reverse_strand=reverse,
            )
            order = (k << 32)  # indel unit: intra = 0
            events.append((r, anchor_pos, order, rec))
        return events

    def _apply_events(
        self, batch, ev_read, ev_pos, ev_order, ev_kind, ev_payload,
        indel_events,
    ):
        """Merge events per read in cigar order, apply the consecutive-same-
        position dedup rule, then aggregate into position counts."""
        # Indel events override the immediately preceding event at the same
        # position within the same read. Match events never share a position
        # within a read, so the rule reduces to: drop a match event at
        # (read, pos) if that read has an indel event at pos; and for multiple
        # consecutive indel events at the same anchor keep only the last.
        indel_keys = set()
        last_indel: Dict[tuple, tuple] = {}
        for r, pos, order, rec in indel_events:
            key = (r, pos)
            prev_entry = last_indel.get(key)
            if prev_entry is None or order > prev_entry[0]:
                last_indel[key] = (order, rec)
            indel_keys.add(key)

        width = len(self.interval)
        opts = self.options
        # Aggregate match events.
        if len(ev_read):
            # Drop match events superseded by indels (vectorized via
            # packed (read, pos) keys; pos can be -1 for an anchor at
            # the interval edge, hence the +1 shift).
            if indel_keys:
                stride = width + 2
                keys = np.fromiter(
                    (r * stride + p + 1 for r, p in indel_keys),
                    np.int64, len(indel_keys),
                )
                ev_key = (
                    ev_read.astype(np.int64) * stride
                    + ev_pos.astype(np.int64) + 1
                )
                drop = np.isin(ev_key, keys)
                ev_read, ev_pos, ev_kind, ev_payload = (
                    ev_read[~drop], ev_pos[~drop], ev_kind[~drop],
                    ev_payload[~drop],
                )
            is_ref_hq = ev_kind == 0
            self.ref_count += np.bincount(
                ev_pos[is_ref_hq], minlength=width
            ).astype(np.int32)
            if opts.track_ref_reads:
                for r, p in zip(ev_read[is_ref_hq], ev_pos[is_ref_hq]):
                    self._pc(int(p)).ref_supporting_read_ids.append(int(r))
            # Substitutions (incl. low-quality subs, flagged).
            sub_mask = (ev_kind == 1) | (ev_kind == 3)
            sub_r = ev_read[sub_mask].tolist()
            sub_p = ev_pos[sub_mask].tolist()
            sub_k = ev_kind[sub_mask].tolist()
            sub_pl = ev_payload[sub_mask].tolist()
            sub_mapq = batch.mapq[ev_read[sub_mask]].tolist()
            sub_rev = (
                (batch.flag[ev_read[sub_mask]] & 0x10) != 0
            ).tolist()
            for r, p, k, pl, mq, rev in zip(
                sub_r, sub_p, sub_k, sub_pl, sub_mapq, sub_rev
            ):
                rec = ReadAlleleRecord(
                    read_idx=r,
                    bases=chr((pl >> 8) & 0xFF),
                    type=SUBSTITUTION,
                    is_low_quality=k == 3,
                    mapping_quality=mq,
                    avg_base_quality=pl & 0xFF,
                    is_reverse_strand=rev,
                )
                self._pc(p).read_alleles[r] = rec

        for (r, pos), (_, rec) in last_indel.items():
            if 0 <= pos < width:
                self._pc(pos).read_alleles[r] = rec

    def _pc(self, pos: int) -> PositionCount:
        pc = self._positions.get(pos)
        if pc is None:
            pc = PositionCount()
            self._positions[pos] = pc
        return pc

    # -- queries -----------------------------------------------------------------

    def position_count(self, interval_pos: int) -> Optional[PositionCount]:
        return self._positions.get(interval_pos)

    def positions_with_alleles(self) -> List[int]:
        return sorted(self._positions)

    def sum_allele_counts(
        self, interval_pos: int, include_low_quality: bool = False
    ) -> List[Allele]:
        """Distinct alleles at a position with read-support counts
        (allelecounter.h:72 SumAlleleCounts semantics)."""
        pc = self._positions.get(interval_pos)
        if pc is None:
            return []
        agg: Dict[Tuple[str, int], Allele] = {}
        for rid, rec in pc.read_alleles.items():
            if rec.is_low_quality and not include_low_quality:
                continue
            key = (rec.bases, rec.type)
            a = agg.get(key)
            if a is None:
                agg[key] = Allele(rec.bases, rec.type, 1, [rid])
            else:
                a.count += 1
                a.read_ids.append(rid)
        return list(agg.values())

    def total_allele_count(
        self, interval_pos: int, include_low_quality: bool = False
    ) -> int:
        """ref_supporting + non-ref read alleles (allelecounter.h:85)."""
        n = int(self.ref_count[interval_pos])
        pc = self._positions.get(interval_pos)
        if pc is not None:
            for rec in pc.read_alleles.values():
                if include_low_quality or not rec.is_low_quality:
                    n += 1
        return n

    def summary_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ref_supporting, total) per interval position — gVCF input."""
        total = self.ref_count.astype(np.int32).copy()
        for pos, pc in self._positions.items():
            total[pos] += sum(
                1 for rec in pc.read_alleles.values()
                if not rec.is_low_quality
            )
        return self.ref_count, total

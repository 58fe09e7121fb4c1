"""The columnar in-memory ReadBatch.

A copy of the `ReadBatch` class and the SAM flag constants of
`deepvariant_tpu.io.bam`: reads as structure-of-arrays, so the pileup
planners vectorize over reads. Reading BAM files (BGZF, the record
decoder, `.bai` queries) is not part of the port yet; batches are built
with `ReadBatch.from_reads`.

ReadBatch layout (N reads):
  name:            list[str]              read names
  flag:            uint16[N]              SAM flags
  ref_id:          int32[N]               contig index
  pos:             int64[N]               0-based alignment start
  mapq:            uint8[N]
  seq / qual:      uint8[total]           ASCII bases / phred values, packed
  seq_offsets:     int64[N+1]             read i occupies [off[i], off[i+1])
  cigar_ops:       int8[total_ops]        proto op codes (M=1,I=2,D=3,...)
  cigar_lens:      int32[total_ops]
  cigar_offsets:   int64[N+1]
  mate_ref_id/mate_pos/tlen               pairing info
  aux:             list[bytes]            raw aux blobs
  hp:              int8[N]                HP tag (0 = untagged)
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import OPS_CONSUME_REF, Read

# Reference-consuming ops mask by proto op code.
_CONSUMES_REF = np.zeros(10, dtype=bool)
for _op in OPS_CONSUME_REF:
    _CONSUMES_REF[_op] = True

FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_SECOND = 0x80
FLAG_SECONDARY = 0x100
FLAG_QC_FAIL = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800


class ReadBatch:
    """Columnar batch of aligned reads (structure of arrays)."""

    __slots__ = (
        "name", "flag", "ref_id", "pos", "mapq", "seq", "qual",
        "seq_offsets", "cigar_ops", "cigar_lens", "cigar_offsets",
        "mate_ref_id", "mate_pos", "tlen", "aux", "hp", "meth",
        "meth6ma", "tp", "t0", "ref_names",
        # Planner-side per-read walk memo (pileup_device
        # build_region_tensors); lives and dies with the batch.
        "_plan_walk_cache", "_plan_ref_ends",
    )

    def __init__(self, ref_names: Sequence[str]):
        self.ref_names = list(ref_names)
        self.name: List[str] = []
        self.flag = np.empty(0, np.uint16)
        self.ref_id = np.empty(0, np.int32)
        self.pos = np.empty(0, np.int64)
        self.mapq = np.empty(0, np.uint8)
        self.seq = np.empty(0, np.uint8)
        self.qual = np.empty(0, np.uint8)
        self.seq_offsets = np.zeros(1, np.int64)
        self.cigar_ops = np.empty(0, np.int8)
        self.cigar_lens = np.empty(0, np.int32)
        self.cigar_offsets = np.zeros(1, np.int64)
        self.mate_ref_id = np.empty(0, np.int32)
        self.mate_pos = np.empty(0, np.int64)
        self.tlen = np.empty(0, np.int32)
        self.aux: List[bytes] = []
        self.hp = np.empty(0, np.int8)
        # Optional per-read 5mC probabilities (uint8 per base); empty
        # when absent.
        self.meth: List = []
        # Optional per-read 6mA probabilities (uint8 per base).
        self.meth6ma: List = []
        # Optional per-read Ultima tp (int8 per base) / t0 (uint8
        # Q-scores per base) flow tags; empty when absent.
        self.tp: List = []
        self.t0: List = []

    def __len__(self) -> int:
        return len(self.name)

    # -- derived columns -------------------------------------------------------

    def read_lengths(self) -> np.ndarray:
        return np.diff(self.seq_offsets)

    def reference_ends(self) -> np.ndarray:
        """End position on the reference per read (vectorized CIGAR walk)."""
        n = len(self)
        if n == 0:
            return np.empty(0, np.int64)
        consume = _CONSUMES_REF[self.cigar_ops] * self.cigar_lens.astype(
            np.int64
        )
        spans = np.add.reduceat(
            np.concatenate([consume, [0]]),
            self.cigar_offsets[:-1],
        )
        # reduceat with equal consecutive offsets (empty cigar) yields the
        # next element; zero those out.
        empty = np.diff(self.cigar_offsets) == 0
        spans[empty] = 0
        return self.pos + spans

    def seq_of(self, i: int) -> np.ndarray:
        return self.seq[self.seq_offsets[i] : self.seq_offsets[i + 1]]

    def qual_of(self, i: int) -> np.ndarray:
        return self.qual[self.seq_offsets[i] : self.seq_offsets[i + 1]]

    def cigar_of(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.cigar_offsets[i], self.cigar_offsets[i + 1]
        return self.cigar_ops[s:e], self.cigar_lens[s:e]

    def is_reverse(self) -> np.ndarray:
        return (self.flag & FLAG_REVERSE) != 0

    def subset(self, indices: np.ndarray) -> "ReadBatch":
        out = ReadBatch(self.ref_names)
        indices = np.asarray(indices)
        out.name = [self.name[i] for i in indices]
        out.flag = self.flag[indices]
        out.ref_id = self.ref_id[indices]
        out.pos = self.pos[indices]
        out.mapq = self.mapq[indices]
        out.mate_ref_id = self.mate_ref_id[indices]
        out.mate_pos = self.mate_pos[indices]
        out.tlen = self.tlen[indices]
        out.aux = [self.aux[i] for i in indices]
        out.hp = self.hp[indices]
        if self.meth:
            out.meth = [self.meth[i] for i in indices]
        if self.meth6ma:
            out.meth6ma = [self.meth6ma[i] for i in indices]
        if self.tp:
            out.tp = [self.tp[i] for i in indices]
        if self.t0:
            out.t0 = [self.t0[i] for i in indices]
        # Repack variable-length columns with one vectorized gather per
        # column: global index = repeat(old_start) + intra-run arange.
        def _gather(offsets, indices):
            starts = offsets[indices]
            lens = offsets[indices + 1] - starts
            new_off = np.zeros(len(indices) + 1, np.int64)
            np.cumsum(lens, out=new_off[1:])
            total = int(new_off[-1])
            if total == 0:
                return np.empty(0, np.int64), new_off
            intra = np.arange(total, dtype=np.int64) - np.repeat(
                new_off[:-1], lens
            )
            return np.repeat(starts, lens) + intra, new_off

        sel_seq, so = _gather(self.seq_offsets, indices)
        sel_cig, co = _gather(self.cigar_offsets, indices)
        out.seq = self.seq[sel_seq]
        out.qual = self.qual[sel_seq]
        out.seq_offsets = so
        out.cigar_ops = self.cigar_ops[sel_cig]
        out.cigar_lens = self.cigar_lens[sel_cig]
        out.cigar_offsets = co
        return out

    # -- conversion to/from object reads (edges & tests) ------------------------

    def to_reads(self) -> List[Read]:
        # Bulk-convert the columnar data to python scalars once; the
        # per-read loop then only slices bytes and builds tuples (the
        # realigner round-trip makes this a hot path).
        n = len(self)
        seq_bytes = self.seq.tobytes()
        qual_bytes = self.qual.tobytes()
        so = self.seq_offsets.tolist()
        co = self.cigar_offsets.tolist()
        ops_l = self.cigar_ops.tolist()
        lens_l = self.cigar_lens.tolist()
        flags = self.flag.tolist()
        poss = self.pos.tolist()
        mapqs = self.mapq.tolist()
        tlens = self.tlen.tolist()
        ref_ids = self.ref_id.tolist()
        mrefs = self.mate_ref_id.tolist()
        mposs = self.mate_pos.tolist()
        hps = self.hp.tolist() if len(self.hp) else [0] * n
        out = []
        for i in range(n):
            flag = flags[i]
            mate = None
            if flag & FLAG_PAIRED and mrefs[i] >= 0:
                mate = (
                    self.ref_names[mrefs[i]],
                    mposs[i],
                    bool(flag & FLAG_MATE_REVERSE),
                )
            cs, ce = co[i], co[i + 1]
            s, e = so[i], so[i + 1]
            out.append(
                Read(
                    fragment_name=self.name[i],
                    aligned_sequence=seq_bytes[s:e].decode(),
                    aligned_quality=qual_bytes[s:e],
                    reference_name=self.ref_names[ref_ids[i]]
                    if ref_ids[i] >= 0
                    else "",
                    position=poss[i],
                    mapping_quality=mapqs[i],
                    cigar=list(zip(ops_l[cs:ce], lens_l[cs:ce])),
                    reverse_strand=bool(flag & FLAG_REVERSE),
                    # Unpaired fragments are read 0 of 1
                    # (sam_reader.cc:785).
                    read_number=0 if (
                        flag & FLAG_FIRST or not flag & FLAG_PAIRED
                    ) else 1,
                    number_reads=2 if flag & FLAG_PAIRED else 1,
                    fragment_length=tlens[i],
                    proper_placement=bool(flag & FLAG_PROPER_PAIR),
                    duplicate_fragment=bool(flag & FLAG_DUPLICATE),
                    failed_vendor_quality_checks=bool(flag & FLAG_QC_FAIL),
                    secondary_alignment=bool(flag & FLAG_SECONDARY),
                    supplementary_alignment=bool(flag & FLAG_SUPPLEMENTARY),
                    next_mate_position=mate,
                    # Keep the HP phase through Read round-trips so
                    # downstream pileups (e.g. alt-aligned images after
                    # to_reads -> realign -> from_reads) sort by
                    # haplotype exactly like the originals.
                    info={"HP": [hps[i]]} if hps[i] else {},
                )
            )
        return out

    @staticmethod
    def from_reads(reads: Sequence[Read], ref_names: Sequence[str]) -> "ReadBatch":
        name_to_id = {n: i for i, n in enumerate(ref_names)}
        b = ReadBatch(ref_names)
        n = len(reads)
        b.flag = np.zeros(n, np.uint16)
        b.ref_id = np.zeros(n, np.int32)
        b.pos = np.zeros(n, np.int64)
        b.mapq = np.zeros(n, np.uint8)
        b.mate_ref_id = np.full(n, -1, np.int32)
        b.mate_pos = np.full(n, -1, np.int64)
        b.tlen = np.zeros(n, np.int32)
        b.hp = np.zeros(n, np.int8)
        seqs, quals, ops_l, lens_l = [], [], [], []
        flags = np.zeros(n, np.int64)
        so = np.zeros(n + 1, np.int64)
        co = np.zeros(n + 1, np.int64)
        for i, r in enumerate(reads):
            b.name.append(r.fragment_name)
            flag = 0
            if r.number_reads == 2:
                flag |= FLAG_PAIRED | (
                    FLAG_FIRST if r.read_number == 0 else FLAG_SECOND
                )
            if r.proper_placement:
                flag |= FLAG_PROPER_PAIR
            if r.reverse_strand:
                flag |= FLAG_REVERSE
            if r.secondary_alignment:
                flag |= FLAG_SECONDARY
            if r.failed_vendor_quality_checks:
                flag |= FLAG_QC_FAIL
            if r.duplicate_fragment:
                flag |= FLAG_DUPLICATE
            if r.supplementary_alignment:
                flag |= FLAG_SUPPLEMENTARY
            if r.next_mate_position is not None:
                mname, mpos, mrev = r.next_mate_position
                b.mate_ref_id[i] = name_to_id.get(mname, -1)
                b.mate_pos[i] = mpos
                if mrev:
                    flag |= FLAG_MATE_REVERSE
            flags[i] = flag
            b.ref_id[i] = name_to_id.get(r.reference_name, -1)
            b.pos[i] = r.position
            b.mapq[i] = r.mapping_quality
            b.tlen[i] = r.fragment_length
            hp = r.info.get("HP")
            if hp:
                b.hp[i] = int(hp[0])
            seq = r.aligned_sequence
            seqs.append(seq.encode())
            q = bytes(r.aligned_quality)
            if len(q) != len(seq):
                q = b"\x00" * len(seq)
            quals.append(q)
            so[i + 1] = so[i] + len(seq)
            for o, l in r.cigar:
                ops_l.append(o)
                lens_l.append(l)
            co[i + 1] = co[i] + len(r.cigar)
        b.flag = flags.astype(np.uint16)
        # .copy(): frombuffer over bytes is read-only, and batch.qual
        # is written in place by the OQ-substitution path.
        b.seq = np.frombuffer(b"".join(seqs), np.uint8).copy()
        b.qual = np.frombuffer(b"".join(quals), np.uint8).copy()
        b.seq_offsets = so
        b.cigar_ops = np.array(ops_l, np.int8)
        b.cigar_lens = np.array(lens_l, np.int32)
        b.cigar_offsets = co
        b.aux = [b""] * n
        return b

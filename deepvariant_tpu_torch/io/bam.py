"""BAM reader with BAI index queries, producing columnar ReadBatch.

The port's copy of `deepvariant_tpu.io.bam`: a from-scratch
implementation of the public BAM/BAI formats (SAM spec v1, sections
4.2-5.3) on top of the port's BGZF reader. Records are decoded straight
into structure-of-arrays, so allele counting and the pileup planners
vectorize over reads. `BamReader.query` and `iterate` decode records
with the numpy/Python decoder (`_scan_records`); the JAX package's
reader takes a native scanner when its C++ library is built, and both
give the same `ReadBatch`. `apply_original_quality_scores` (OQ),
`parse_methylation` (MM/ML, `io/methylation.py`) and `parse_ultima_tags`
(tp/t0) decode the aux blobs on demand, as the JAX package's do.

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
  aux:             list[bytes]            raw aux blobs, parsed on demand
  hp:              int8[N]                HP tag (0 = untagged)
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import (
    ContigInfo,
    OPS_CONSUME_REF,
    Range,
    Read,
)
from deepvariant_tpu_torch.io.bgzf import BgzfReader

# 4-bit seq code -> ASCII base ('=ACMGRSVTWYHKDBN', SAM spec 4.2).
_SEQ_CODES = b"=ACMGRSVTWYHKDBN"
_HI_LUT = np.empty(256, dtype=np.uint8)
_LO_LUT = np.empty(256, dtype=np.uint8)
for _b in range(256):
    _HI_LUT[_b] = _SEQ_CODES[_b >> 4]
    _LO_LUT[_b] = _SEQ_CODES[_b & 0xF]

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


@dataclasses.dataclass
class ReadRequirements:
    """Read filters (nucleus reads.proto ReadRequirements semantics)."""

    keep_duplicates: bool = False
    keep_failed_vendor_quality_checks: bool = False
    keep_secondary_alignments: bool = False
    keep_supplementary_alignments: bool = False
    # Paired reads whose mapped mate sits on a DIFFERENT contig are
    # "improperly placed" and dropped by default (reads.proto
    # keep_improperly_placed / IsReadProperlyPlaced, nucleus
    # utils.cc:261-266: unpaired, proper-pair-flagged, mate-unmapped,
    # or same-contig-mate reads all pass).
    keep_improperly_placed: bool = False
    min_mapping_quality: int = 0
    min_base_quality: int = 0  # applied downstream, not at read time


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
        # Optional per-read 5mC probabilities (uint8 per base) — filled
        # by BamReader.parse_methylation; None when absent.
        self.meth: List = []
        # Optional per-read 6mA probabilities (uint8 per base).
        self.meth6ma: List = []
        # Optional per-read Ultima tp (int8 per base) / t0 (uint8
        # Q-scores per base) flow tags — filled by
        # BamReader.parse_ultima_tags; None when absent.
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


# ---------------------------------------------------------------------------
# Aux tag parsing
# ---------------------------------------------------------------------------

_AUX_SIZES = {
    ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
    ord("i"): 4, ord("I"): 4, ord("f"): 4,
}
_AUX_FMT = {
    ord("c"): "<b", ord("C"): "<B", ord("s"): "<h", ord("S"): "<H",
    ord("i"): "<i", ord("I"): "<I", ord("f"): "<f",
}


def parse_aux(blob: bytes, wanted: Optional[frozenset] = None) -> Dict[str, object]:
    """Parse a BAM aux blob into {tag: value}. B arrays -> numpy arrays."""
    out: Dict[str, object] = {}
    pos = 0
    n = len(blob)
    while pos + 3 <= n:
        tag = blob[pos : pos + 2].decode("ascii", "replace")
        t = blob[pos + 2]
        pos += 3
        if t in _AUX_FMT:
            val = struct.unpack_from(_AUX_FMT[t], blob, pos)[0]
            pos += _AUX_SIZES[t]
        elif t == ord("A"):
            val = chr(blob[pos])
            pos += 1
        elif t in (ord("Z"), ord("H")):
            end = blob.index(b"\x00", pos)
            val = blob[pos:end].decode("ascii", "replace")
            pos = end + 1
        elif t == ord("B"):
            sub = blob[pos]
            count = struct.unpack_from("<I", blob, pos + 1)[0]
            size = _AUX_SIZES[sub]
            dt = {
                ord("c"): np.int8, ord("C"): np.uint8, ord("s"): np.int16,
                ord("S"): np.uint16, ord("i"): np.int32, ord("I"): np.uint32,
                ord("f"): np.float32,
            }[sub]
            val = np.frombuffer(
                blob[pos + 5 : pos + 5 + count * size], dtype=dt
            ).copy()
            pos += 5 + count * size
        else:
            break  # unknown type: stop parsing this blob
        if wanted is None or tag in wanted:
            out[tag] = val
            if wanted is not None and len(out) == len(wanted):
                break
    return out


# ---------------------------------------------------------------------------
# BAI index
# ---------------------------------------------------------------------------

def _reg2bins(beg: int, end: int) -> List[int]:
    """Bins overlapping [beg, end) (SAM spec section 5.3 binning scheme)."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"not a BAI index: {path}")
        pos = 4
        (n_ref,) = struct.unpack_from("<i", data, pos)
        self.n_ref = n_ref
        pos += 4
        self.bins: List[Dict[int, np.ndarray]] = []
        self.linear: List[np.ndarray] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, pos)
            pos += 4
            bins: Dict[int, np.ndarray] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, pos)
                pos += 8
                chunks = np.frombuffer(
                    data, dtype="<u8", count=2 * n_chunk, offset=pos
                ).reshape(-1, 2)
                pos += 16 * n_chunk
                if bin_id != 37450:  # pseudo-bin with metadata
                    bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, pos)
            pos += 4
            ioffsets = np.frombuffer(data, dtype="<u8", count=n_intv, offset=pos)
            pos += 8 * n_intv
            self.bins.append(bins)
            self.linear.append(ioffsets)

    def chunks_for(self, ref_id: int, beg: int, end: int) -> List[Tuple[int, int]]:
        if ref_id < 0 or ref_id >= len(self.bins):
            return []
        bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        min_offset = 0
        widx = beg >> 14
        if len(linear):
            widx = min(widx, len(linear) - 1)
            min_offset = int(linear[widx])
        chunks = []
        for b in _reg2bins(beg, end):
            arr = bins.get(b)
            if arr is None:
                continue
            for cbeg, cend in arr:
                if cend > min_offset:
                    chunks.append((int(max(cbeg, min_offset)), int(cend)))
        chunks.sort()
        # Merge adjacent/overlapping chunks.
        merged: List[Tuple[int, int]] = []
        for cbeg, cend in chunks:
            if merged and cbeg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((cbeg, cend))
        return merged


# ---------------------------------------------------------------------------
# BAM reader
# ---------------------------------------------------------------------------

class BamHeader:
    def __init__(self, text: str, contigs: List[ContigInfo]):
        self.text = text
        self.contigs = contigs

    def sample_names(self) -> List[str]:
        samples = []
        for line in self.text.splitlines():
            if line.startswith("@RG"):
                for field in line.split("\t"):
                    if field.startswith("SM:"):
                        s = field[3:]
                        if s not in samples:
                            samples.append(s)
        return samples


class BamReader:
    """Indexed BAM reader. `query(range)` returns a ReadBatch."""

    def __init__(
        self,
        path: str,
        requirements: Optional[ReadRequirements] = None,
        downsample_fraction: float = 0.0,
        random_seed: int = 2928130004,
        keep_unmapped: bool = False,
        io_threads: int = 0,
    ):
        self._path = path
        self._bgzf = BgzfReader(path, io_threads=io_threads)
        self.requirements = requirements or ReadRequirements()
        self._downsample = downsample_fraction
        self._rng = np.random.Generator(np.random.Philox(random_seed))
        self._keep_unmapped = keep_unmapped
        self.header = self._read_header()
        self._index: Optional[BaiIndex] = None
        self._header_end_voffset = self._bgzf.virtual_offset

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def ref_names(self) -> List[str]:
        return [c.name for c in self.header.contigs]

    def _read_header(self) -> BamHeader:
        magic = self._bgzf.read_exact(4)
        if magic != b"BAM\x01":
            raise ValueError(f"not a BAM file: {self._path}")
        (l_text,) = struct.unpack("<i", self._bgzf.read_exact(4))
        text = self._bgzf.read_exact(l_text).split(b"\x00")[0].decode()
        (n_ref,) = struct.unpack("<i", self._bgzf.read_exact(4))
        contigs = []
        for i in range(n_ref):
            (l_name,) = struct.unpack("<i", self._bgzf.read_exact(4))
            name = self._bgzf.read_exact(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._bgzf.read_exact(4))
            contigs.append(ContigInfo(name, l_ref, i))
        return BamHeader(text, contigs)

    def _load_index(self) -> BaiIndex:
        if self._index is None:
            import os

            for cand in (self._path + ".bai", self._path[:-4] + ".bai"):
                if os.path.exists(cand):
                    self._index = BaiIndex(cand)
                    break
            else:
                raise FileNotFoundError(f"no .bai index for {self._path}")
        return self._index

    # -- record scan -----------------------------------------------------------

    def _passes_filters(self, flag: int, mapq: int) -> bool:
        req = self.requirements
        if flag & FLAG_UNMAPPED and not self._keep_unmapped:
            return False
        if flag & FLAG_SECONDARY and not req.keep_secondary_alignments:
            return False
        if flag & FLAG_SUPPLEMENTARY and not req.keep_supplementary_alignments:
            return False
        if flag & FLAG_DUPLICATE and not req.keep_duplicates:
            return False
        if flag & FLAG_QC_FAIL and not req.keep_failed_vendor_quality_checks:
            return False
        if mapq < req.min_mapping_quality:
            return False
        return True

    def _drop_flag_mask(self) -> int:
        req = self.requirements
        mask = 0
        if not self._keep_unmapped:
            mask |= FLAG_UNMAPPED
        if not req.keep_secondary_alignments:
            mask |= FLAG_SECONDARY
        if not req.keep_supplementary_alignments:
            mask |= FLAG_SUPPLEMENTARY
        if not req.keep_duplicates:
            mask |= FLAG_DUPLICATE
        if not req.keep_failed_vendor_quality_checks:
            mask |= FLAG_QC_FAIL
        return mask

    def _scan_records(
        self,
        stop_vo: Optional[int],
        ref_id: Optional[int],
        beg: int,
        end: int,
    ) -> ReadBatch:
        """Scan records from the current virtual offset, collecting those
        overlapping [beg, end) on ref_id (or all if ref_id is None)."""
        bgzf = self._bgzf
        batch = ReadBatch(self.ref_names)
        names = batch.name
        flags, refids, poss, mapqs = [], [], [], []
        mrefs, mposs, tlens, hps = [], [], [], []
        seq_parts, qual_parts, ops_parts, lens_parts = [], [], [], []
        seq_off = [0]
        cig_off = [0]
        aux_list = batch.aux
        unpack32 = struct.Struct("<iiiiiiii").unpack_from

        while True:
            if stop_vo is not None and bgzf.virtual_offset >= stop_vo:
                break
            hdr = bgzf.read(4)
            if len(hdr) < 4:
                break
            (block_size,) = struct.unpack("<i", hdr)
            rec = bgzf.read_exact(block_size)
            (
                rid, pos, lrn_mq_bin, flag_nc, l_seq, next_rid, next_pos, tl
            ) = unpack32(rec, 0)
            l_read_name = lrn_mq_bin & 0xFF
            mapq = (lrn_mq_bin >> 8) & 0xFF
            n_cigar = flag_nc & 0xFFFF
            flag = (flag_nc >> 16) & 0xFFFF
            if ref_id is not None:
                if rid != ref_id:
                    if rid > ref_id or rid < 0:
                        break
                    continue
                if pos >= end:
                    break
            if not self._passes_filters(flag, mapq):
                continue
            if (
                not self.requirements.keep_improperly_placed
                and flag & FLAG_PAIRED
                and not flag & FLAG_PROPER_PAIR
                and not flag & FLAG_MATE_UNMAPPED
                and next_rid >= 0
                and next_rid != rid
            ):
                continue
            p = 32
            name = rec[p : p + l_read_name - 1].decode()
            p += l_read_name
            cigar_raw = np.frombuffer(rec, dtype="<u4", count=n_cigar, offset=p)
            p += 4 * n_cigar
            ops = (cigar_raw & 0xF).astype(np.int8)
            lens = (cigar_raw >> 4).astype(np.int32)
            # Remap BAM op codes -> proto codes (+1 shift).
            ops = ops + 1
            if ref_id is not None and n_cigar:
                span = int(lens[_CONSUMES_REF[ops]].sum())
                if pos + span <= beg:
                    continue
            nbytes = (l_seq + 1) // 2
            packed = np.frombuffer(rec, dtype=np.uint8, count=nbytes, offset=p)
            p += nbytes
            seq = np.empty(2 * nbytes, np.uint8)
            seq[0::2] = _HI_LUT[packed]
            seq[1::2] = _LO_LUT[packed]
            seq = seq[:l_seq]
            qual = np.frombuffer(
                rec, dtype=np.uint8, count=l_seq, offset=p
            ).copy()
            p += l_seq
            aux = rec[p:]
            if self._downsample > 0.0 and self._rng.random() >= self._downsample:
                continue
            names.append(name)
            flags.append(flag)
            refids.append(rid)
            poss.append(pos)
            mapqs.append(mapq)
            mrefs.append(next_rid)
            mposs.append(next_pos)
            tlens.append(tl)
            seq_parts.append(seq)
            qual_parts.append(qual)
            seq_off.append(seq_off[-1] + l_seq)
            ops_parts.append(ops)
            lens_parts.append(lens)
            cig_off.append(cig_off[-1] + n_cigar)
            aux_list.append(aux)
            hps.append(0)

        n = len(names)
        batch.flag = np.array(flags, np.uint16)
        batch.ref_id = np.array(refids, np.int32)
        batch.pos = np.array(poss, np.int64)
        batch.mapq = np.array(mapqs, np.uint8)
        batch.mate_ref_id = np.array(mrefs, np.int32)
        batch.mate_pos = np.array(mposs, np.int64)
        batch.tlen = np.array(tlens, np.int32)
        batch.seq = (
            np.concatenate(seq_parts) if seq_parts else np.empty(0, np.uint8)
        )
        batch.qual = (
            np.concatenate(qual_parts) if qual_parts else np.empty(0, np.uint8)
        )
        batch.seq_offsets = np.array(seq_off, np.int64)
        batch.cigar_ops = (
            np.concatenate(ops_parts) if ops_parts else np.empty(0, np.int8)
        )
        batch.cigar_lens = (
            np.concatenate(lens_parts) if lens_parts else np.empty(0, np.int32)
        )
        batch.cigar_offsets = np.array(cig_off, np.int64)
        batch.hp = np.array(hps, np.int8)
        return batch

    def parse_hp_tags(self, batch: ReadBatch) -> None:
        """Fill batch.hp from each read's aux blob (HP haplotype tag)."""
        wanted = frozenset(["HP"])
        for i, blob in enumerate(batch.aux):
            if blob:
                tags = parse_aux(blob, wanted)
                if "HP" in tags:
                    batch.hp[i] = int(tags["HP"])

    def apply_original_quality_scores(self, batch: ReadBatch) -> int:
        """Replace base qualities with the OQ aux tag where present
        (--use_original_quality_scores; nucleus sam_reader.cc OQ
        substitution). Returns the number of reads rewritten."""
        wanted = frozenset(["OQ"])
        n_applied = 0
        so = batch.seq_offsets
        for i, blob in enumerate(batch.aux):
            if not blob:
                continue
            tags = parse_aux(blob, wanted)
            oq = tags.get("OQ")
            if not isinstance(oq, str):
                continue
            quals = np.frombuffer(
                oq.encode("ascii"), np.uint8
            ).astype(np.uint8) - 33
            if len(quals) == so[i + 1] - so[i]:
                batch.qual[so[i] : so[i + 1]] = quals
                n_applied += 1
        return n_applied

    def parse_methylation(self, batch: ReadBatch) -> int:
        """Fill batch.meth (5mC) and batch.meth6ma (6mA) with per-base
        modification probabilities from MM/ML aux tags (nucleus
        sam_reader.cc base-modification parsing).
        Returns the number of reads carrying 5mC methylation."""
        from deepvariant_tpu_torch.io.methylation import (
            base_modification_values,
        )

        wanted = frozenset(["MM", "Mm", "ML", "Ml"])
        batch.meth = [None] * len(batch)
        batch.meth6ma = [None] * len(batch)
        n_meth = 0
        rev = batch.is_reverse()
        for i, blob in enumerate(batch.aux):
            if not blob:
                continue
            tags = parse_aux(blob, wanted)
            if not tags:
                continue
            seq = batch.seq_of(i).tobytes().decode()
            values = base_modification_values(
                seq, tags, bool(rev[i]), "m"
            )
            if values is not None:
                batch.meth[i] = values
                n_meth += 1
            values_6ma = base_modification_values(
                seq, tags, bool(rev[i]), "a"
            )
            if values_6ma is not None:
                batch.meth6ma[i] = values_6ma
        return n_meth

    def parse_ultima_tags(self, batch: ReadBatch) -> int:
        """Fill batch.tp (int8 per base) / batch.t0 (uint8 Q-scores per
        base) from Ultima flow aux tags, feeding the homopolymer
        insertion/deletion quality channels
        (homopolymer_indel_quality_channel.cc GetTPValues,
        inter_homopolymer_insertion_quality_channel.cc GetT0Values).
        Returns the number of reads carrying a tp tag."""
        wanted = frozenset(["tp", "t0"])
        batch.tp = [None] * len(batch)
        batch.t0 = [None] * len(batch)
        n_tp = 0
        for i, blob in enumerate(batch.aux):
            if not blob:
                continue
            tags = parse_aux(blob, wanted)
            if "tp" in tags:
                tp = np.asarray(tags["tp"], np.int8)
                batch.tp[i] = tp
                n_tp += 1
            if "t0" in tags and isinstance(tags["t0"], str):
                # ASCII-encoded phred (char - 33).
                batch.t0[i] = (
                    np.frombuffer(
                        tags["t0"].encode("ascii", "replace"), np.uint8
                    ).astype(np.int16) - 33
                ).clip(0, 255).astype(np.uint8)
        return n_tp

    # -- public API --------------------------------------------------------------

    def query(self, region: Range) -> ReadBatch:
        """All reads overlapping region (via BAI), filtered, as a ReadBatch.

        When the .bai's contig count disagrees with the BAM header
        (stale/mismatched index), falls back to an index-free linear
        scan of the whole file — slower, but correct."""
        try:
            ref_id = self.ref_names.index(region.reference_name)
        except ValueError:
            return ReadBatch(self.ref_names)
        index = self._load_index()
        if index.n_ref != len(self.ref_names):
            self._bgzf.seek_virtual(self._header_end_voffset)
            return self._scan_records(
                None, ref_id, region.start, region.end
            )
        chunks = index.chunks_for(ref_id, region.start, region.end)
        batches = []
        for cbeg, cend in chunks:
            self._bgzf.seek_virtual(cbeg)
            batches.append(self._scan_records(
                cend, ref_id, region.start, region.end
            ))
        if not batches:
            return ReadBatch(self.ref_names)
        if len(batches) == 1:
            return batches[0]
        return _concat_batches(batches)

    def iterate(self) -> ReadBatch:
        """All (filtered) records in the file as one batch."""
        self._bgzf.seek_virtual(self._header_end_voffset)
        return self._scan_records(None, None, 0, 0)


def _concat_batches(batches: List[ReadBatch]) -> ReadBatch:
    out = ReadBatch(batches[0].ref_names)
    for b in batches:
        out.name.extend(b.name)
        out.aux.extend(b.aux)
    out.flag = np.concatenate([b.flag for b in batches])
    out.ref_id = np.concatenate([b.ref_id for b in batches])
    out.pos = np.concatenate([b.pos for b in batches])
    out.mapq = np.concatenate([b.mapq for b in batches])
    out.mate_ref_id = np.concatenate([b.mate_ref_id for b in batches])
    out.mate_pos = np.concatenate([b.mate_pos for b in batches])
    out.tlen = np.concatenate([b.tlen for b in batches])
    out.hp = np.concatenate([b.hp for b in batches])
    out.seq = np.concatenate([b.seq for b in batches])
    out.qual = np.concatenate([b.qual for b in batches])
    out.cigar_ops = np.concatenate([b.cigar_ops for b in batches])
    out.cigar_lens = np.concatenate([b.cigar_lens for b in batches])
    so = [np.zeros(1, np.int64)]
    co = [np.zeros(1, np.int64)]
    seq_total = 0
    cig_total = 0
    for b in batches:
        so.append(b.seq_offsets[1:] + seq_total)
        co.append(b.cigar_offsets[1:] + cig_total)
        seq_total += int(b.seq_offsets[-1])
        cig_total += int(b.cigar_offsets[-1])
    out.seq_offsets = np.concatenate(so)
    out.cigar_offsets = np.concatenate(co)
    return out

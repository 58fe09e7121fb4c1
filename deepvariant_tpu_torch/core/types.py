"""Core genomics data model.

The port's copy of `deepvariant_tpu.core.types`: plain dataclasses for
the control-plane objects (Range, ContigInfo, Variant, VariantCall, Read,
CallVariantsOutput with its DebugInfo) and wire codecs compatible with
the reference's serialized contracts (nucleus variants.proto,
reads.proto, range.proto; deepvariant.proto CallVariantsOutput).
`encode` is byte-identical to the JAX package's, so the candidates and
CVOs either package writes are interchangeable.

The hot path does not use the per-object types: reads flow through the
pipeline as the columnar `ReadBatch` (io/bam.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from deepvariant_tpu_torch.core import protowire as pw

# CIGAR operations (nucleus cigar.proto:34-93 enum values; same codes as
# BAM spec order M=0.. when shifted by one: here we use the proto enum).
CIGAR_ALIGNMENT_MATCH = 1  # M
CIGAR_INSERT = 2  # I
CIGAR_DELETE = 3  # D
CIGAR_SKIP = 4  # N
CIGAR_CLIP_SOFT = 5  # S
CIGAR_CLIP_HARD = 6  # H
CIGAR_PAD = 7  # P
CIGAR_SEQUENCE_MATCH = 8  # =
CIGAR_SEQUENCE_MISMATCH = 9  # X

# BAM op code (0..8, spec order MIDNSHP=X) -> proto enum value.
BAM_OP_TO_PROTO = (1, 2, 3, 4, 5, 6, 7, 8, 9)
PROTO_OP_TO_CHAR = {
    1: "M", 2: "I", 3: "D", 4: "N", 5: "S", 6: "H", 7: "P", 8: "=", 9: "X",
}
CHAR_TO_PROTO_OP = {v: k for k, v in PROTO_OP_TO_CHAR.items()}

# Ops that consume read bases / reference bases (SAM spec).
OPS_CONSUME_READ = frozenset([1, 2, 5, 8, 9])
OPS_CONSUME_REF = frozenset([1, 3, 4, 8, 9])


@dataclasses.dataclass(frozen=True, order=True)
class Range:
    """0-based half-open genomic interval (nucleus range.proto:34-43)."""

    reference_name: str
    start: int
    end: int

    def __len__(self) -> int:
        return max(0, self.end - self.start)

    def overlaps(self, other: "Range") -> bool:
        return (
            self.reference_name == other.reference_name
            and self.start < other.end
            and other.start < self.end
        )

    def contains(self, other: "Range") -> bool:
        return (
            self.reference_name == other.reference_name
            and self.start <= other.start
            and other.end <= self.end
        )

    def to_region_string(self) -> str:
        """1-based inclusive 'chr:start-end' string (samtools convention)."""
        return f"{self.reference_name}:{self.start + 1}-{self.end}"

    @staticmethod
    def from_region_string(text: str) -> "Range":
        if ":" not in text:
            raise ValueError(f"region string without span: {text}")
        name, span = text.rsplit(":", 1)
        lo, _, hi = span.partition("-")
        start = int(lo.replace(",", "")) - 1
        end = int(hi.replace(",", "")) if hi else start + 1
        return Range(name, start, end)

    def encode(self) -> bytes:
        out = []
        if self.reference_name:
            out.append(pw.field_string(1, self.reference_name))
        if self.start:
            out.append(pw.field_varint(2, self.start))
        if self.end:
            out.append(pw.field_varint(3, self.end))
        return b"".join(out)

    @staticmethod
    def decode(buf: bytes) -> "Range":
        name, start, end = "", 0, 0
        for num, _, val in pw.iter_fields(buf):
            if num == 1:
                name = bytes(val).decode()
            elif num == 2:
                start = pw.varint_to_signed64(val)
            elif num == 3:
                end = pw.varint_to_signed64(val)
        return Range(name, start, end)


@dataclasses.dataclass
class ContigInfo:
    """Reference contig metadata (nucleus reference.proto ContigInfo)."""

    name: str
    n_bases: int
    pos_in_fasta: int = 0


# ---------------------------------------------------------------------------
# Info maps: plain dict[str, list] <-> map<string, ListValue> wire format
# (nucleus struct.proto:42-93; Value kinds: number=2, int=7, string=3, bool=4).
# ---------------------------------------------------------------------------

def _encode_value(v) -> bytes:
    if isinstance(v, bool):
        return pw.field_bool(4, v)
    if isinstance(v, int):
        return pw.field_varint(7, v)
    if isinstance(v, float):
        return pw.field_double(2, v)
    if isinstance(v, bytes):
        return pw.field_bytes(3, v)
    if v is None:
        return pw.field_varint(1, 0)
    return pw.field_string(3, str(v))


def _decode_value(buf):
    for num, wt, val in pw.iter_fields(buf):
        if num == 1:
            return None
        if num == 2:
            return pw.decode_fixed64_double(val)
        if num == 7:
            return pw.varint_to_signed64(val)
        if num == 3:
            raw = bytes(val)
            try:
                return raw.decode("utf-8")
            except UnicodeDecodeError:
                return raw
        if num == 4:
            return bool(val)
        if num == 6:
            return _decode_list_value(val)
    return None


def _encode_list_value(values: Sequence) -> bytes:
    return b"".join(pw.field_message(1, _encode_value(v)) for v in values)


def _decode_list_value(buf) -> List:
    return [_decode_value(val) for num, _, val in pw.iter_fields(buf) if num == 1]


def encode_info_map(field_number: int, info: Dict[str, List]) -> bytes:
    out = []
    for key, values in info.items():
        entry = pw.field_string(1, key) + pw.field_message(
            2, _encode_list_value(values)
        )
        out.append(pw.field_message(field_number, entry))
    return b"".join(out)


def decode_info_entry(buf) -> tuple:
    key, values = "", []
    for num, _, val in pw.iter_fields(buf):
        if num == 1:
            key = bytes(val).decode()
        elif num == 2:
            values = _decode_list_value(val)
    return key, values


# ---------------------------------------------------------------------------
# VariantCall / Variant (nucleus variants.proto:52-170)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VariantCall:
    call_set_name: str = ""
    genotype: List[int] = dataclasses.field(default_factory=list)
    genotype_likelihood: List[float] = dataclasses.field(default_factory=list)
    is_phased: bool = False
    phaseset: str = ""
    info: Dict[str, List] = dataclasses.field(default_factory=dict)

    def encode(self) -> bytes:
        out = []
        if self.info:
            out.append(encode_info_map(2, self.info))
        if self.phaseset:
            out.append(pw.field_string(5, self.phaseset))
        if self.genotype_likelihood:
            out.append(pw.packed_doubles(6, self.genotype_likelihood))
        if self.genotype:
            out.append(pw.packed_varints(7, [g & ((1 << 64) - 1) if g < 0 else g
                                             for g in self.genotype]))
        if self.call_set_name:
            out.append(pw.field_string(9, self.call_set_name))
        if self.is_phased:
            out.append(pw.field_bool(10, self.is_phased))
        return b"".join(out)

    @staticmethod
    def decode(buf) -> "VariantCall":
        call = VariantCall()
        for num, wt, val in pw.iter_fields(buf):
            if num == 2:
                k, v = decode_info_entry(val)
                call.info[k] = v
            elif num == 5:
                call.phaseset = bytes(val).decode()
            elif num == 6:
                if wt == pw.WIRETYPE_LEN:
                    call.genotype_likelihood.extend(
                        pw.decode_packed_doubles(val))
                else:
                    call.genotype_likelihood.append(
                        pw.decode_fixed64_double(val))
            elif num == 7:
                if wt == pw.WIRETYPE_LEN:
                    call.genotype.extend(
                        _varint32(v) for v in pw.decode_packed_varints(val))
                else:
                    call.genotype.append(_varint32(val))
            elif num == 9:
                call.call_set_name = bytes(val).decode()
            elif num == 10:
                call.is_phased = bool(val)
        return call


def _varint32(v: int) -> int:
    """Interpret an unsigned varint as int32 (handles -1 genotypes)."""
    v &= 0xFFFFFFFFFFFFFFFF
    if v >= 1 << 63:
        v -= 1 << 64
    if -(1 << 31) <= v < (1 << 31):
        return int(v)
    return int(v - (1 << 32)) if v >= (1 << 31) else int(v)


@dataclasses.dataclass
class Variant:
    """A variant record (nucleus variants.proto:52-112)."""

    reference_name: str = ""
    start: int = 0
    end: int = 0
    reference_bases: str = ""
    alternate_bases: List[str] = dataclasses.field(default_factory=list)
    names: List[str] = dataclasses.field(default_factory=list)
    filter: List[str] = dataclasses.field(default_factory=list)
    quality: float = 0.0
    info: Dict[str, List] = dataclasses.field(default_factory=dict)
    calls: List[VariantCall] = dataclasses.field(default_factory=list)
    id: str = ""

    @property
    def range(self) -> Range:
        return Range(self.reference_name, self.start, self.end)

    def is_snp(self) -> bool:
        return len(self.reference_bases) == 1 and all(
            len(a) == 1 for a in self.alternate_bases
        ) and bool(self.alternate_bases)

    def encode(self) -> bytes:
        out = []
        if self.id:
            out.append(pw.field_string(2, self.id))
        for n in self.names:
            out.append(pw.field_string(3, n))
        if self.reference_bases:
            out.append(pw.field_string(6, self.reference_bases))
        for a in self.alternate_bases:
            out.append(pw.field_string(7, a))
        if self.quality:
            out.append(pw.field_double(8, self.quality))
        for f in self.filter:
            out.append(pw.field_string(9, f))
        if self.info:
            out.append(encode_info_map(10, self.info))
        for c in self.calls:
            out.append(pw.field_message(11, c.encode()))
        if self.end:
            out.append(pw.field_varint(13, self.end))
        if self.reference_name:
            out.append(pw.field_string(14, self.reference_name))
        if self.start:
            out.append(pw.field_varint(16, self.start))
        return b"".join(out)

    @staticmethod
    def decode(buf) -> "Variant":
        v = Variant()
        for num, wt, val in pw.iter_fields(buf):
            if num == 2:
                v.id = bytes(val).decode()
            elif num == 3:
                v.names.append(bytes(val).decode())
            elif num == 6:
                v.reference_bases = bytes(val).decode()
            elif num == 7:
                v.alternate_bases.append(bytes(val).decode())
            elif num == 8:
                v.quality = pw.decode_fixed64_double(val)
            elif num == 9:
                v.filter.append(bytes(val).decode())
            elif num == 10:
                k, vals = decode_info_entry(val)
                v.info[k] = vals
            elif num == 11:
                v.calls.append(VariantCall.decode(val))
            elif num == 13:
                v.end = pw.varint_to_signed64(val)
            elif num == 14:
                v.reference_name = bytes(val).decode()
            elif num == 16:
                v.start = pw.varint_to_signed64(val)
        return v


# ---------------------------------------------------------------------------
# Read (nucleus reads.proto:140-238) — object form, used at the edges only.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Read:
    fragment_name: str = ""
    aligned_sequence: str = ""
    aligned_quality: bytes = b""
    reference_name: str = ""
    position: int = 0  # 0-based alignment start
    mapping_quality: int = 0
    cigar: List[tuple] = dataclasses.field(default_factory=list)  # (op, len)
    reverse_strand: bool = False
    read_number: int = 0
    number_reads: int = 0
    fragment_length: int = 0
    proper_placement: bool = False
    duplicate_fragment: bool = False
    failed_vendor_quality_checks: bool = False
    secondary_alignment: bool = False
    supplementary_alignment: bool = False
    next_mate_position: Optional[tuple] = None  # (ref_name, pos, reverse)
    read_group: str = ""
    info: Dict[str, List] = dataclasses.field(default_factory=dict)

    def end(self) -> int:
        """Reference end of the alignment (exclusive)."""
        span = sum(l for op, l in self.cigar if op in OPS_CONSUME_REF)
        return self.position + span

    def cigar_string(self) -> str:
        return "".join(f"{l}{PROTO_OP_TO_CHAR[op]}" for op, l in self.cigar)

    def encode(self) -> bytes:
        """nucleus Read proto wire format (reads.proto:140-238)."""
        out = []
        if self.fragment_name:
            out.append(pw.field_string(4, self.fragment_name))
        if self.proper_placement:
            out.append(pw.field_bool(5, True))
        if self.duplicate_fragment:
            out.append(pw.field_bool(6, True))
        if self.fragment_length:
            out.append(pw.field_varint(7, self.fragment_length
                                       & 0xFFFFFFFFFFFFFFFF
                                       if self.fragment_length < 0
                                       else self.fragment_length))
        if self.read_number:
            out.append(pw.field_varint(8, self.read_number))
        if self.number_reads:
            out.append(pw.field_varint(9, self.number_reads))
        if self.failed_vendor_quality_checks:
            out.append(pw.field_bool(10, True))
        aln = []
        pos = []
        if self.reference_name:
            pos.append(pw.field_string(1, self.reference_name))
        if self.position:
            pos.append(pw.field_varint(2, self.position))
        if self.reverse_strand:
            pos.append(pw.field_bool(3, True))
        aln.append(pw.field_message(1, b"".join(pos)))
        if self.mapping_quality:
            aln.append(pw.field_varint(2, self.mapping_quality))
        for op, length in self.cigar:
            unit = pw.field_varint(1, op) + pw.field_varint(2, length)
            aln.append(pw.field_message(3, unit))
        out.append(pw.field_message(11, b"".join(aln)))
        if self.secondary_alignment:
            out.append(pw.field_bool(12, True))
        if self.supplementary_alignment:
            out.append(pw.field_bool(13, True))
        if self.aligned_sequence:
            out.append(pw.field_string(14, self.aligned_sequence))
        if self.aligned_quality:
            out.append(pw.field_bytes(15, bytes(self.aligned_quality)))
        if self.next_mate_position is not None:
            name, p, rev = self.next_mate_position
            mate = pw.field_string(1, name) + pw.field_varint(2, p)
            if rev:
                mate += pw.field_bool(3, True)
            out.append(pw.field_message(16, mate))
        if self.info:
            out.append(encode_info_map(17, self.info))
        return b"".join(out)

    @staticmethod
    def decode(buf) -> "Read":
        r = Read()
        for num, wt, val in pw.iter_fields(buf):
            if num == 4:
                r.fragment_name = bytes(val).decode()
            elif num == 5:
                r.proper_placement = bool(val)
            elif num == 6:
                r.duplicate_fragment = bool(val)
            elif num == 7:
                r.fragment_length = _varint32(val)
            elif num == 8:
                r.read_number = _varint32(val)
            elif num == 9:
                r.number_reads = _varint32(val)
            elif num == 10:
                r.failed_vendor_quality_checks = bool(val)
            elif num == 11:
                for anum, _, aval in pw.iter_fields(val):
                    if anum == 1:
                        for pnum, _, pval in pw.iter_fields(aval):
                            if pnum == 1:
                                r.reference_name = bytes(pval).decode()
                            elif pnum == 2:
                                r.position = pw.varint_to_signed64(pval)
                            elif pnum == 3:
                                r.reverse_strand = bool(pval)
                    elif anum == 2:
                        r.mapping_quality = _varint32(aval)
                    elif anum == 3:
                        op, length = 0, 0
                        for cnum, _, cval in pw.iter_fields(aval):
                            if cnum == 1:
                                op = cval
                            elif cnum == 2:
                                length = pw.varint_to_signed64(cval)
                        r.cigar.append((op, length))
            elif num == 12:
                r.secondary_alignment = bool(val)
            elif num == 13:
                r.supplementary_alignment = bool(val)
            elif num == 14:
                r.aligned_sequence = bytes(val).decode()
            elif num == 15:
                r.aligned_quality = bytes(val)
            elif num == 16:
                name, p, rev = "", 0, False
                for pnum, _, pval in pw.iter_fields(val):
                    if pnum == 1:
                        name = bytes(pval).decode()
                    elif pnum == 2:
                        p = pw.varint_to_signed64(pval)
                    elif pnum == 3:
                        rev = bool(pval)
                r.next_mate_position = (name, p, rev)
            elif num == 17:
                k, v = decode_info_entry(val)
                r.info[k] = v
        return r


# ---------------------------------------------------------------------------
# CallVariantsOutput (deepvariant.proto:363-401)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CvoDebugInfo:
    """CallVariantsOutput.DebugInfo (deepvariant.proto:376-399),
    emitted under --include_debug_info."""

    predicted_label: int = 0
    has_insertion: bool = False
    has_deletion: bool = False
    is_snp: bool = False
    true_label: int = 0
    logits: List[float] = dataclasses.field(default_factory=list)

    def encode(self) -> bytes:
        out = []
        if self.predicted_label:
            out.append(pw.field_varint(1, self.predicted_label))
        if self.has_insertion:
            out.append(pw.field_varint(2, 1))
        if self.has_deletion:
            out.append(pw.field_varint(3, 1))
        if self.is_snp:
            out.append(pw.field_varint(4, 1))
        if self.true_label:
            out.append(pw.field_varint(5, self.true_label))
        if self.logits:
            out.append(pw.packed_doubles(6, self.logits))
        return b"".join(out)

    @staticmethod
    def decode(buf) -> "CvoDebugInfo":
        d = CvoDebugInfo()
        for num, wt, val in pw.iter_fields(buf):
            if num == 1:
                d.predicted_label = val
            elif num == 2:
                d.has_insertion = bool(val)
            elif num == 3:
                d.has_deletion = bool(val)
            elif num == 4:
                d.is_snp = bool(val)
            elif num == 5:
                d.true_label = val
            elif num == 6:
                if wt == pw.WIRETYPE_LEN:
                    d.logits.extend(pw.decode_packed_doubles(val))
                else:
                    d.logits.append(pw.decode_fixed64_double(val))
        return d


@dataclasses.dataclass
class CallVariantsOutput:
    variant: Variant
    alt_allele_indices: List[int]
    genotype_probabilities: List[float]
    debug_info: Optional["CvoDebugInfo"] = None

    def encode(self) -> bytes:
        out = [pw.field_message(1, self.variant.encode())]
        out.append(
            pw.field_message(2, pw.packed_varints(1, self.alt_allele_indices))
            if self.alt_allele_indices
            else pw.field_message(2, b"")
        )
        if self.genotype_probabilities:
            out.append(pw.packed_doubles(3, self.genotype_probabilities))
        if self.debug_info is not None:
            out.append(pw.field_message(4, self.debug_info.encode()))
        return b"".join(out)

    @staticmethod
    def decode(buf) -> "CallVariantsOutput":
        variant = Variant()
        indices: List[int] = []
        probs: List[float] = []
        debug = None
        for num, wt, val in pw.iter_fields(buf):
            if num == 1:
                variant = Variant.decode(val)
            elif num == 2:
                for inum, iwt, ival in pw.iter_fields(val):
                    if inum == 1:
                        if iwt == pw.WIRETYPE_LEN:
                            indices.extend(pw.decode_packed_varints(ival))
                        else:
                            indices.append(ival)
            elif num == 3:
                if wt == pw.WIRETYPE_LEN:
                    probs.extend(pw.decode_packed_doubles(val))
                else:
                    probs.append(pw.decode_fixed64_double(val))
            elif num == 4:
                debug = CvoDebugInfo.decode(val)
        return CallVariantsOutput(variant, indices, probs, debug)

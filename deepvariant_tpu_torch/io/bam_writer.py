"""BAM writer (nucleus sam_writer.{h,cc} equivalent).

Writes a ReadBatch (or Read objects) as a valid BGZF-compressed BAM:
header block (magic, SAM text, reference dictionary) followed by
per-read alignment records — the exact inverse of BamReader's decoder
(io/bam.py:530-640). Output is readable by samtools/htslib and by our
own BamReader.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np

from deepvariant_tpu_torch.core.types import ContigInfo, Read
from deepvariant_tpu_torch.io.bam import ReadBatch
from deepvariant_tpu_torch.io.bgzf import BgzfWriter

_BASE_TO_NIBBLE = np.zeros(256, np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _BASE_TO_NIBBLE[_b] = _i
# Lowercase too.
for _i, _b in enumerate(b"=acmgrsvtwyhkdbn"):
    _BASE_TO_NIBBLE[_b] = _i

# proto op code (1-9) -> BAM op code (0-8)
_PROTO_TO_BAM_OP = {i: i - 1 for i in range(1, 10)}


class BamWriter:
    """Writes reads to a BAM file (BGZF + BAM record layout)."""

    def __init__(self, path: str, contigs: Sequence[ContigInfo],
                 sample_name: str = "", extra_header_text: str = ""):
        self._contigs = list(contigs)
        self._name_to_id = {c.name: i for i, c in enumerate(contigs)}
        self._bgzf = BgzfWriter(path)
        header_text = "@HD\tVN:1.6\tSO:coordinate\n"
        for c in contigs:
            header_text += f"@SQ\tSN:{c.name}\tLN:{c.n_bases}\n"
        if sample_name:
            header_text += f"@RG\tID:rg1\tSM:{sample_name}\n"
        header_text += extra_header_text
        text = header_text.encode()
        out = b"BAM\x01" + struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(contigs))
        for c in contigs:
            name = c.name.encode() + b"\x00"
            out += struct.pack("<i", len(name)) + name
            out += struct.pack("<i", c.n_bases)
        self._bgzf.write(out)

    def write_read(self, read: Read):
        ref_id = self._name_to_id.get(read.reference_name, -1)
        mate_ref_id = -1
        mate_pos = -1
        if read.next_mate_position is not None:
            mate_ref_id = self._name_to_id.get(
                read.next_mate_position[0], -1
            )
            mate_pos = int(read.next_mate_position[1])
        flag = 0
        if read.number_reads == 2:
            flag |= 0x1 | 0x40 if read.read_number == 0 else 0x1 | 0x80
        if read.reverse_strand:
            flag |= 0x10
        if read.secondary_alignment:
            flag |= 0x100
        if read.supplementary_alignment:
            flag |= 0x800
        if read.duplicate_fragment:
            flag |= 0x400
        if read.failed_vendor_quality_checks:
            flag |= 0x200
        self._write_record(
            name=read.fragment_name,
            flag=flag,
            ref_id=ref_id,
            pos=read.position,
            mapq=read.mapping_quality,
            cigar=[(op, length) for op, length in read.cigar],
            seq=read.aligned_sequence,
            qual=read.aligned_quality,
            mate_ref_id=mate_ref_id,
            mate_pos=mate_pos,
            tlen=read.fragment_length,
            aux=getattr(read, "aux", b"") or b"",
        )

    def write_batch(self, batch: ReadBatch):
        for i in range(len(batch)):
            mate_ref = int(batch.mate_ref_id[i])
            self._write_record(
                name=batch.name[i],
                flag=int(batch.flag[i]),
                ref_id=int(batch.ref_id[i]),
                pos=int(batch.pos[i]),
                mapq=int(batch.mapq[i]),
                cigar=list(zip(
                    batch.cigar_ops[
                        batch.cigar_offsets[i]:batch.cigar_offsets[i + 1]
                    ].tolist(),
                    batch.cigar_lens[
                        batch.cigar_offsets[i]:batch.cigar_offsets[i + 1]
                    ].tolist(),
                )),
                seq=batch.seq_of(i).tobytes().decode(),
                qual=bytes(batch.qual_of(i)),
                mate_ref_id=mate_ref,
                mate_pos=int(batch.mate_pos[i]),
                tlen=int(batch.tlen[i]),
                aux=batch.aux[i] if i < len(batch.aux) else b"",
            )

    def _write_record(self, name, flag, ref_id, pos, mapq, cigar, seq,
                      qual, mate_ref_id, mate_pos, tlen, aux=b""):
        name_b = name.encode() + b"\x00"
        l_seq = len(seq)
        n_cigar = len(cigar)
        # bin: use reg2bin of [pos, end)
        end = pos + sum(
            l for op, l in cigar if op in (1, 3, 4, 8, 9)
        ) or pos + 1
        bam_bin = _reg2bin(pos, end)
        rec = struct.pack(
            "<iiBBHHHiiii",
            ref_id, pos,
            len(name_b), mapq, bam_bin,
            n_cigar, flag,
            l_seq, mate_ref_id, mate_pos, tlen,
        )
        rec += name_b
        for op, length in cigar:
            rec += struct.pack(
                "<I", (length << 4) | _PROTO_TO_BAM_OP.get(op, 0)
            )
        seq_arr = np.frombuffer(seq.encode(), np.uint8)
        nibbles = _BASE_TO_NIBBLE[seq_arr]
        packed = np.zeros((l_seq + 1) // 2, np.uint8)
        packed |= nibbles[0::2] << 4
        if l_seq > 1:
            packed[: len(nibbles[1::2])] |= nibbles[1::2]
        rec += packed.tobytes()
        if isinstance(qual, bytes):
            rec += qual
        else:
            rec += bytes(qual)
        rec += aux
        self._bgzf.write(struct.pack("<i", len(rec)) + rec)

    def close(self):
        self._bgzf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _reg2bin(beg: int, end: int) -> int:
    """UCSC binning (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def build_bam_index(bam_path: str, output_path: str = "") -> str:
    """Build a .bai index for a BAM (SAM spec section 5: R-tree bins
    over BGZF virtual offsets + 16 kb linear index) — the equivalent
    of `samtools index` for BamWriter output."""
    import struct

    from deepvariant_tpu_torch.io.bgzf import BgzfReader

    output_path = output_path or bam_path + ".bai"
    f = BgzfReader(bam_path)
    magic = f.read(4)
    if magic != b"BAM\x01":
        raise ValueError(f"not a BAM: {bam_path}")
    (l_text,) = struct.unpack("<i", f.read_exact(4))
    f.read_exact(l_text)
    (n_ref,) = struct.unpack("<i", f.read_exact(4))
    for _ in range(n_ref):
        (l_name,) = struct.unpack("<i", f.read_exact(4))
        f.read_exact(l_name + 4)

    # Per ref: {bin: [(vbeg, vend), ...]}, linear window -> min voffset.
    bins = [dict() for _ in range(n_ref)]
    linear = [dict() for _ in range(n_ref)]
    while True:
        vbeg = f.virtual_offset
        hdr = f.read(4)
        if len(hdr) < 4:
            break
        (block_size,) = struct.unpack("<i", hdr)
        rec = f.read_exact(block_size)
        vend = f.virtual_offset
        rid, pos = struct.unpack_from("<ii", rec, 0)
        if rid < 0 or pos < 0:
            continue
        flag_nc = struct.unpack_from("<i", rec, 12)[0]
        n_cigar = flag_nc & 0xFFFF
        l_read_name = struct.unpack_from("<i", rec, 8)[0] & 0xFF
        cigar = struct.unpack_from(
            f"<{n_cigar}I", rec, 32 + l_read_name
        )
        span = sum(
            (c >> 4) for c in cigar if (c & 0xF) in (0, 2, 3, 7, 8)
        ) or 1
        end = pos + span
        b = _reg2bin(pos, end)
        chunks = bins[rid].setdefault(b, [])
        if chunks and chunks[-1][1] == vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        for w in range(pos >> 14, ((end - 1) >> 14) + 1):
            if w not in linear[rid] or vbeg < linear[rid][w]:
                linear[rid][w] = vbeg
    f.close()

    with open(output_path, "wb") as out:
        out.write(b"BAI\x01")
        out.write(struct.pack("<i", n_ref))
        for rid in range(n_ref):
            out.write(struct.pack("<i", len(bins[rid])))
            for b in sorted(bins[rid]):
                chunks = bins[rid][b]
                out.write(struct.pack("<Ii", b, len(chunks)))
                for vbeg, vend in chunks:
                    out.write(struct.pack("<QQ", vbeg, vend))
            if linear[rid]:
                n_intv = max(linear[rid]) + 1
                # Fill gaps with the previous window's offset.
                vals = []
                prev = 0
                for w in range(n_intv):
                    prev = linear[rid].get(w, prev)
                    vals.append(prev)
            else:
                n_intv = 0
                vals = []
            out.write(struct.pack("<i", n_intv))
            for v in vals:
                out.write(struct.pack("<Q", v))
    return output_path

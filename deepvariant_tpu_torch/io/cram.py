"""CRAM 3.0 reader.

The port's copy of `deepvariant_tpu.io.cram`, the equivalent of
nucleus's htslib-backed CRAM reading (third_party/nucleus/io/
sam_reader.cc) for the container format of hts-specs CRAMv3: file
definition, containers, compression headers, slices, and full record
decoding. Read features are applied against the reference (an embedded
reference block or the `--ref` FASTA) to rebuild sequences and CIGARs.

Codecs: raw, gzip, bzip2, lzma (stdlib) and rANS 4x8 order-0/order-1
(decoded in Python; the JAX package tries its native library first and
gives the same bytes). Encodings: EXTERNAL, HUFFMAN (canonical code
lengths), BETA, GAMMA, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP.

`CramReader` yields core.types.Read objects, as the JAX package's does.
`CramBatchReader` serves ReadBatches with BamReader's interface and
gives what the BAM of the same reads gives, where the JAX package's
CRAM route does not (ROADMAP.md Queue 3):

- `downsample_fraction` draws one number per kept read in query order
  from BamReader's generator; the JAX reader is never given it;
- each batch carries the records' BAM flags and their tags rebuilt as
  BAM aux blobs, so `apply_original_quality_scores` (OQ),
  `parse_ultima_tags` (tp/t0), `parse_hp_tags` and `parse_methylation`
  are BamReader's own and decode on demand; the JAX reader has no OQ
  substitution, returns no tp/t0, and fills HP and MM/ML eagerly;
- `header` holds the @SQ contigs and the @RG samples, so the runner
  takes the sample name from the CRAM and checks its contigs as it does
  a BAM's.

The whole file is decoded at the first query (ROADMAP.md "Host speed").
"""

from __future__ import annotations

import bz2
import dataclasses
import lzma
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import ContigInfo, Range, Read
from deepvariant_tpu_torch.io.bam import (
    FLAG_MATE_UNMAPPED,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    BamHeader,
    BamReader,
    ReadBatch,
    ReadRequirements,
)

CRAM_MAGIC = b"CRAM"

# Block compression methods (spec section 8).
_RAW, _GZIP, _BZIP2, _LZMA, _RANS4x8 = 0, 1, 2, 3, 4
# Block content types.
_CT_FILE_HEADER = 0
_CT_COMPRESSION_HEADER = 1
_CT_SLICE_HEADER = 2
_CT_EXTERNAL = 4
_CT_CORE = 5

_BAM_CIGAR_OPS = "MIDNSHP=X"
# nucleus CigarUnit enum values (core/cigar.py convention).
_M, _I, _D, _N, _S, _H, _P, _EQ, _X = 1, 2, 3, 4, 5, 6, 7, 8, 9


# ---------------------------------------------------------------------------
# Varints
# ---------------------------------------------------------------------------

def read_itf8(buf: bytes, pos: int) -> Tuple[int, int]:
    b0 = buf[pos]
    if b0 < 0x80:
        return b0, pos + 1
    if b0 < 0xC0:
        return ((b0 & 0x7F) << 8) | buf[pos + 1], pos + 2
    if b0 < 0xE0:
        return (
            ((b0 & 0x3F) << 16) | (buf[pos + 1] << 8) | buf[pos + 2],
            pos + 3,
        )
    if b0 < 0xF0:
        return (
            ((b0 & 0x1F) << 24) | (buf[pos + 1] << 16)
            | (buf[pos + 2] << 8) | buf[pos + 3],
            pos + 4,
        )
    val = (
        ((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) | (buf[pos + 2] << 12)
        | (buf[pos + 3] << 4) | (buf[pos + 4] & 0x0F)
    )
    # itf8 carries signed 32-bit values (two's complement).
    if val >= 1 << 31:
        val -= 1 << 32
    return val, pos + 5


def read_ltf8(buf: bytes, pos: int) -> Tuple[int, int]:
    b0 = buf[pos]
    n_extra = 0
    for i in range(8):
        if b0 & (0x80 >> i):
            n_extra += 1
        else:
            break
    if n_extra == 0:
        return b0, pos + 1
    val = b0 & ((1 << (7 - n_extra)) - 1) if n_extra < 7 else 0
    for i in range(n_extra):
        val = (val << 8) | buf[pos + 1 + i]
    return val, pos + 1 + n_extra


# ---------------------------------------------------------------------------
# rANS 4x8 (spec section 13; order-0 and order-1)
# ---------------------------------------------------------------------------

_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT
_RANS_LOW = 1 << 23


def _read_freqs0(buf: bytes, pos: int):
    """Order-0 frequency table -> (freq[256], cumulative[257], pos)."""
    freq = np.zeros(256, np.int64)
    sym = buf[pos]
    pos += 1
    last = sym
    rle = 0
    while True:
        f, pos = read_itf8(buf, pos)
        freq[sym] = f
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            sym = buf[pos]
            pos += 1
            if sym == last + 1:
                rle = buf[pos]
                pos += 1
            last = sym
        if sym == 0 and rle == 0:
            break
    cum = np.zeros(257, np.int64)
    np.cumsum(freq, out=cum[1:])
    return freq, cum, pos


def _rans_decode_0(buf: bytes, out_size: int) -> bytes:
    freq, cum, pos = _read_freqs0(buf, 0)
    # 12-bit slot -> symbol lookup.
    lookup = np.zeros(_TOTFREQ, np.uint8)
    for s in np.nonzero(freq)[0]:
        lookup[cum[s] : cum[s + 1]] = s
    data = np.frombuffer(buf, np.uint8)
    states = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = np.empty(out_size, np.uint8)
    n = len(buf)
    for i in range(out_size):
        j = i & 3
        x = states[j]
        slot = x & (_TOTFREQ - 1)
        s = int(lookup[slot])
        out[i] = s
        x = int(freq[s]) * (x >> _TF_SHIFT) + slot - int(cum[s])
        while x < _RANS_LOW and pos < n:
            x = (x << 8) | int(data[pos])
            pos += 1
        states[j] = x
    return out.tobytes()


def _rans_decode_1(buf: bytes, out_size: int) -> bytes:
    # Order-1: context-conditioned tables, outer RLE over contexts.
    pos = 0
    freq = np.zeros((256, 256), np.int64)
    cum = np.zeros((256, 257), np.int64)
    ctx = buf[pos]
    pos += 1
    last_ctx = ctx
    rle_ctx = 0
    while True:
        f, c, pos = _read_freqs0(buf, pos)
        freq[ctx] = f
        np.cumsum(f, out=cum[ctx][1:])
        if rle_ctx > 0:
            rle_ctx -= 1
            ctx += 1
        else:
            ctx = buf[pos]
            pos += 1
            if ctx == last_ctx + 1:
                rle_ctx = buf[pos]
                pos += 1
            last_ctx = ctx
        if ctx == 0 and rle_ctx == 0:
            break
    lookup = np.zeros((256, _TOTFREQ), np.uint8)
    for c in range(256):
        fz = np.nonzero(freq[c])[0]
        for s in fz:
            lookup[c, cum[c, s] : cum[c, s + 1]] = s
    data = np.frombuffer(buf, np.uint8)
    states = list(struct.unpack_from("<4I", buf, pos))
    pos += 16
    out = np.empty(out_size, np.uint8)
    n = len(buf)
    q = out_size >> 2
    starts = [0, q, 2 * q, 3 * q]
    ends = [q, 2 * q, 3 * q, out_size]
    ctxs = [0, 0, 0, 0]
    idx = list(starts)
    # Interleaved: step all 4 states in lockstep over their quarters.
    for step in range(q):
        for j in range(4):
            i = idx[j]
            if i >= ends[j]:
                continue
            x = states[j]
            c = ctxs[j]
            slot = x & (_TOTFREQ - 1)
            s = int(lookup[c, slot])
            out[i] = s
            x = int(freq[c, s]) * (x >> _TF_SHIFT) + slot - int(cum[c, s])
            while x < _RANS_LOW and pos < n:
                x = (x << 8) | int(data[pos])
                pos += 1
            states[j] = x
            ctxs[j] = s
            idx[j] = i + 1
    # Tail of the 4th quarter (out_size not divisible by 4).
    j = 3
    while idx[j] < ends[j]:
        i = idx[j]
        x = states[j]
        c = ctxs[j]
        slot = x & (_TOTFREQ - 1)
        s = int(lookup[c, slot])
        out[i] = s
        x = int(freq[c, s]) * (x >> _TF_SHIFT) + slot - int(cum[c, s])
        while x < _RANS_LOW and pos < n:
            x = (x << 8) | int(data[pos])
            pos += 1
        states[j] = x
        ctxs[j] = s
        idx[j] = i + 1
    return out.tobytes()


def rans_decode(buf: bytes) -> bytes:
    order = buf[0]
    (comp_size, out_size) = struct.unpack_from("<II", buf, 1)
    payload = buf[9 : 9 + comp_size]
    if out_size == 0:
        return b""
    if order == 0:
        return _rans_decode_0(payload, out_size)
    if order == 1:
        return _rans_decode_1(payload, out_size)
    raise ValueError(f"unsupported rANS order {order}")


def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == _RAW:
        return data
    if method == _GZIP:
        return zlib.decompress(data, 15 + 32)
    if method == _BZIP2:
        return bz2.decompress(data)
    if method == _LZMA:
        return lzma.decompress(data)
    if method == _RANS4x8:
        return rans_decode(data)
    raise ValueError(f"unsupported CRAM block compression {method}")


# ---------------------------------------------------------------------------
# Containers and blocks
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes  # decompressed


@dataclasses.dataclass
class Container:
    ref_id: int
    start: int
    span: int
    n_records: int
    n_blocks: int
    landmarks: List[int]
    body_offset: int  # file offset of first block
    length: int


def _read_container_header(data: bytes, pos: int) -> Tuple[Container, int]:
    (length,) = struct.unpack_from("<i", data, pos)
    p = pos + 4
    ref_id, p = read_itf8(data, p)
    start, p = read_itf8(data, p)
    span, p = read_itf8(data, p)
    n_rec, p = read_itf8(data, p)
    _counter, p = read_ltf8(data, p)
    _bases, p = read_ltf8(data, p)
    n_blocks, p = read_itf8(data, p)
    n_land, p = read_itf8(data, p)
    landmarks = []
    for _ in range(n_land):
        lm, p = read_itf8(data, p)
        landmarks.append(lm)
    p += 4  # crc32
    return (
        Container(ref_id, start, span, n_rec, n_blocks, landmarks, p,
                  length),
        p + length,
    )


def _read_block(data: bytes, pos: int) -> Tuple[Block, int]:
    method = data[pos]
    ctype = data[pos + 1]
    cid, p = read_itf8(data, pos + 2)
    csize, p = read_itf8(data, p)
    rsize, p = read_itf8(data, p)
    raw = _decompress(method, data[p : p + csize], rsize)
    if len(raw) != rsize:
        raise ValueError(
            f"CRAM block size mismatch: got {len(raw)}, want {rsize}"
        )
    return Block(method, ctype, cid, raw), p + csize + 4  # + crc


# ---------------------------------------------------------------------------
# Encodings (spec section 12)
# ---------------------------------------------------------------------------

class _BitReader:
    __slots__ = ("data", "pos", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bit = 0

    def read_bits(self, n: int) -> int:
        val = 0
        for _ in range(n):
            byte = self.data[self.pos]
            val = (val << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.pos += 1
        return val


class Encoding:
    """One data-series codec instance bound to its block streams."""

    def __init__(self, codec_id: int, params: bytes):
        self.codec_id = codec_id
        p = 0
        if codec_id == 1:  # EXTERNAL
            self.content_id, _ = read_itf8(params, p)
        elif codec_id == 3:  # HUFFMAN (canonical, int symbols)
            n, p = read_itf8(params, p)
            self.symbols = []
            for _ in range(n):
                s, p = read_itf8(params, p)
                self.symbols.append(s)
            m, p = read_itf8(params, p)
            self.lengths = []
            for _ in range(m):
                l, p = read_itf8(params, p)
                self.lengths.append(l)
            self._build_huffman()
        elif codec_id == 4:  # BYTE_ARRAY_LEN
            len_codec, p = read_itf8(params, p)
            len_params_n, p = read_itf8(params, p)
            self.len_encoding = Encoding(
                len_codec, params[p : p + len_params_n]
            )
            p += len_params_n
            val_codec, p = read_itf8(params, p)
            val_params_n, p = read_itf8(params, p)
            self.val_encoding = Encoding(
                val_codec, params[p : p + val_params_n]
            )
        elif codec_id == 5:  # BYTE_ARRAY_STOP
            self.stop_byte = params[0]
            self.content_id, _ = read_itf8(params, 1)
        elif codec_id == 6:  # BETA
            self.offset, p = read_itf8(params, p)
            self.n_bits, p = read_itf8(params, p)
        elif codec_id == 9:  # GAMMA
            self.offset, p = read_itf8(params, p)
        elif codec_id == 0:  # NULL
            pass
        else:
            raise ValueError(f"unsupported CRAM encoding {codec_id}")

    def _build_huffman(self):
        # Canonical code assignment: sort by (length, symbol order).
        pairs = sorted(
            zip(self.lengths, range(len(self.symbols)))
        )
        self.codes = {}
        code = 0
        prev_len = 0
        for length, idx in pairs:
            code <<= length - prev_len
            prev_len = length
            self.codes.setdefault(length, {})[code] = self.symbols[idx]
            code += 1
        self.single = (
            self.symbols[0] if len(self.symbols) == 1 and
            self.lengths[0] == 0 else None
        )

    # -- decode one value -------------------------------------------------

    def read_int(self, core: _BitReader, external: Dict[int, "_Stream"]):
        cid = self.codec_id
        if cid == 1:
            val, = external[self.content_id].read_itf8()
            return val
        if cid == 3:
            if self.single is not None:
                return self.single
            code = 0
            length = 0
            while True:
                code = (code << 1) | core.read_bits(1)
                length += 1
                table = self.codes.get(length)
                if table and code in table:
                    return table[code]
                if length > 31:
                    raise ValueError("bad huffman stream")
        if cid == 6:
            return core.read_bits(self.n_bits) - self.offset
        if cid == 9:
            n = 0
            while core.read_bits(1) == 0:
                n += 1
            val = 1 << n
            if n:
                val |= core.read_bits(n)
            return val - self.offset
        raise ValueError(f"encoding {cid} cannot read ints")

    def read_byte(self, core: _BitReader, external) -> int:
        if self.codec_id == 1:
            return external[self.content_id].read_byte()
        return self.read_int(core, external) & 0xFF

    def read_bytes(self, n: int, core: _BitReader, external) -> bytes:
        if self.codec_id == 1:
            return external[self.content_id].read(n)
        return bytes(self.read_byte(core, external) for _ in range(n))

    def read_array(self, core: _BitReader, external) -> bytes:
        if self.codec_id == 4:
            n = self.len_encoding.read_int(core, external)
            return self.val_encoding.read_bytes(n, core, external)
        if self.codec_id == 5:
            return external[self.content_id].read_until(self.stop_byte)
        raise ValueError(
            f"encoding {self.codec_id} cannot read byte arrays"
        )


class _Stream:
    """Sequential reader over one external block's bytes."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def read_until(self, stop: int) -> bytes:
        end = self.data.index(stop, self.pos)
        out = self.data[self.pos : end]
        self.pos = end + 1
        return out

    def read_itf8(self) -> Tuple[int]:
        val, self.pos = read_itf8(self.data, self.pos)
        return (val,)


# ---------------------------------------------------------------------------
# Compression header
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionHeader:
    rn_included: bool
    ap_delta: bool
    rr_required: bool
    substitution_matrix: bytes
    tag_dict: List[List[Tuple[str, str]]]  # TL -> [(tag, type), ...]
    encodings: Dict[bytes, Encoding]
    tag_encodings: Dict[int, Encoding]


def _parse_compression_header(data: bytes) -> CompressionHeader:
    pos = 0
    rn, ap, rr = True, True, True
    sub = bytes(5)
    tag_dict: List[List[Tuple[str, str]]] = [[]]
    # Preservation map.
    _size, pos = read_itf8(data, pos)
    n, pos = read_itf8(data, pos)
    for _ in range(n):
        key = data[pos : pos + 2]
        pos += 2
        if key == b"RN":
            rn = bool(data[pos]); pos += 1
        elif key == b"AP":
            ap = bool(data[pos]); pos += 1
        elif key == b"RR":
            rr = bool(data[pos]); pos += 1
        elif key == b"SM":
            sub = data[pos : pos + 5]; pos += 5
        elif key == b"TD":
            tlen, pos = read_itf8(data, pos)
            blob = data[pos : pos + tlen]
            pos += tlen
            tag_dict = []
            for line in blob.split(b"\x00"):
                entries = []
                for i in range(0, len(line) - 2, 3):
                    entries.append(
                        (line[i : i + 2].decode(), chr(line[i + 2]))
                    )
                tag_dict.append(entries)
        else:
            raise ValueError(f"unknown preservation key {key!r}")
    # Data-series encoding map.
    _size, pos = read_itf8(data, pos)
    n, pos = read_itf8(data, pos)
    encodings: Dict[bytes, Encoding] = {}
    for _ in range(n):
        key = data[pos : pos + 2]
        pos += 2
        codec, pos = read_itf8(data, pos)
        plen, pos = read_itf8(data, pos)
        encodings[key] = Encoding(codec, data[pos : pos + plen])
        pos += plen
    # Tag encoding map.
    _size, pos = read_itf8(data, pos)
    n, pos = read_itf8(data, pos)
    tag_encodings: Dict[int, Encoding] = {}
    for _ in range(n):
        key, pos = read_itf8(data, pos)
        codec, pos = read_itf8(data, pos)
        plen, pos = read_itf8(data, pos)
        tag_encodings[key] = Encoding(codec, data[pos : pos + plen])
        pos += plen
    return CompressionHeader(
        rn, ap, rr, sub, tag_dict, encodings, tag_encodings
    )


# ---------------------------------------------------------------------------
# Slices and record decoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SliceHeader:
    ref_id: int
    start: int
    span: int
    n_records: int
    n_blocks: int
    content_ids: List[int]
    embedded_ref_id: int


def _parse_slice_header(data: bytes) -> SliceHeader:
    pos = 0
    ref_id, pos = read_itf8(data, pos)
    start, pos = read_itf8(data, pos)
    span, pos = read_itf8(data, pos)
    n_rec, pos = read_itf8(data, pos)
    _counter, pos = read_ltf8(data, pos)
    n_blocks, pos = read_itf8(data, pos)
    n_ids, pos = read_itf8(data, pos)
    ids = []
    for _ in range(n_ids):
        cid, pos = read_itf8(data, pos)
        ids.append(cid)
    embedded, pos = read_itf8(data, pos)
    return SliceHeader(ref_id, start, span, n_rec, n_blocks, ids, embedded)


# Substitution matrix base orders (spec 10.7): for each reference base
# (ACGTN), the 4 substitution targets in 2-bit code order.
_SUB_BASES = {
    "A": "CGTN", "C": "AGTN", "G": "ACTN", "T": "ACGN", "N": "ACGT",
}


class CramReader:
    """Random-access-free CRAM 3.0 reader (sequential container scan)."""

    def __init__(self, path: str, ref_reader=None):
        self._path = path
        with open(path, "rb") as f:
            self._data = f.read()
        if self._data[:4] != CRAM_MAGIC:
            raise ValueError(f"not a CRAM file: {path}")
        self.major, self.minor = self._data[4], self._data[5]
        if self.major != 3:
            raise ValueError(
                f"unsupported CRAM version {self.major}.{self.minor}"
            )
        self._ref = ref_reader
        pos = 26
        # First container: SAM header text.
        container, pos = _read_container_header(self._data, pos)
        block, _ = _read_block(self._data, container.body_offset)
        (text_len,) = struct.unpack_from("<i", block.data, 0)
        self.header_text = block.data[4 : 4 + text_len].decode(
            "ascii", "replace"
        )
        self.ref_names: List[str] = []
        self._ref_lengths: Dict[str, int] = {}
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                name = length = None
                for fieldv in line.split("\t")[1:]:
                    if fieldv.startswith("SN:"):
                        name = fieldv[3:]
                    elif fieldv.startswith("LN:"):
                        length = int(fieldv[3:])
                if name:
                    self.ref_names.append(name)
                    self._ref_lengths[name] = length or 0
        self._first_data_container = pos

    # -- iteration ---------------------------------------------------------

    def __iter__(self) -> Iterator[Read]:
        return self.iterate()

    def iterate(self) -> Iterator[Read]:
        for rec in self._records():
            yield self._to_read(rec)

    def _records(self) -> Iterator[dict]:
        """Every record of the file, in file order, as the decoded dict
        `_to_read` turns into a Read."""
        pos = self._first_data_container
        data = self._data
        while pos + 4 <= len(data):
            container, nxt = _read_container_header(data, pos)
            if container.ref_id == -1 and container.n_blocks == 0:
                break  # EOF container
            if container.n_records:
                yield from self._decode_container(container)
            pos = nxt

    def _load_crai(self):
        """Parse the .crai (gzipped TSV: seq_id, start, span, container
        file offset, slice header offset, slice size) once."""
        if getattr(self, "_crai", None) is not None:
            return self._crai
        import gzip
        import os

        crai_path = self._path + ".crai"
        entries = []
        if os.path.exists(crai_path):
            with gzip.open(crai_path, "rt") as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 6:
                        entries.append(tuple(int(x) for x in parts[:6]))
        self._crai = entries
        return entries

    def query(self, region: Range) -> List[Read]:
        """Reads overlapping region; random access via .crai when the
        sidecar exists, else a full sequential scan."""
        try:
            ref_id = self.ref_names.index(region.reference_name)
        except ValueError:
            return []
        crai = self._load_crai()
        if crai:
            offsets = sorted({
                off for (sid, start, span, off, _so, _sl) in crai
                if sid == ref_id and start - 1 < region.end
                and start - 1 + span > region.start
            })
            source = self._iterate_containers_at(offsets)
        else:
            source = self._records()
        out = []
        for read in map(self._to_read, source):
            if (
                read.reference_name == region.reference_name
                and read.position < region.end
                and read.position + _ref_span(read) > region.start
            ):
                out.append(read)
        return out

    def _iterate_containers_at(
        self, offsets: Sequence[int]
    ) -> Iterator[dict]:
        data = self._data
        for off in offsets:
            container, _ = _read_container_header(data, off)
            if container.n_records:
                yield from self._decode_container(container)

    # -- container decode --------------------------------------------------

    def _decode_container(self, container: Container) -> Iterator[dict]:
        data = self._data
        base = container.body_offset
        block, pos = _read_block(data, base)
        assert block.content_type == _CT_COMPRESSION_HEADER
        comp = _parse_compression_header(block.data)
        while pos < base + container.length:
            block, pos = _read_block(data, pos)
            if block.content_type != _CT_SLICE_HEADER:
                continue
            sl = _parse_slice_header(block.data)
            core: Optional[bytes] = None
            external: Dict[int, bytes] = {}
            for _ in range(sl.n_blocks):
                b, pos = _read_block(data, pos)
                if b.content_type == _CT_CORE:
                    core = b.data
                elif b.content_type == _CT_EXTERNAL:
                    external[b.content_id] = b.data
            yield from self._decode_slice(container, comp, sl, core or b"",
                                          external)

    def _ref_bases(self, sl: SliceHeader, external: Dict[int, bytes]):
        """Reference window for the slice: embedded block or reader."""
        if sl.embedded_ref_id >= 0 and sl.embedded_ref_id in external:
            return external[sl.embedded_ref_id], sl.start
        if self._ref is not None and sl.ref_id >= 0:
            name = self.ref_names[sl.ref_id]
            window = self._ref.query(
                Range(name, max(0, sl.start - 1),
                      sl.start + sl.span + 1)
            )
            return window.encode(), max(0, sl.start - 1) + 1
        return b"", sl.start

    def _decode_slice(
        self,
        container: Container,
        comp: CompressionHeader,
        sl: SliceHeader,
        core_bytes: bytes,
        external_bytes: Dict[int, bytes],
    ) -> Iterator[dict]:
        core = _BitReader(core_bytes)
        external = {
            cid: _Stream(blob) for cid, blob in external_bytes.items()
        }
        enc = comp.encodings

        def get(key: bytes):
            e = enc.get(key)
            if e is None:
                raise ValueError(f"missing encoding for {key!r}")
            return e

        ref_window, ref_window_start = self._ref_bases(
            sl, external_bytes
        )

        last_pos = sl.start
        records = []
        for _ in range(sl.n_records):
            rec: Dict[str, object] = {}
            bf = get(b"BF").read_int(core, external)
            cf = get(b"CF").read_int(core, external)
            if sl.ref_id == -2:  # multi-ref slice
                ri = get(b"RI").read_int(core, external)
            else:
                ri = sl.ref_id
            rl = get(b"RL").read_int(core, external)
            ap = get(b"AP").read_int(core, external)
            if comp.ap_delta:
                last_pos += ap
                pos0 = last_pos
            else:
                pos0 = ap
            rg = get(b"RG").read_int(core, external)
            if comp.rn_included:
                name = get(b"RN").read_array(core, external).decode(
                    "ascii", "replace"
                )
            else:
                name = ""
            mate_flags = 0
            mate_ref = -1
            mate_pos = -1
            tlen = 0
            nf = -1
            if cf & 0x2:  # detached
                mate_flags = get(b"MF").read_int(core, external)
                if not comp.rn_included:
                    name = get(b"RN").read_array(core, external).decode(
                        "ascii", "replace"
                    )
                mate_ref = get(b"NS").read_int(core, external)
                mate_pos = get(b"NP").read_int(core, external)
                tlen = get(b"TS").read_int(core, external)
                if mate_ref >= 0x7FFFFFFF:
                    mate_ref = -1
            elif cf & 0x4:  # mate downstream
                nf = get(b"NF").read_int(core, external)
            tl = get(b"TL").read_int(core, external)
            tags: Dict[str, object] = {}
            # (tag, type, value bytes) in record order: the BAM aux blob
            # of the record (`_aux_blob`).
            tag_blobs: List[Tuple[str, str, bytes]] = []
            for tag, typ in comp.tag_dict[tl] if tl < len(
                comp.tag_dict
            ) else []:
                key = (
                    (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                )
                blob = comp.tag_encodings[key].read_array(core, external)
                tags[tag] = _decode_tag_value(typ, blob)
                tag_blobs.append((tag, typ, blob))
            flags = bf
            seq = b""
            quals = b""
            cigar: List[Tuple[int, int]] = []
            mapq = 0
            if not (bf & 0x4):  # mapped
                fn = get(b"FN").read_int(core, external)
                features = []
                fpos = 0
                for _ in range(fn):
                    fc = chr(get(b"FC").read_byte(core, external))
                    fp = get(b"FP").read_int(core, external)
                    fpos += fp
                    payload = self._read_feature(
                        fc, get, core, external
                    )
                    features.append((fc, fpos, payload))
                mapq = get(b"MQ").read_int(core, external)
                seq, cigar = _reconstruct(
                    rl, pos0, features, ref_window, ref_window_start,
                    comp.substitution_matrix,
                )
                if cf & 0x1:  # qualities stored
                    quals = get(b"QS").read_bytes(rl, core, external)
                else:
                    quals = b"\xff" * rl
            else:
                ba = get(b"BA")
                seq = ba.read_bytes(rl, core, external)
                if cf & 0x1:
                    quals = get(b"QS").read_bytes(rl, core, external)
                else:
                    quals = b"\xff" * rl
                cigar = []
            records.append({
                "name": name, "flags": flags, "ri": ri, "pos": pos0,
                "mapq": mapq, "seq": seq, "quals": quals,
                "cigar": cigar, "mate_ref": mate_ref,
                "mate_pos": mate_pos, "tlen": tlen, "nf": nf,
                "cf": cf, "tags": tags, "rl": rl, "tag_blobs": tag_blobs,
            })

        _resolve_mates(records)
        yield from records

    def _read_feature(self, fc, get, core, external):
        if fc == "B":
            return (get(b"BA").read_byte(core, external),
                    get(b"QS").read_byte(core, external))
        if fc == "X":
            return get(b"BS").read_byte(core, external)
        if fc == "D":
            return get(b"DL").read_int(core, external)
        if fc == "I":
            return get(b"IN").read_array(core, external)
        if fc == "i":
            return get(b"BA").read_byte(core, external)
        if fc == "S":
            return get(b"SC").read_array(core, external)
        if fc == "H":
            return get(b"HC").read_int(core, external)
        if fc == "P":
            return get(b"PD").read_int(core, external)
        if fc == "N":
            return get(b"RS").read_int(core, external)
        if fc == "Q":
            return get(b"QS").read_byte(core, external)
        if fc == "q":
            return get(b"QQ").read_array(core, external)
        if fc == "b":
            return get(b"BB").read_array(core, external)
        raise ValueError(f"unknown read feature {fc!r}")

    def _to_read(self, rec) -> Read:
        flags = rec["flags"]
        name = self.ref_names[rec["ri"]] if 0 <= rec["ri"] < len(
            self.ref_names
        ) else ""
        mate = None
        if flags & 0x1 and rec["mate_ref"] >= 0:
            mate = (
                self.ref_names[rec["mate_ref"]]
                if rec["mate_ref"] < len(self.ref_names) else "",
                rec["mate_pos"] - 1 if rec["mate_pos"] > 0 else -1,
                bool(flags & 0x20),
            )
        quals = rec["quals"]
        return Read(
            fragment_name=rec["name"],
            aligned_sequence=rec["seq"].decode("ascii", "replace"),
            aligned_quality=quals,
            reference_name=name if not (flags & 0x4) or name else name,
            position=rec["pos"] - 1,
            mapping_quality=rec["mapq"],
            cigar=rec["cigar"],
            reverse_strand=bool(flags & 0x10),
            read_number=0 if flags & 0x40 or not flags & 0x1 else 1,
            number_reads=2 if flags & 0x1 else 1,
            fragment_length=rec["tlen"],
            proper_placement=bool(flags & 0x2),
            duplicate_fragment=bool(flags & 0x400),
            failed_vendor_quality_checks=bool(flags & 0x200),
            secondary_alignment=bool(flags & 0x100),
            supplementary_alignment=bool(flags & 0x800),
            next_mate_position=mate,
            info={k: [v] for k, v in rec["tags"].items()},
        )


def _decode_tag_value(typ: str, blob: bytes):
    if typ == "A":
        return chr(blob[0])
    if typ == "c":
        return struct.unpack("<b", blob)[0]
    if typ == "C":
        return blob[0]
    if typ == "s":
        return struct.unpack("<h", blob)[0]
    if typ == "S":
        return struct.unpack("<H", blob)[0]
    if typ == "i":
        return struct.unpack("<i", blob)[0]
    if typ == "I":
        return struct.unpack("<I", blob)[0]
    if typ == "f":
        return struct.unpack("<f", blob)[0]
    if typ in ("Z", "H"):
        return blob.rstrip(b"\x00").decode("ascii", "replace")
    if typ == "B":
        sub = chr(blob[0])
        (count,) = struct.unpack_from("<I", blob, 1)
        dt = {"c": np.int8, "C": np.uint8, "s": np.int16,
              "S": np.uint16, "i": np.int32, "I": np.uint32,
              "f": np.float32}[sub]
        return np.frombuffer(blob, dt, count=count, offset=5).copy()
    return blob


def _ref_span(read: Read) -> int:
    span = 0
    for op, n in read.cigar:
        if op in (_M, _D, _N, _EQ, _X):
            span += n
    return max(span, 1)


def _reconstruct(
    read_len: int,
    pos1: int,
    features,
    ref_window: bytes,
    ref_window_start: int,
    sub_matrix: bytes,
) -> Tuple[bytes, List[Tuple[int, int]]]:
    """Sequence + CIGAR from read features against the reference
    (spec section 10.7 record decoding)."""
    seq = bytearray(read_len)
    cigar: List[Tuple[int, int]] = []
    # Op codes follow nucleus CigarUnit (core.cigar): 1 M, 2 I, 3 D,
    # 4 N, 5 S, 6 H, 7 P.

    def add_op(op: int, n: int):
        if n <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + n)
        else:
            cigar.append((op, n))

    def ref_base(rp: int) -> int:
        i = rp - ref_window_start
        if 0 <= i < len(ref_window):
            b = ref_window[i]
            return b - 32 if 97 <= b <= 122 else b
        return ord("N")

    read_i = 0  # 0-based position within the read
    ref_i = pos1  # 1-based reference position
    for fc, fpos, payload in features:
        # Copy matched bases up to the feature position (1-based).
        gap = fpos - 1 - read_i
        if gap > 0:
            for k in range(gap):
                seq[read_i + k] = ref_base(ref_i + k)
            add_op(_M, gap)
            read_i += gap
            ref_i += gap
        if fc == "B":
            seq[read_i] = payload[0]
            add_op(_M, 1)
            read_i += 1
            ref_i += 1
        elif fc == "X":
            rb = chr(ref_base(ref_i))
            targets = _SUB_BASES.get(rb, "ACGT")
            code = payload & 0x3
            # The substitution matrix byte for this ref base permutes
            # the target order; sub_matrix packs 4 2-bit ranks.
            order_byte = sub_matrix["ACGTN".index(rb)
                                    if rb in "ACGTN" else 4]
            # rank r of target t stored at bits (3-t)*2.
            by_rank = [""] * 4
            for t in range(4):
                rank = (order_byte >> ((3 - t) * 2)) & 0x3
                by_rank[rank] = targets[t]
            seq[read_i] = ord(by_rank[code])
            add_op(_M, 1)
            read_i += 1
            ref_i += 1
        elif fc == "D":
            add_op(_D, payload)
            ref_i += payload
        elif fc == "I":
            for b in payload:
                seq[read_i] = b
                read_i += 1
            add_op(_I, len(payload))
        elif fc == "i":
            seq[read_i] = payload
            add_op(_I, 1)
            read_i += 1
        elif fc == "S":
            for b in payload:
                seq[read_i] = b
                read_i += 1
            add_op(_S, len(payload))
        elif fc == "H":
            add_op(_H, payload)
        elif fc == "P":
            add_op(_P, payload)
        elif fc == "N":
            add_op(_N, payload)
            ref_i += payload
        elif fc == "Q":
            pass  # single quality substitution: no seq/cigar effect
        elif fc == "q":
            pass
        elif fc == "b":
            for b in payload:
                seq[read_i] = b
                read_i += 1
            add_op(_M, len(payload))
            ref_i += len(payload)
    tail = read_len - read_i
    if tail > 0:
        for k in range(tail):
            seq[read_i + k] = ref_base(ref_i + k)
        add_op(_M, tail)
    return bytes(seq), cigar


def _resolve_mates(records: List[dict]) -> None:
    """Fill mate info for non-detached pairs via NF distances
    (spec 10.2 mate records)."""
    for i, rec in enumerate(records):
        nf = rec["nf"]
        if nf is None or nf < 0:
            continue
        j = i + nf + 1
        if j >= len(records):
            continue
        mate = records[j]
        rec["mate_ref"] = mate["ri"]
        rec["mate_pos"] = mate["pos"]
        mate["mate_ref"] = rec["ri"]
        mate["mate_pos"] = rec["pos"]
        # Template length: leftmost start to rightmost end.
        left = min(rec["pos"], mate["pos"])
        right = max(
            rec["pos"] + _cigar_ref_len(rec["cigar"]),
            mate["pos"] + _cigar_ref_len(mate["cigar"]),
        )
        tlen = right - left
        if rec["pos"] <= mate["pos"]:
            rec["tlen"], mate["tlen"] = tlen, -tlen
        else:
            rec["tlen"], mate["tlen"] = -tlen, tlen
        # Mate-reverse / mate-unmapped flags from MF would apply here;
        # non-detached mates derive flags from each other.
        if mate["flags"] & 0x10:
            rec["flags"] |= 0x20
        if rec["flags"] & 0x10:
            mate["flags"] |= 0x20


def _cigar_ref_len(cigar) -> int:
    return sum(n for op, n in cigar if op in (_M, _D, _N, _EQ, _X))


def _aux_blob(tag_blobs: Sequence[Tuple[str, str, bytes]]) -> bytes:
    """A record's tags as the BAM aux blob they came from: CRAM stores
    each tag's value in its BAM binary form, a string with or without
    its NUL (BYTE_ARRAY_LEN or BYTE_ARRAY_STOP)."""
    out = bytearray()
    for tag, typ, blob in tag_blobs:
        if typ in ("Z", "H"):
            blob = blob.rstrip(b"\x00") + b"\x00"
        out += tag.encode() + typ.encode() + blob
    return bytes(out)


class CramBatchReader:
    """BamReader's interface over CramReader.

    Decodes the whole file once, at the first query, and serves ReadBatch
    views per region, filtered by the same ReadRequirements and
    downsampled with the same draws as BamReader: one number per kept
    read, in query order, from a Philox generator seeded with
    `random_seed`. Each batch carries the records' BAM flags and aux
    blobs, so the aux parsers are BamReader's, run on demand.
    """

    def __init__(self, path: str, ref_reader=None, requirements=None,
                 downsample_fraction: float = 0.0,
                 random_seed: int = 2928130004):
        self._cram = CramReader(path, ref_reader=ref_reader)
        self.ref_names = list(self._cram.ref_names)
        self.requirements = requirements or ReadRequirements()
        self._downsample = downsample_fraction
        self._rng = np.random.Generator(np.random.Philox(random_seed))
        self.header = BamHeader(self._cram.header_text, [
            ContigInfo(name, self._cram._ref_lengths[name], i)
            for i, name in enumerate(self.ref_names)])
        # (Read, BAM flag, BAM aux blob) of every kept record.
        self._reads: Optional[List[Tuple[Read, int, bytes]]] = None

    @property
    def header_text(self) -> str:
        return self._cram.header_text

    def _keeps(self, read: Read, flag: int) -> bool:
        """BamReader's record filters: `_passes_filters` and the
        improperly-placed check of `_scan_records`."""
        return bool(read.cigar) and self._passes_filters(
            flag, read.mapping_quality) and not (
            not self.requirements.keep_improperly_placed
            and flag & FLAG_PAIRED
            and not flag & FLAG_PROPER_PAIR
            and not flag & FLAG_MATE_UNMAPPED
            and read.next_mate_position is not None
            and read.next_mate_position[0] != read.reference_name
        )

    def _all_reads(self) -> List[Tuple[Read, int, bytes]]:
        if self._reads is None:
            out = []
            for rec in self._cram._records():
                read = self._cram._to_read(rec)
                if self._keeps(read, rec["flags"]):
                    out.append(
                        (read, rec["flags"], _aux_blob(rec["tag_blobs"])))
            self._reads = out
        return self._reads

    def _batch(self, entries) -> ReadBatch:
        if self._downsample > 0.0:
            entries = [e for e in entries
                       if self._rng.random() < self._downsample]
        batch = ReadBatch.from_reads([e[0] for e in entries],
                                     self.ref_names)
        batch.flag = np.array([e[1] for e in entries], np.uint16)
        batch.aux = [e[2] for e in entries]
        # HP comes from the aux blobs on demand (parse_hp_tags).
        batch.hp = np.zeros(len(entries), np.int8)
        return batch

    def query(self, region: Range) -> ReadBatch:
        return self._batch([
            e for e in self._all_reads()
            if e[0].reference_name == region.reference_name
            and e[0].position < region.end
            and e[0].position + _ref_span(e[0]) > region.start
        ])

    def iterate(self) -> ReadBatch:
        return self._batch(self._all_reads())

    # -- BamReader's flag filters and aux parsers, on the records' BAM
    # flags and rebuilt aux blobs ------------------------------------------

    _keep_unmapped = False
    _passes_filters = BamReader._passes_filters
    parse_hp_tags = BamReader.parse_hp_tags
    apply_original_quality_scores = BamReader.apply_original_quality_scores
    parse_methylation = BamReader.parse_methylation
    parse_ultima_tags = BamReader.parse_ultima_tags

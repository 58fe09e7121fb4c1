"""A CRAM 3.0 writer for the seeded samples of `synthetic.py`.

Test data only: no entry point of the port writes CRAM. `write_cram`
turns a sample's reads into a CRAM file and its `.crai`, so that the
CRAM readers of both packages can be held against the BAM of the same
sample. It writes what hts-specs CRAMv3 lays out: the file definition,
the SAM header container, one data container of one slice per
`records_per_container` reads of one contig (a compression header with
the preservation map, the substitution matrix, the tag dictionary and
the encoding maps; a slice header; the core block; one external block
per data series and per tag, and the reference span when it is
embedded), the EOF container, and the gzipped `.crai` (one line per
container).

`CramLayout` picks what varies:

- `method`: the compression of the data blocks, raw, gzip, bzip2, lzma,
  or rANS 4x8 of order 0 or 1 (`rans_encode`, the encoder that the
  decoders of both packages invert);
- `core_codes`: every data series on an EXTERNAL block, or the integer
  series on the core bit stream as HUFFMAN (one symbol and many), BETA
  and GAMMA codes, and absolute rather than delta positions;
- `embed_reference`: the slice's reference span as a block, or none
  (the reader then takes the FASTA);
- `attach_mates`: a pair in one slice is attached (NF; the reader
  derives the mate's position, the template length and the mate-reverse
  flag) wherever that derivation gives the BAM's values; other mates
  are detached (MF, NS, NP, TS);
- `extra_features`: some substitutions written as B (base and quality)
  instead of X, one-base insertions as i, and Q and q features that
  repeat stored qualities.

Read features: X (substitution, through the matrix), I, D, N, S, H, and
with `extra_features` B, i, Q and q. The tags of every read are kept in
its BAM aux order, each value in its BAM binary form: BYTE_ARRAY_STOP
for strings, BYTE_ARRAY_LEN for the rest.
"""

from __future__ import annotations

import bz2
import dataclasses
import gzip
import hashlib
import heapq
import lzma
import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

# CIGAR op codes as the sample stores them (proto codes).
_M, _I, _D, _N, _S, _H, _P, _EQ, _X = 1, 2, 3, 4, 5, 6, 7, 8, 9
_REF_OPS = (_M, _D, _N, _EQ, _X)

METHODS = ("raw", "gzip", "bzip2", "lzma", "rans0", "rans1")
_METHOD_CODE = {"raw": 0, "gzip": 1, "bzip2": 2, "lzma": 3, "rans0": 4,
                "rans1": 4}

# Block content types.
_CT_FILE_HEADER, _CT_COMPRESSION_HEADER, _CT_SLICE_HEADER = 0, 1, 2
_CT_EXTERNAL, _CT_CORE = 4, 5

# Codec ids.
_EXTERNAL, _HUFFMAN, _BYTE_ARRAY_LEN, _BYTE_ARRAY_STOP = 1, 3, 4, 5
_BETA, _GAMMA = 6, 9

# The substitution targets of each reference base (spec 10.7).
_SUB_BASES = {
    "A": "CGTN", "C": "AGTN", "G": "ACTN", "T": "ACGN", "N": "ACGT",
}

# htslib's EOF container for CRAM 3.0.
_EOF = bytes.fromhex(
    "0f000000ffffffff0fe0454f46000000000100"
    "05bdd94f0001000606010001000100ee63014b")


@dataclasses.dataclass(frozen=True)
class CramLayout:
    method: str = "rans1"
    core_codes: bool = False
    embed_reference: bool = False
    attach_mates: bool = True
    records_per_container: int = 10000
    extra_features: bool = False


# -- varints ---------------------------------------------------------------

def itf8(value: int) -> bytes:
    v = value & 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF,
                      v & 0xFF])
    return bytes([0xF0 | (v >> 28), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def ltf8(value: int) -> bytes:
    for n in range(9):
        if value < 1 << ((7 - n if n < 7 else 0) + 8 * n):
            break
    first = (0xFF00 >> n) & 0xFF
    if n < 7:
        first |= value >> (8 * n)
    return bytes([first] + [(value >> (8 * (n - 1 - i))) & 0xFF
                            for i in range(n)])


# -- rANS 4x8 (spec section 13) --------------------------------------------

_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT
_RANS_LOW = 1 << 23


def _normalize(counts: np.ndarray) -> np.ndarray:
    """Counts scaled to frequencies summing to 4096, none of a present
    symbol below 1."""
    freq = np.zeros(256, np.int64)
    nz = counts > 0
    freq[nz] = np.maximum(1, counts[nz] * _TOTFREQ // counts.sum())
    excess = int(freq.sum()) - _TOTFREQ
    for s in np.argsort(-freq, kind="stable"):
        if excess <= 0:
            break
        take = min(excess, int(freq[s]) - 1)
        freq[s] -= take
        excess -= take
    freq[int(np.argmax(freq))] -= excess  # excess <= 0 here: a deficit
    return freq


def _write_symbols(present: List[int], write_entry, out: bytearray) -> None:
    """The run-length symbol list of spec 13.1: each symbol byte, and
    after one that follows the previous byte written by one, the count of
    the further consecutive symbols, which then go without a byte."""
    last = None
    rle = 0
    for k, s in enumerate(present):
        if rle:
            rle -= 1
        else:
            out.append(s)
            if last is not None and s == last + 1:
                run = 0
                while (k + 1 + run < len(present) and run < 255
                       and present[k + 1 + run] == s + 1 + run):
                    run += 1
                out.append(run)
                rle = run
            last = s
        write_entry(s)
    out.append(0)


def _write_freqs0(freq: np.ndarray, out: bytearray) -> None:
    _write_symbols([int(s) for s in np.flatnonzero(freq)],
                   lambda s: out.extend(itf8(int(freq[s]))), out)


def _rans_states(data: bytes, order: List[Tuple[int, int, int]],
                 freq: np.ndarray, cum: np.ndarray):
    """Encode `data` in the reverse of the decoder's `order` of (state,
    position, context) steps; returns the four states and the byte
    stream in the decoder's reading order."""
    states = [_RANS_LOW] * 4
    out = bytearray()
    for j, i, ctx in reversed(order):
        s = data[i]
        f = int(freq[ctx, s])
        x = states[j]
        x_max = ((_RANS_LOW >> _TF_SHIFT) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << _TF_SHIFT) + (x % f) + int(cum[ctx, s])
    out.reverse()
    return states, bytes(out)


def rans_encode(data: bytes, order: int) -> bytes:
    """rANS 4x8 of order 0 or 1: the order byte, the compressed and the
    raw sizes, the frequency tables, the four states and the stream."""
    n = len(data)
    if n == 0:
        return bytes([order]) + struct.pack("<II", 0, 0)
    arr = np.frombuffer(data, np.uint8)
    table = bytearray()
    if order == 0:
        freq = _normalize(np.bincount(arr, minlength=256))[None, :]
        _write_freqs0(freq[0], table)
        steps = [(i & 3, i, 0) for i in range(n)]
    else:
        q = n >> 2
        starts = [0, q, 2 * q, 3 * q]
        steps = [(j, starts[j] + k, 0) for k in range(q) for j in range(4)]
        steps += [(3, i, 0) for i in range(4 * q, n)]
        steps = [(j, i, 0 if i == starts[j] else data[i - 1])
                 for j, i, _ in steps]
        counts = np.zeros((256, 256), np.int64)
        for _, i, ctx in steps:
            counts[ctx, data[i]] += 1
        freq = np.zeros((256, 256), np.int64)
        present = [c for c in range(256) if counts[c].any()]
        for c in present:
            freq[c] = _normalize(counts[c])
        _write_symbols(present, lambda c: _write_freqs0(freq[c], table),
                       table)
    cum = np.zeros((freq.shape[0], 257), np.int64)
    np.cumsum(freq, axis=1, out=cum[:, 1:])
    states, stream = _rans_states(data, steps, freq, cum)
    payload = bytes(table) + struct.pack("<4I", *states) + stream
    return bytes([order]) + struct.pack("<II", len(payload), n) + payload


def _compress(method: str, raw: bytes) -> bytes:
    if method == "raw":
        return raw
    if method == "gzip":
        return gzip.compress(raw, mtime=0)
    if method == "bzip2":
        return bz2.compress(raw)
    if method == "lzma":
        return lzma.compress(raw)
    return rans_encode(raw, 0 if method == "rans0" else 1)


def _block(method: str, content_type: int, content_id: int,
           raw: bytes) -> bytes:
    data = _compress(method, raw)
    body = bytes([_METHOD_CODE[method], content_type]) + itf8(content_id) \
        + itf8(len(data)) + itf8(len(raw)) + data
    return body + struct.pack("<I", zlib.crc32(body))


def _container_header(length: int, ref_id: int, start: int, span: int,
                      n_records: int, counter: int, bases: int,
                      n_blocks: int, landmarks: List[int]) -> bytes:
    head = struct.pack("<i", length) + itf8(ref_id) + itf8(start) \
        + itf8(span) + itf8(n_records) + ltf8(counter) + ltf8(bases) \
        + itf8(n_blocks) + itf8(len(landmarks)) \
        + b"".join(itf8(x) for x in landmarks)
    return head + struct.pack("<I", zlib.crc32(head))


# -- encodings --------------------------------------------------------------

class _Bits:
    """The core block: bits written most significant first."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value: int, n_bits: int) -> None:
        for k in range(n_bits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> k) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                self.acc = self.n = 0

    def data(self) -> bytes:
        if self.n:
            return bytes(self.out) + bytes([self.acc << (8 - self.n)])
        return bytes(self.out)


def _huffman_codes(values: List[int]) -> Tuple[bytes, Dict[int, tuple]]:
    """HUFFMAN parameters and {symbol: (code, length)}: code lengths from
    the counts, codes assigned canonically in (length, symbol) order."""
    counts: Dict[int, int] = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    symbols = sorted(counts)
    lengths = {s: 0 for s in symbols}
    if len(symbols) > 1:
        heap = [(counts[s], k, [s]) for k, s in enumerate(symbols)]
        heapq.heapify(heap)
        tie = len(heap)
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            for s in a + b:
                lengths[s] += 1
            heapq.heappush(heap, (c1 + c2, tie, a + b))
            tie += 1
    codes = {}
    code = prev = 0
    for length, k in sorted((lengths[s], k) for k, s in enumerate(symbols)):
        code <<= length - prev
        prev = length
        codes[symbols[k]] = (code, length)
        code += 1
    params = itf8(len(symbols)) + b"".join(itf8(s) for s in symbols) \
        + itf8(len(symbols)) + b"".join(itf8(lengths[s]) for s in symbols)
    return params, codes


class _IntEncoding:
    """One integer (or single-byte) data series: EXTERNAL, HUFFMAN, BETA
    or GAMMA."""

    def __init__(self, codec: int, values: List[int], content_id: int):
        self.codec = codec
        self.content_id = content_id
        if codec == _EXTERNAL:
            self.params = itf8(content_id)
        elif codec == _HUFFMAN:
            self.params, self.codes = _huffman_codes(values)
        elif codec == _BETA:
            lo, hi = min(values), max(values)
            self.offset, self.n_bits = -lo, (hi - lo).bit_length()
            self.params = itf8(self.offset) + itf8(self.n_bits)
        else:  # GAMMA
            self.offset = 1 - min(values)
            self.params = itf8(self.offset)

    def spec(self) -> bytes:
        return itf8(self.codec) + itf8(len(self.params)) + self.params

    def put(self, value: int, byte: bool, core: _Bits,
            external: Dict[int, bytearray]) -> None:
        if self.codec == _EXTERNAL:
            external[self.content_id] += bytes([value]) if byte \
                else itf8(value)
        elif self.codec == _HUFFMAN:
            code, length = self.codes[value]
            core.put(code, length)
        elif self.codec == _BETA:
            core.put(value + self.offset, self.n_bits)
        else:
            v = value + self.offset
            n = v.bit_length() - 1
            core.put(0, n)
            core.put(1, 1)
            core.put(v & ((1 << n) - 1), n)


class _ArrayEncoding:
    """One byte-array series: BYTE_ARRAY_STOP, or BYTE_ARRAY_LEN with its
    length on an EXTERNAL block or as HUFFMAN codes."""

    def __init__(self, stop: bool, lengths: List[int], content_id: int,
                 len_codec: int, len_content_id: int):
        self.stop = stop
        self.content_id = content_id
        if stop:
            self.params = b"\t" + itf8(content_id)
            self.codec = _BYTE_ARRAY_STOP
        else:
            self.length = _IntEncoding(len_codec, lengths, len_content_id)
            self.params = self.length.spec() + itf8(_EXTERNAL) \
                + itf8(len(itf8(content_id))) + itf8(content_id)
            self.codec = _BYTE_ARRAY_LEN

    def spec(self) -> bytes:
        return itf8(self.codec) + itf8(len(self.params)) + self.params

    def put(self, value: bytes, core: _Bits,
            external: Dict[int, bytearray]) -> None:
        if self.stop:
            external[self.content_id] += value + b"\t"
        else:
            self.length.put(len(value), False, core, external)
            external[self.content_id] += value


# The codec of each integer series on the core bit stream; the others
# (BA and QS, read as bytes of quality and base arrays) stay EXTERNAL.
_CORE_CODECS = {
    "BF": _HUFFMAN, "CF": _HUFFMAN, "RL": _HUFFMAN, "RG": _HUFFMAN,
    "MF": _HUFFMAN, "TL": _HUFFMAN, "FN": _HUFFMAN, "FC": _HUFFMAN,
    "BS": _HUFFMAN, "MQ": _HUFFMAN, "NF": _HUFFMAN,
    "AP": _BETA, "FP": _BETA, "DL": _BETA, "NS": _BETA, "NP": _BETA,
    "TS": _BETA, "PD": _BETA, "HC": _GAMMA, "RS": _GAMMA,
}
_ARRAY_SERIES = ("RN", "IN", "SC", "QQ", "BB")


# -- reads ------------------------------------------------------------------

_AUX_SIZE = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
             "f": 4}


def aux_items(blob: bytes) -> List[Tuple[str, str, bytes]]:
    """A BAM aux blob as (tag, type, value bytes), in its order."""
    out = []
    p = 0
    while p < len(blob):
        tag, typ = blob[p:p + 2].decode(), chr(blob[p + 2])
        p += 3
        if typ in _AUX_SIZE:
            n = _AUX_SIZE[typ]
        elif typ in "ZH":
            n = blob.index(0, p) - p + 1
        else:  # B
            (count,) = struct.unpack_from("<I", blob, p + 1)
            n = 5 + count * _AUX_SIZE[chr(blob[p])]
        out.append((tag, typ, blob[p:p + n]))
        p += n
    return out


def _sub_matrix(counts: Dict[str, Dict[str, int]]):
    """The substitution matrix's five bytes and {(ref, base): code}: for
    each reference base, its targets ranked by how often they occur."""
    matrix = bytearray()
    codes = {}
    for ref in "ACGTN":
        targets = _SUB_BASES[ref]
        ranked = sorted(range(4), key=lambda t: -counts[ref][targets[t]])
        byte = 0
        for rank, t in enumerate(ranked):
            byte |= rank << ((3 - t) * 2)
            codes[(ref, targets[t])] = rank
        matrix.append(byte)
    return bytes(matrix), codes


class _Record:
    """One read of the sample, and what its CRAM record needs."""

    def __init__(self, reads: dict, i: int, reference: np.ndarray):
        so, co = reads["seq_offsets"], reads["cigar_offsets"]
        self.name = reads["name"][i]
        self.flag = int(reads["flag"][i])
        if self.flag & 0x4:
            raise ValueError(f"{self.name}: unmapped reads are not written")
        self.ref_id = int(reads["ref_id"][i])
        self.pos = int(reads["pos"][i])
        self.mapq = int(reads["mapq"][i])
        self.mate_ref = int(reads["mate_ref_id"][i])
        self.mate_pos = int(reads["mate_pos"][i])
        self.tlen = int(reads["tlen"][i])
        self.seq = reads["seq"][so[i]:so[i + 1]].tobytes()
        self.qual = reads["qual"][so[i]:so[i + 1]].tobytes()
        self.cigar = list(zip(reads["cigar_ops"][co[i]:co[i + 1]].tolist(),
                              reads["cigar_lens"][co[i]:co[i + 1]].tolist()))
        self.tags = aux_items(reads["aux"][i])
        self.span = sum(n for op, n in self.cigar if op in _REF_OPS)
        self.end = self.pos + max(self.span, 1)
        self.cf = 0x1
        self.nf = -1
        self.attached = False
        self.features = self._features(reference)

    def _features(self, reference: np.ndarray):
        """(code, 1-based read position, payload) in read order; X
        payloads are (reference base, read base) until coded."""
        feats = []
        rp, gp = 0, self.pos
        for op, n in self.cigar:
            if op in (_M, _EQ, _X):
                for k in range(n):
                    ref = chr(reference[gp + k]) \
                        if gp + k < len(reference) else "N"
                    base = chr(self.seq[rp + k])
                    if base != ref:
                        feats.append(("X", rp + k + 1, (ref, base)))
                rp += n
                gp += n
            elif op == _I:
                feats.append(("I", rp + 1, self.seq[rp:rp + n]))
                rp += n
            elif op == _S:
                feats.append(("S", rp + 1, self.seq[rp:rp + n]))
                rp += n
            elif op == _D:
                feats.append(("D", rp + 1, n))
                gp += n
            elif op == _N:
                feats.append(("N", rp + 1, n))
                gp += n
            elif op == _H:
                feats.append(("H", rp + 1, n))
            elif op == _P:
                feats.append(("P", rp + 1, n))
        return feats

    def add_extra_features(self, serial: int) -> None:
        """B for every third substitution, i for one-base insertions, and
        on every fifth read a Q and a q inside its first long match."""
        feats = []
        n_sub = 0
        for code, p, payload in self.features:
            if code == "X":
                n_sub += 1
                if n_sub % 3 == 0:
                    code, payload = "B", (ord(payload[1]), self.qual[p - 1])
            elif code == "I" and len(payload) == 1:
                code, payload = "i", payload[0]
            feats.append((code, p, payload))
        if serial % 5 == 0:
            taken = {p for code, p, _ in feats}
            rp = 0
            for op, n in self.cigar:
                if op == _M and n >= 6:
                    p = rp + n // 2
                    if not taken & {p, p + 1, p + 2, p + 3}:
                        feats.append(("Q", p, self.qual[p - 1]))
                        feats.append(("q", p + 1, self.qual[p:p + 3]))
                    break
                if op in (_M, _I, _S, _EQ, _X):
                    rp += n
        self.features = sorted(feats, key=lambda f: f[1])


def _attach_mates(records: List[_Record]) -> None:
    """Attach the pairs of one slice whose mate fields the reader derives
    to the BAM's values: the mate's position and contig, the template
    length from the leftmost start to the rightmost end, the
    mate-reverse flags."""
    by_name: Dict[str, List[int]] = {}
    for k, r in enumerate(records):
        by_name.setdefault(r.name, []).append(k)
    for idx in by_name.values():
        if len(idx) != 2:
            continue
        a, b = records[idx[0]], records[idx[1]]
        if any(r.flag & 0xD0C != 0 or not r.flag & 0x1 for r in (a, b)):
            continue  # unmapped/secondary/supplementary/dup/mate unmapped
        if (a.mate_ref, a.mate_pos, b.mate_ref, b.mate_pos) != \
                (b.ref_id, b.pos, a.ref_id, a.pos):
            continue
        if bool(a.flag & 0x20) != bool(b.flag & 0x10) or \
                bool(b.flag & 0x20) != bool(a.flag & 0x10):
            continue
        tlen = max(a.pos + a.span, b.pos + b.span) - min(a.pos, b.pos)
        want = (tlen, -tlen) if a.pos <= b.pos else (-tlen, tlen)
        if (a.tlen, b.tlen) != want:
            continue
        a.cf |= 0x4
        a.nf = idx[1] - idx[0] - 1
        a.attached = b.attached = True


def _record_ops(r: _Record, last_pos: int, ap_delta: bool,
                tag_lines: Dict[tuple, int], sub_codes) -> List[tuple]:
    """The record's values in the order the reader reads them:
    (series, kind, value) with kind int, byte or array."""
    ops = [("BF", "int", r.flag & ~0x20 if r.attached else r.flag)]
    cf = r.cf if r.attached else r.cf | 0x2
    ops.append(("CF", "int", cf))
    ops.append(("RL", "int", len(r.seq)))
    ops.append(("AP", "int", r.pos + 1 - last_pos if ap_delta
                else r.pos + 1))
    ops.append(("RG", "int", -1))
    ops.append(("RN", "array", r.name.encode()))
    if not r.attached:
        ops.append(("MF", "int", (0x1 if r.flag & 0x20 else 0)
                    | (0x2 if r.flag & 0x8 else 0)))
        ops.append(("NS", "int", r.mate_ref))
        ops.append(("NP", "int", r.mate_pos + 1))
        ops.append(("TS", "int", r.tlen))
    elif r.cf & 0x4:
        ops.append(("NF", "int", r.nf))
    line = tuple((tag, typ) for tag, typ, _ in r.tags)
    ops.append(("TL", "int", tag_lines.setdefault(line, len(tag_lines))))
    for tag, typ, value in r.tags:
        if typ in "ZH":
            value = value[:-1]  # the NUL; BYTE_ARRAY_STOP ends it
        ops.append(((tag, typ), "array", value))
    ops.append(("FN", "int", len(r.features)))
    prev = 0
    for code, p, payload in r.features:
        ops.append(("FC", "byte", ord(code)))
        ops.append(("FP", "int", p - prev))
        prev = p
        if code == "X":
            ops.append(("BS", "byte", sub_codes[payload]))
        elif code == "B":
            ops.append(("BA", "byte", payload[0]))
            ops.append(("QS", "byte", payload[1]))
        elif code == "i":
            ops.append(("BA", "byte", payload))
        elif code == "Q":
            ops.append(("QS", "byte", payload))
        else:
            series = {"I": "IN", "S": "SC", "q": "QQ", "D": "DL", "N": "RS",
                      "H": "HC", "P": "PD"}[code]
            kind = "array" if code in "ISq" else "int"
            ops.append((series, kind, payload))
    ops.append(("MQ", "int", r.mapq))
    for q in r.qual:
        ops.append(("QS", "byte", q))
    return ops


def _container(records: List[_Record], ref_id: int, reference: np.ndarray,
               counter: int, layout: CramLayout) -> Tuple[bytes, int, int,
                                                          int, int]:
    """One data container of one slice; returns (bytes, start, span,
    landmark, slice size)."""
    start = min(r.pos for r in records) + 1
    span = max(r.end for r in records) - (start - 1)
    if layout.attach_mates:
        _attach_mates(records)
    sub_counts = {ref: {t: 0 for t in _SUB_BASES[ref]} for ref in "ACGTN"}
    for r in records:
        for code, _, payload in r.features:
            if code == "X":
                ref = payload[0] if payload[0] in _SUB_BASES else "N"
                if payload[1] in sub_counts[ref]:
                    sub_counts[ref][payload[1]] += 1
    matrix, sub_codes = _sub_matrix(sub_counts)
    ap_delta = not layout.core_codes
    tag_lines: Dict[tuple, int] = {}
    ops = []
    last = start
    for r in records:
        ops += _record_ops(r, last, ap_delta, tag_lines, sub_codes)
        last = r.pos + 1

    # Encodings from the values each series takes in this container.
    values: Dict[object, list] = {}
    for key, kind, value in ops:
        values.setdefault(key, []).append(
            len(value) if kind == "array" else value)
    content_ids: Dict[object, int] = {}

    def cid(key) -> int:
        return content_ids.setdefault(key, len(content_ids) + 1)

    encodings = {}
    for key, vals in values.items():
        if isinstance(key, tuple):  # a tag
            fixed = key[1] in _AUX_SIZE
            encodings[key] = _ArrayEncoding(
                key[1] in "ZH", vals, cid(key),
                _HUFFMAN if layout.core_codes and fixed else _EXTERNAL,
                cid((key, "len")))
        elif key in _ARRAY_SERIES:
            encodings[key] = _ArrayEncoding(
                key == "RN", vals, cid(key),
                _HUFFMAN if layout.core_codes else _EXTERNAL,
                cid((key, "len")))
        else:
            codec = _CORE_CODECS.get(key, _EXTERNAL) if layout.core_codes \
                else _EXTERNAL
            encodings[key] = _IntEncoding(codec, vals, cid(key))
    core = _Bits()
    external: Dict[int, bytearray] = {}
    for key in content_ids:
        external[content_ids[key]] = bytearray()
    for key, kind, value in ops:
        if kind == "array":
            encodings[key].put(value, core, external)
        else:
            encodings[key].put(value, kind == "byte", core, external)
    used = {k: v for k, v in external.items() if v}

    # The compression header.
    td = b"".join(b"".join(t.encode() + y.encode() for t, y in line)
                  + b"\x00" for line in tag_lines)
    pres = [b"RN\x01", b"AP" + bytes([ap_delta]),
            b"RR" + bytes([not layout.embed_reference]), b"SM" + matrix,
            b"TD" + itf8(len(td)) + td]
    series = [k for k in encodings if not isinstance(k, tuple)]
    tags = [k for k in encodings if isinstance(k, tuple)]
    ds = [k.encode() + encodings[k].spec() for k in series]
    tg = [itf8((ord(t[0]) << 16) | (ord(t[1]) << 8) | ord(y))
          + encodings[(t, y)].spec() for t, y in tags]

    def section(entries: List[bytes]) -> bytes:
        body = itf8(len(entries)) + b"".join(entries)
        return itf8(len(body)) + body

    comp = _block("raw", _CT_COMPRESSION_HEADER, 0,
                  section(pres) + section(ds) + section(tg))

    # The slice: its header, the core block, the external blocks.
    ref_span = reference[start - 1:start - 1 + span].tobytes()
    embedded_id = -1
    blocks = [_block(layout.method, _CT_CORE, 0, core.data())]
    ids = [0]
    for content_id in sorted(used):
        blocks.append(_block(layout.method, _CT_EXTERNAL, content_id,
                             bytes(used[content_id])))
        ids.append(content_id)
    if layout.embed_reference:
        embedded_id = len(content_ids) + 1
        blocks.append(_block(layout.method, _CT_EXTERNAL, embedded_id,
                             ref_span))
        ids.append(embedded_id)
    slice_head = itf8(ref_id) + itf8(start) + itf8(span) \
        + itf8(len(records)) + ltf8(counter) + itf8(len(blocks)) \
        + itf8(len(ids)) + b"".join(itf8(x) for x in ids) \
        + itf8(embedded_id) + hashlib.md5(ref_span).digest()
    slice_block = _block("raw", _CT_SLICE_HEADER, 0, slice_head)
    body = comp + slice_block + b"".join(blocks)
    n_bases = sum(len(r.seq) for r in records)
    head = _container_header(len(body), ref_id, start, span, len(records),
                             counter, n_bases, 2 + len(blocks), [len(comp)])
    return (head + body, start, span, len(comp),
            len(slice_block) + sum(len(b) for b in blocks))


def header_text(sample: dict) -> str:
    """The SAM header of the sample's BAM (`io.bam_writer.BamWriter`)."""
    text = "@HD\tVN:1.6\tSO:coordinate\n"
    for name, length in sample["contigs"]:
        text += f"@SQ\tSN:{name}\tLN:{length}\n"
    if sample["sample_name"]:
        text += f"@RG\tID:rg1\tSM:{sample['sample_name']}\n"
    return text


def write_cram(sample: dict, path: str,
               layout: CramLayout = CramLayout()) -> str:
    """The sample's reads as CRAM 3.0 at `path`, with `path`.crai."""
    if layout.method not in METHODS:
        raise ValueError(f"unknown block method {layout.method!r}")
    reads = sample["reads"]
    names = [n for n, _ in sample["contigs"]]
    out = bytearray(b"CRAM" + bytes([3, 0])
                    + b"synthetic".ljust(20, b"\x00"))
    text = header_text(sample).encode()
    header_block = _block("raw", _CT_FILE_HEADER, 0,
                          struct.pack("<i", len(text)) + text)
    out += _container_header(len(header_block), 0, 0, 0, 0, 0, 0, 1, [0])
    out += header_block
    crai = []
    counter = 0
    n = len(reads["name"])
    serial = 0
    i = 0
    while i < n:
        ref_id = int(reads["ref_id"][i])
        reference = sample["reference"][names[ref_id]]
        records = []
        while i < n and int(reads["ref_id"][i]) == ref_id and \
                len(records) < layout.records_per_container:
            record = _Record(reads, i, reference)
            if layout.extra_features:
                record.add_extra_features(serial)
            records.append(record)
            serial += 1
            i += 1
        offset = len(out)
        blob, start, span, landmark, size = _container(
            records, ref_id, reference, counter, layout)
        out += blob
        crai.append(f"{ref_id}\t{start}\t{span}\t{offset}\t{landmark}\t"
                    f"{size}\n")
        counter += len(records)
    out += _EOF
    with open(path, "wb") as f:
        f.write(out)
    with gzip.open(path + ".crai", "wt") as f:
        f.writelines(crai)
    return path

"""Indexed FASTA reading (faidx), including bgzipped FASTA.

Equivalent of nucleus's IndexedFastaReader / InMemoryFastaReader
(third_party/nucleus/io/reference.h:174,333). Bases are returned uppercased
as numpy uint8 ASCII arrays — the natural form for vectorized allele counting
and pileup encoding.

For bgzipped FASTA with a .gzi sidecar (htslib bgzf index), contigs
load lazily by inflating only the BGZF blocks that cover them —
partial loads like the reference's GetBases path. Without a .gzi the
whole file decompresses once into memory (a 3 Gbp genome is ~3 GB —
fine on a calling host, and it makes every query an O(1) slice).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from deepvariant_tpu_torch.core.types import ContigInfo, Range
from deepvariant_tpu_torch.io import bgzf


@dataclasses.dataclass
class FaidxRecord:
    name: str
    length: int
    offset: int
    line_bases: int
    line_width: int


def read_fai(path: str) -> List[FaidxRecord]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            out.append(
                FaidxRecord(
                    parts[0], int(parts[1]), int(parts[2]), int(parts[3]),
                    int(parts[4]),
                )
            )
    return out


class FastaReader:
    """Random-access reference reader; contigs held as uint8 arrays."""

    def __init__(self, path: str, fai_path: Optional[str] = None,
                 gzi_path: Optional[str] = None):
        import os

        self._path = path
        fai_path = fai_path or path + ".fai"
        self._records = read_fai(fai_path)
        self._raw: Optional[np.ndarray] = None
        self._gzi = None
        is_gz = path.endswith(".gz") or bgzf.is_bgzf(path)
        gzi_path = gzi_path or path + ".gzi"
        if is_gz and os.path.exists(gzi_path):
            # Partial loads: inflate only the blocks covering a contig.
            self._gzi = bgzf.read_gzi(gzi_path)
        elif is_gz:
            self._raw = np.frombuffer(bgzf.decompress_all(path), np.uint8)
        else:
            with open(path, "rb") as f:
                self._raw = np.frombuffer(f.read(), np.uint8)
        # Contigs materialize lazily on first query — a whole-genome
        # FASTA holds ~3Gbp and most processes touch few contigs.
        self._contigs: Dict[str, np.ndarray] = {}
        # gzi-backed readers additionally load in ~1 Mbp chunks: with
        # round-robin region sharding every shard touches every contig,
        # and whole-contig loads would inflate the whole genome in
        # every shard process (htslib-faidx-style region reads).
        self._chunks: Dict[tuple, np.ndarray] = {}
        self._rec_by_name = {r.name: r for r in self._records}

    def _load_contig(self, name: str) -> np.ndarray:
        bases = self._contigs.get(name)
        if bases is not None:
            return bases
        rec = self._rec_by_name[name]
        n_lines = (rec.length + rec.line_bases - 1) // rec.line_bases
        span_len = rec.length + n_lines * (
            rec.line_width - rec.line_bases
        )
        if self._raw is not None:
            span = self._raw[rec.offset : rec.offset + span_len]
        else:
            span = np.frombuffer(
                bgzf.decompress_range(
                    self._path, self._gzi, rec.offset,
                    rec.offset + span_len,
                ),
                np.uint8,
            )
        mat_len = n_lines * rec.line_width
        padded = np.full(mat_len, ord("\n"), np.uint8)
        padded[: len(span)] = span[:mat_len]
        mat = padded.reshape(n_lines, rec.line_width)
        bases = _UPPER_LUT[
            mat[:, : rec.line_bases].reshape(-1)[: rec.length]
        ]
        self._contigs[name] = bases
        return bases

    @property
    def contigs(self) -> List[ContigInfo]:
        return [
            ContigInfo(r.name, r.length, i)
            for i, r in enumerate(self._records)
        ]

    def contig_names(self) -> List[str]:
        return [r.name for r in self._records]

    def has_contig(self, name: str) -> bool:
        return name in self._rec_by_name

    def contig_length(self, name: str) -> int:
        rec = self._rec_by_name.get(name)
        if rec is None:
            raise KeyError(name)
        return rec.length

    def _chunk_size(self, rec) -> int:
        # Chunk boundaries align to FASTA line starts so the stripped
        # newline grid reshapes cleanly.
        return max(rec.line_bases, rec.line_bases * ((1 << 20) // rec.line_bases))

    def _load_chunk(self, rec, chunk_idx: int) -> np.ndarray:
        key = (rec.name, chunk_idx)
        arr = self._chunks.get(key)
        if arr is not None:
            return arr
        csize = self._chunk_size(rec)
        b0 = chunk_idx * csize
        b1 = min(rec.length, b0 + csize)
        byte0 = rec.offset + (b0 // rec.line_bases) * rec.line_width
        n_lines = (b1 - b0 + rec.line_bases - 1) // rec.line_bases
        byte1 = min(
            byte0 + n_lines * rec.line_width,
            rec.offset + ((rec.length + rec.line_bases - 1)
                          // rec.line_bases) * rec.line_width,
        )
        span = np.frombuffer(
            bgzf.decompress_range(self._path, self._gzi, byte0, byte1),
            np.uint8,
        )
        padded = np.full(n_lines * rec.line_width, ord("\n"), np.uint8)
        padded[: len(span)] = span[: n_lines * rec.line_width]
        mat = padded.reshape(n_lines, rec.line_width)
        arr = _UPPER_LUT[mat[:, : rec.line_bases].reshape(-1)[: b1 - b0]]
        self._chunks[key] = arr
        return arr

    def bases(self, region: Range) -> np.ndarray:
        """Uppercased ASCII bases for region as uint8[len(region)]."""
        name = region.reference_name
        arr = self._contigs.get(name)
        if arr is None and self._gzi is not None:
            rec = self._rec_by_name[name]
            start = max(0, region.start)
            end = min(rec.length, region.end)
            if end <= start:
                return np.empty(0, np.uint8)
            csize = self._chunk_size(rec)
            c0, c1 = start // csize, (end - 1) // csize
            parts = [
                self._load_chunk(rec, c) for c in range(c0, c1 + 1)
            ]
            block = parts[0] if len(parts) == 1 else np.concatenate(parts)
            off = start - c0 * csize
            return block[off : off + (end - start)]
        if arr is None:
            arr = self._load_contig(name)
        start = max(0, region.start)
        end = min(len(arr), region.end)
        return arr[start:end]

    def query(self, region: Range) -> str:
        return self.bases(region).tobytes().decode()

    def is_valid(self, region: Range) -> bool:
        rec = self._rec_by_name.get(region.reference_name)
        return (
            rec is not None
            and 0 <= region.start < region.end <= rec.length
        )


class InMemoryFasta:
    """Reference built from literal sequences (tests; reference.h:333)."""

    def __init__(self, contigs: Dict[str, str], starts: Optional[Dict[str, int]] = None):
        # `starts` allows contig fragments anchored at an offset (like
        # InMemoryFastaReader's RefFastaSeq start).
        self._starts = dict(starts or {})
        self._contigs = {
            name: np.frombuffer(seq.upper().encode(), np.uint8)
            for name, seq in contigs.items()
        }

    @property
    def contigs(self) -> List[ContigInfo]:
        return [
            ContigInfo(name, self._starts.get(name, 0) + len(arr), i)
            for i, (name, arr) in enumerate(self._contigs.items())
        ]

    def contig_names(self) -> List[str]:
        return list(self._contigs)

    def has_contig(self, name: str) -> bool:
        return name in self._contigs

    def contig_length(self, name: str) -> int:
        return self._starts.get(name, 0) + len(self._contigs[name])

    def bases(self, region: Range) -> np.ndarray:
        arr = self._contigs[region.reference_name]
        off = self._starts.get(region.reference_name, 0)
        start = max(0, region.start - off)
        end = max(start, region.end - off)
        return arr[start : min(end, len(arr))]

    def query(self, region: Range) -> str:
        return self.bases(region).tobytes().decode()

    def is_valid(self, region: Range) -> bool:
        if region.reference_name not in self._contigs:
            return False
        off = self._starts.get(region.reference_name, 0)
        return (
            off <= region.start < region.end
            <= off + len(self._contigs[region.reference_name])
        )


_UPPER_LUT = np.arange(256, dtype=np.uint8)
for _c in range(ord("a"), ord("z") + 1):
    _UPPER_LUT[_c] = _c - 32

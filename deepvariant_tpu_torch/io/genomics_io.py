"""BED / bedGraph / FASTQ / GFF readers and writers.

The port's copy of `deepvariant_tpu.io.genomics_io`: plain and gzipped
text, so every file it writes equals the JAX package's byte for byte.

Nucleus parity (third_party/nucleus/io/{bed,bedgraph,fastq,gff}*): each
format gets a record dataclass plus reader/writer supporting plain and
(b)gzip-compressed files.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, Iterator, List, Optional, Sequence, TextIO, Tuple


def _open_text(path: str, mode: str = "rt"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


# ---------------------------------------------------------------------------
# BED (nucleus bed_reader/bed_writer; BedRecord proto bed.proto)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BedRecord:
    reference_name: str
    start: int
    end: int
    name: str = ""
    score: float = 0.0
    strand: str = "."
    thick_start: int = 0
    thick_end: int = 0
    item_rgb: str = ""
    block_count: int = 0
    block_sizes: str = ""
    block_starts: str = ""


class BedReader:
    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[BedRecord]:
        with _open_text(self.path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith(
                    ("#", "track", "browser")
                ):
                    continue
                fields = line.split("\t")
                rec = BedRecord(
                    fields[0], int(fields[1]), int(fields[2])
                )
                if len(fields) > 3:
                    rec.name = fields[3]
                if len(fields) > 4:
                    rec.score = float(fields[4])
                if len(fields) > 5:
                    rec.strand = fields[5]
                if len(fields) > 6:
                    rec.thick_start = int(fields[6])
                if len(fields) > 7:
                    rec.thick_end = int(fields[7])
                if len(fields) > 8:
                    rec.item_rgb = fields[8]
                if len(fields) > 9:
                    rec.block_count = int(fields[9])
                if len(fields) > 10:
                    rec.block_sizes = fields[10]
                if len(fields) > 11:
                    rec.block_starts = fields[11]
                yield rec


class BedWriter:
    def __init__(self, path: str, num_fields: int = 3):
        self._f = _open_text(path, "wt")
        self.num_fields = num_fields

    def write(self, rec: BedRecord):
        fields = [
            rec.reference_name, str(rec.start), str(rec.end), rec.name,
            f"{rec.score:g}", rec.strand, str(rec.thick_start),
            str(rec.thick_end), rec.item_rgb, str(rec.block_count),
            rec.block_sizes, rec.block_starts,
        ]
        self._f.write("\t".join(fields[: self.num_fields]) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# bedGraph (nucleus bedgraph_reader/writer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BedGraphRecord:
    reference_name: str
    start: int
    end: int
    data_value: float


class BedGraphReader:
    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[BedGraphRecord]:
        with _open_text(self.path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith(("#", "track")):
                    continue
                chrom, start, end, value = line.split("\t")[:4]
                yield BedGraphRecord(
                    chrom, int(start), int(end), float(value)
                )


class BedGraphWriter:
    def __init__(self, path: str):
        self._f = _open_text(path, "wt")

    def write(self, rec: BedGraphRecord):
        self._f.write(
            f"{rec.reference_name}\t{rec.start}\t{rec.end}\t"
            f"{rec.data_value:g}\n"
        )

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# FASTQ (nucleus fastq_reader/writer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FastqRecord:
    id: str
    description: str
    sequence: str
    quality: str


class FastqReader:
    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[FastqRecord]:
        with _open_text(self.path) as f:
            while True:
                header = f.readline()
                if not header:
                    break
                header = header.rstrip("\n")
                if not header:
                    continue
                if not header.startswith("@"):
                    raise ValueError(
                        f"malformed FASTQ header: {header!r}"
                    )
                seq = f.readline().rstrip("\n")
                plus = f.readline().rstrip("\n")
                if not plus.startswith("+"):
                    raise ValueError(f"malformed FASTQ plus: {plus!r}")
                qual = f.readline().rstrip("\n")
                parts = header[1:].split(None, 1)
                yield FastqRecord(
                    parts[0], parts[1] if len(parts) > 1 else "",
                    seq, qual,
                )


class FastqWriter:
    def __init__(self, path: str):
        self._f = _open_text(path, "wt")

    def write(self, rec: FastqRecord):
        header = "@" + rec.id
        if rec.description:
            header += " " + rec.description
        self._f.write(
            f"{header}\n{rec.sequence}\n+\n{rec.quality}\n"
        )

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# GFF (nucleus gff_reader/writer; gff.proto)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GffRecord:
    reference_name: str
    source: str
    type: str
    start: int   # 0-based inclusive (proto convention)
    end: int     # 0-based exclusive
    score: Optional[float] = None
    strand: str = "."
    phase: Optional[int] = None
    attributes: Dict[str, str] = dataclasses.field(default_factory=dict)


class GffReader:
    def __init__(self, path: str):
        self.path = path

    def __iter__(self) -> Iterator[GffRecord]:
        with _open_text(self.path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                fields = line.split("\t")
                attributes = {}
                if len(fields) > 8 and fields[8] != ".":
                    for item in fields[8].split(";"):
                        item = item.strip()
                        if not item:
                            continue
                        if "=" in item:
                            k, v = item.split("=", 1)
                            attributes[k] = v
                yield GffRecord(
                    reference_name=fields[0],
                    source=fields[1],
                    type=fields[2],
                    start=int(fields[3]) - 1,
                    end=int(fields[4]),
                    score=(None if fields[5] == "."
                           else float(fields[5])),
                    strand=fields[6],
                    phase=None if fields[7] == "." else int(fields[7]),
                    attributes=attributes,
                )


class GffWriter:
    def __init__(self, path: str, header_lines: Sequence[str] = ()):
        self._f = _open_text(path, "wt")
        self._f.write("##gff-version 3.2.1\n")
        for line in header_lines:
            self._f.write(line.rstrip("\n") + "\n")

    def write(self, rec: GffRecord):
        attrs = ";".join(
            f"{k}={v}" for k, v in rec.attributes.items()
        ) or "."
        self._f.write("\t".join([
            rec.reference_name, rec.source or ".", rec.type or ".",
            str(rec.start + 1), str(rec.end),
            "." if rec.score is None else f"{rec.score:g}",
            rec.strand or ".",
            "." if rec.phase is None else str(rec.phase),
            attrs,
        ]) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

"""Genomic interval sets and partitioning (reference: nucleus util/ranges.py).

RangeSet supports intersection, overlap queries, and fixed-size partitioning —
implemented on sorted numpy endpoint arrays instead of an interval tree, which
is both simpler and faster for the batch-query patterns this framework uses.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from deepvariant_tpu_torch.core.types import ContigInfo, Range


def _merge_sorted(intervals: List[tuple]) -> List[tuple]:
    """Merge overlapping/adjacent sorted (start, end) tuples."""
    merged: List[tuple] = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


class RangeSet:
    """A set of genomic intervals, merged per contig (ranges.py:64).

    Iteration order follows the nucleus contract
    (ranges_test.py:505-529): contig order comes from the `contigs`
    metadata when provided (FASTA order), else contig names sort
    lexicographically; within a contig, intervals sort by position."""

    def __init__(
        self,
        ranges: Iterable[Range] = (),
        contigs: Optional[Sequence[ContigInfo]] = None,
    ):
        by_contig: Dict[str, List[tuple]] = {}
        for r in ranges:
            if r.end > r.start:
                by_contig.setdefault(r.reference_name, []).append(
                    (r.start, r.end)
                )
        if contigs is not None:
            known = [c.name for c in contigs]
            unknown = set(by_contig) - set(known)
            if unknown:
                raise ValueError(
                    f"ranges on contigs missing from metadata: "
                    f"{sorted(unknown)}"
                )
            order = [n for n in known if n in by_contig]
        else:
            order = sorted(by_contig)
        self._starts: Dict[str, np.ndarray] = {}
        self._ends: Dict[str, np.ndarray] = {}
        for contig in order:
            intervals = by_contig[contig]
            intervals.sort()
            merged = _merge_sorted(intervals)
            self._starts[contig] = np.array(
                [s for s, _ in merged], dtype=np.int64
            )
            self._ends[contig] = np.array(
                [e for _, e in merged], dtype=np.int64
            )

    # -- construction helpers -------------------------------------------------

    @staticmethod
    def from_regions(
        specs: Sequence[str], contigs: Optional[Sequence[ContigInfo]] = None
    ) -> "RangeSet":
        """Parse 'chr20', 'chr20:1-100', or BED file paths."""
        contig_len = {c.name: c.n_bases for c in contigs or []}
        out: List[Range] = []
        for spec in specs:
            if spec.endswith(".bed") or spec.endswith(".bed.gz"):
                out.extend(read_bed(spec))
            elif ":" in spec:
                out.append(Range.from_region_string(spec))
            else:
                if spec not in contig_len:
                    raise ValueError(
                        f"region {spec!r} is a bare contig but no contig "
                        "metadata was provided"
                    )
                out.append(Range(spec, 0, contig_len[spec]))
        return RangeSet(out, contigs if contigs else None)

    @staticmethod
    def from_contigs(contigs: Sequence[ContigInfo]) -> "RangeSet":
        return RangeSet(
            (Range(c.name, 0, c.n_bases) for c in contigs), contigs
        )

    @classmethod
    def _ordered(
        cls, ranges: Iterable[Range], order: Sequence[str]
    ) -> "RangeSet":
        """Build a set whose contig order follows `order` (used by the
        set operations to preserve the left operand's FASTA order)."""
        out = cls(ranges)
        pos = {name: i for i, name in enumerate(order)}
        for attr in ("_starts", "_ends"):
            cur = getattr(out, attr)
            setattr(out, attr, {
                k: cur[k]
                for k in sorted(cur, key=lambda n: pos.get(n, len(pos)))
            })
        return out

    # -- queries ---------------------------------------------------------------

    def __bool__(self) -> bool:
        return bool(self._starts)

    def __len__(self) -> int:
        return sum(len(v) for v in self._starts.values())

    def __iter__(self) -> Iterator[Range]:
        for contig in self._starts:
            for s, e in zip(self._starts[contig], self._ends[contig]):
                yield Range(contig, int(s), int(e))

    def total_bp(self) -> int:
        return int(
            sum((self._ends[c] - self._starts[c]).sum() for c in self._starts)
        )

    def overlaps(self, contig: str, pos: int) -> bool:
        """Is position contained in any interval?"""
        starts = self._starts.get(contig)
        if starts is None:
            return False
        idx = int(np.searchsorted(starts, pos, side="right")) - 1
        return idx >= 0 and pos < self._ends[contig][idx]

    def overlaps_range(self, r: Range) -> bool:
        starts = self._starts.get(r.reference_name)
        if starts is None:
            return False
        ends = self._ends[r.reference_name]
        idx = int(np.searchsorted(starts, r.end, side="left"))
        return bool(idx > 0 and r.start < ends[idx - 1] or (
            idx < len(starts) and starts[idx] < r.end
        ))

    def envelops(self, contig: str, start: int, end: int) -> bool:
        """Is [start, end) fully contained in a single interval?"""
        starts = self._starts.get(contig)
        if starts is None:
            return False
        idx = int(np.searchsorted(starts, start, side="right")) - 1
        return idx >= 0 and end <= self._ends[contig][idx]

    def variant_overlaps(self, variant) -> bool:
        return self.overlaps_range(
            Range(variant.reference_name, variant.start, variant.end)
        )

    # -- set ops ---------------------------------------------------------------

    def intersection(self, other: "RangeSet") -> "RangeSet":
        out: List[Range] = []
        for contig in self._starts:
            if contig not in other._starts:
                continue
            a_s, a_e = self._starts[contig], self._ends[contig]
            b_s, b_e = other._starts[contig], other._ends[contig]
            i = j = 0
            while i < len(a_s) and j < len(b_s):
                lo = max(a_s[i], b_s[j])
                hi = min(a_e[i], b_e[j])
                if lo < hi:
                    out.append(Range(contig, int(lo), int(hi)))
                if a_e[i] < b_e[j]:
                    i += 1
                else:
                    j += 1
        return RangeSet._ordered(out, list(self._starts))

    def exclude_regions(self, exclude: "RangeSet") -> "RangeSet":
        """Subtract `exclude` from this set."""
        out: List[Range] = []
        for contig in self._starts:
            ex_s = exclude._starts.get(contig)
            if ex_s is None:
                out.extend(
                    Range(contig, int(s), int(e))
                    for s, e in zip(self._starts[contig], self._ends[contig])
                )
                continue
            ex_e = exclude._ends[contig]
            for s, e in zip(self._starts[contig], self._ends[contig]):
                cur = int(s)
                lo = int(np.searchsorted(ex_e, cur, side="right"))
                k = lo
                while cur < e and k < len(ex_s) and ex_s[k] < e:
                    if ex_s[k] > cur:
                        out.append(Range(contig, cur, int(ex_s[k])))
                    cur = max(cur, int(ex_e[k]))
                    k += 1
                if cur < e:
                    out.append(Range(contig, cur, int(e)))
        return RangeSet._ordered(out, list(self._starts))

    # -- partitioning ------------------------------------------------------------

    def partition(self, max_size: int) -> Iterator[Range]:
        """Split every interval into chunks of at most max_size bp
        (reference: ranges.py RangeSet.partition; used for ~1000bp regions)."""
        if max_size <= 0:
            raise ValueError(f"partition size must be positive, got {max_size}")
        for r in self:
            for pos in range(r.start, r.end, max_size):
                yield Range(r.reference_name, pos, min(pos + max_size, r.end))


def partition_calling_regions(
    calling_regions: "RangeSet", num_partitions: int
) -> List[List[Range]]:
    """Split the calling space into exactly `num_partitions` contiguous
    groups of windows (calling_regions_utils.py:97-149): chunk at
    total_bp // N, group greedily until a group exceeds the chunk size,
    then halve the largest groups until N groups exist, preserving
    genome order."""
    if num_partitions <= 0:
        raise ValueError(f"num_partitions must be positive: {num_partitions}")
    total_bps = sum(len(r) for r in calling_regions)
    max_partition_size = max(1, total_bps // num_partitions)
    partitions = list(calling_regions.partition(max_partition_size))

    groups: List[List[Range]] = []
    current: List[Range] = []
    for part in partitions:
        if sum(len(p) for p in current) > max_partition_size:
            groups.append(current)
            current = []
        current.append(part)
    if current:
        groups.append(current)

    order = {id(p): i for i, p in enumerate(partitions)}
    while len(groups) < num_partitions:
        groups.sort(key=lambda ps: sum(len(p) for p in ps))
        largest = groups.pop()
        mid = len(largest) // 2
        groups.extend([largest[:mid], largest[mid:]])
    # Halving can strand an empty half when a group has one window.
    groups = [g for g in groups if g]
    groups.sort(key=lambda ps: order[id(ps[0])])
    return groups


def read_bed(path: str) -> List[Range]:
    """Read a BED (optionally gzipped) into Ranges."""
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    out = []
    with opener(path, "rt") as f:
        for line in f:
            if not line.strip() or line.startswith(("#", "track", "browser")):
                continue
            parts = line.split("\t")
            out.append(Range(parts[0], int(parts[1]), int(parts[2])))
    return out


_REGION_SEP = re.compile(r"[ ,]+")


def parse_region_specs(flag_value: Optional[str]) -> Optional[List[str]]:
    """Split a --regions flag value ('chr20 chr21' or 'a.bed,chr1:1-5')."""
    if not flag_value:
        return None
    return [s for s in _REGION_SEP.split(flag_value.strip()) if s]

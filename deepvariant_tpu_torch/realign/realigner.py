"""Realigner orchestration: windows -> assembly -> read realignment.

Behavior parity with reference realigner.py:675-860 (`Realigner`):
  * select candidate windows (window_selector);
  * per window (skipping ones over max_window_size or off-reference):
    build the De Bruijn graph, keep windows whose candidate haplotypes
    differ from the plain reference;
  * assign each read to its maximally-overlapping window
    (assign_reads_to_assembled_regions, :578-600);
  * fast-pass align each window's reads against `prefix+hap+suffix`
    haplotypes over a +/-REF_ALIGN_MARGIN reference span
    (call_fast_pass_aligner, :741-790);
  * optionally split reads at N (SKIP) cigar ops first
    (split_reads, :625-672).

The port's copy of `deepvariant_tpu.realign.realigner`; all of it runs on
the host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.core.types import Range, Read
from deepvariant_tpu_torch.core.types import CHAR_TO_PROTO_OP
from deepvariant_tpu_torch.io.bam import ReadBatch
from deepvariant_tpu_torch.realign import debruijn_graph
from deepvariant_tpu_torch.realign import window_selector
from deepvariant_tpu_torch.realign.config import (
    MIN_SPLIT_LEN,
    REF_ALIGN_MARGIN,
    RealignerOptions,
)
from deepvariant_tpu_torch.realign.fast_pass_aligner import FastPassAligner

OP_N = CHAR_TO_PROTO_OP["N"]
OPS_CONSUME_READ = frozenset(
    CHAR_TO_PROTO_OP[c] for c in "MIS=X"
)
OPS_CONSUME_REF = frozenset(
    CHAR_TO_PROTO_OP[c] for c in "MDN=X"
)


@dataclasses.dataclass
class CandidateHaplotypes:
    """realigner_pb2.CandidateHaplotypes equivalent."""

    span: Range
    haplotypes: List[str]


class AssemblyRegion:
    """A window plus the reads assigned to it (realigner.py:516-575)."""

    def __init__(self, candidate_haplotypes: CandidateHaplotypes):
        self.candidate_haplotypes = candidate_haplotypes
        self.reads: List[Read] = []
        self._read_span: Optional[Tuple[int, int]] = None

    @property
    def haplotypes(self) -> List[str]:
        return self.candidate_haplotypes.haplotypes

    @property
    def region(self) -> Range:
        return self.candidate_haplotypes.span

    @property
    def read_span(self) -> Optional[Range]:
        if self._read_span is None:
            return None
        return Range(self.region.reference_name, *self._read_span)

    def add_read(self, read: Read):
        self.reads.append(read)
        start, end = read.position, read.end()
        if self._read_span is None:
            self._read_span = (start, end)
        else:
            self._read_span = (
                min(self._read_span[0], start),
                max(self._read_span[1], end),
            )


def _overlap_len(a_start: int, a_end: int, r: Range) -> int:
    return max(0, min(a_end, r.end) - max(a_start, r.start))


def assign_reads_to_assembled_regions(
    assembled_regions: List[AssemblyRegion], reads: Sequence[Read]
) -> List[Read]:
    """Max-overlap assignment; returns unassigned reads."""
    unassigned = []
    for read in reads:
        start, end = read.position, read.end()
        best_i, best_overlap = None, 0
        for i, ar in enumerate(assembled_regions):
            ov = _overlap_len(start, end, ar.region)
            if ov > best_overlap:
                best_overlap = ov
                best_i = i
        if best_i is not None:
            assembled_regions[best_i].add_read(read)
        else:
            unassigned.append(read)
    return unassigned


def split_reads(reads: Sequence[Read]) -> List[Read]:
    """Split reads at N (SKIP) cigar ops (realigner.py:625-672);
    parts shorter than MIN_SPLIT_LEN are dropped."""
    out: List[Read] = []
    for read in reads:
        if not any(op == OP_N for op, _ in read.cigar):
            out.append(read)
            continue
        part = 0
        cur_cigar: List[Tuple[int, int]] = []
        cur_start = read.position
        read_offset = 0
        part_read_start = 0
        ref_pos = read.position

        def emit(cigar, start, r_start, r_end, part_idx):
            if r_end - r_start >= MIN_SPLIT_LEN and cigar:
                out.append(dataclasses.replace(
                    read,
                    fragment_name=f"{read.fragment_name}_p{part_idx}",
                    position=start,
                    cigar=list(cigar),
                    aligned_sequence=read.aligned_sequence[r_start:r_end],
                    aligned_quality=read.aligned_quality[r_start:r_end],
                ))

        for op, length in read.cigar:
            if op == OP_N:
                emit(cur_cigar, cur_start, part_read_start, read_offset,
                     part)
                part += 1
                ref_pos += length
                cur_start = ref_pos
                cur_cigar = []
                part_read_start = read_offset
            else:
                cur_cigar.append((op, length))
                if op in OPS_CONSUME_READ:
                    read_offset += length
                if op in OPS_CONSUME_REF:
                    ref_pos += length
        emit(cur_cigar, cur_start, part_read_start, read_offset, part)
    return out


class Realigner:
    """Main realigner (reference realigner.py:675)."""

    def __init__(self, config: Optional[RealignerOptions], ref_reader):
        self.config = config or RealignerOptions()
        self.ref_reader = ref_reader

    def _ref_query(self, region: Range) -> str:
        return self.ref_reader.query(region)

    def call_debruijn_graph(
        self, windows: Sequence[Range], reads: Sequence[Read]
    ) -> List[CandidateHaplotypes]:
        """Assemble each window (realigner.py:706-739)."""
        windows_haplotypes = []
        for window in windows:
            if window.end - window.start > \
                    self.config.ws_config.max_window_size:
                continue
            if not self.ref_reader.is_valid(window):
                continue
            ref = self._ref_query(window)
            window_reads = [
                r for r in reads
                if r.position < window.end and r.end() > window.start
            ]
            candidate_haplotypes = debruijn_graph.assemble_haplotypes(
                ref, window_reads, self.config.dbg_config
            )
            if candidate_haplotypes is None:
                candidate_haplotypes = [ref]
            if candidate_haplotypes and candidate_haplotypes != [ref]:
                windows_haplotypes.append(
                    CandidateHaplotypes(window, candidate_haplotypes)
                )
        return windows_haplotypes

    def call_fast_pass_aligner(
        self, assembled_region: AssemblyRegion
    ) -> List[Read]:
        """Align one window's reads (realigner.py:741-790)."""
        if not assembled_region.reads:
            return []
        contig = assembled_region.region.reference_name
        contig_n_bases = self.ref_reader.contig_length(contig)
        read_span = assembled_region.read_span
        ref_start = max(
            0,
            min(read_span.start, assembled_region.region.start)
            - REF_ALIGN_MARGIN,
        )
        ref_end = min(
            contig_n_bases,
            max(read_span.end, assembled_region.region.end)
            + REF_ALIGN_MARGIN,
        )
        ref_prefix = self._ref_query(
            Range(contig, ref_start, assembled_region.region.start)
        )
        ref = self._ref_query(assembled_region.region)
        if ref_end <= assembled_region.region.end:
            return assembled_region.reads
        ref_suffix = self._ref_query(
            Range(contig, assembled_region.region.end, ref_end)
        )
        ref_seq = ref_prefix + ref + ref_suffix

        aligner = FastPassAligner(self.config.aln_config)
        aligner.normalize_reads = self.config.normalize_reads
        aligner.options.read_size = len(
            assembled_region.reads[0].aligned_sequence
        )
        aligner.options.force_alignment = False
        aligner.set_reference(ref_seq)
        aligner.set_ref_start(contig, ref_start)
        aligner.set_ref_prefix_len(len(ref_prefix))
        aligner.set_ref_suffix_len(len(ref_suffix))
        aligner.set_haplotypes([
            ref_prefix + target + ref_suffix
            for target in assembled_region.haplotypes
        ])
        return aligner.realign_reads(assembled_region.reads)

    def realign_reads(
        self, reads: Sequence[Read], region: Range,
        batch: Optional[ReadBatch] = None,
    ) -> Tuple[List[CandidateHaplotypes], List[Read]]:
        """Main entry (realigner.py:791-860). NOTE: output reads may be
        reordered relative to the input.

        `batch` may carry the columnar form of `reads` (same order) to
        skip the window selector's SoA rebuild; it is dropped when N
        splits change the read list."""
        if not reads:
            return [], []
        if self.config.split_skip_reads:
            new_reads = split_reads(reads)
            if len(new_reads) != len(reads) or any(
                a is not b for a, b in zip(new_reads, reads)
            ):
                batch = None
            reads = new_reads
            if not reads:
                return [], []

        if batch is None or len(batch) != len(reads):
            batch = ReadBatch.from_reads(
                list(reads), [region.reference_name]
            )
        candidate_windows = window_selector.select_windows(
            self.config.ws_config,
            self._ref_query,
            batch,
            region,
            contig_length=self.ref_reader.contig_length(
                region.reference_name
            ),
        )
        candidate_haplotypes = self.call_debruijn_graph(
            candidate_windows, reads
        )
        assembled_regions = [
            AssemblyRegion(ch) for ch in candidate_haplotypes
        ]
        realigned_reads = assign_reads_to_assembled_regions(
            assembled_regions, reads
        )
        for assembled_region in assembled_regions:
            realigned_reads.extend(
                self.call_fast_pass_aligner(assembled_region)
            )
        return candidate_haplotypes, realigned_reads

"""Merge per-shard read-phasing outputs into global haplotypes.

The port's copy of `deepvariant_tpu.phasing.merge_phased_reads`, with
its command line:

  python -m deepvariant_tpu_torch.phasing.merge_phased_reads \\
    --input_path phase@2.tsv --output_path merged.tsv \\
    --switches_output_path switches.tsv

It reads the `--output_local_read_phasing` TSVs of the make_examples
shards and writes the merged phases and the switches TSV that
`postprocess_variants --phased_reads_switches_output_path` reads.
Behavior parity with reference merge_phased_reads.{h,cc,main}:
  * per-shard TSV inputs (fragment_name, phase, region_order);
  * groups keyed by (shard, region) merged in make_examples processing
    order (region-major, shard round-robin, MergeReads :263-297);
  * each new group is compared to the previously merged group by
    shared-read phase agreement — a majority of mismatches (margin >= 2)
    flips the group's phases (CompareGroups :183-227, SWITCH), a tie
    margin < 2 is NOT_ENOUGH_OVERLAP;
  * after merging, per-read majority voting corrects inconsistent
    phases (CorrectPhasing :316-340).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import os
from typing import Dict, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs


class ComparisonResult(enum.Enum):
    # Integer values are the wire format of the switches TSV consumed
    # by phase-set stitching (merge_phased_reads.h:135-139,
    # postprocess_variants.h:54-58).
    MATCH = 0
    SWITCH = 1
    NOT_ENOUGH_OVERLAP = 2


@dataclasses.dataclass
class UnmergedRead:
    fragment_name: str
    phase: int
    region_order: int
    shard: int


@dataclasses.dataclass
class MergedPhaseRead:
    fragment_name: str
    phase: int = 0
    phase_dist: Dict[int, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int)
    )


class Merger:
    """Phased-read merger (merge_phased_reads.h:106)."""

    def __init__(self):
        self.unmerged_reads: List[UnmergedRead] = []
        self.merged_reads: List[MergedPhaseRead] = []
        self._merged_map: Dict[str, int] = {}
        self.groups: Dict[Tuple[int, int], Dict[int, int]] = {}
        self.num_shards = 0
        self.switches: List[Tuple[int, int, ComparisonResult]] = []

    # -- loading ------------------------------------------------------------

    def _merged_index(self, fragment_name: str) -> int:
        idx = self._merged_map.get(fragment_name)
        if idx is None:
            idx = len(self.merged_reads)
            self.merged_reads.append(MergedPhaseRead(fragment_name))
            self._merged_map[fragment_name] = idx
        return idx

    def add_reads(self, reads: Sequence[UnmergedRead]):
        for read in reads:
            self.unmerged_reads.append(read)
            self._merged_index(read.fragment_name)
            self.num_shards = max(self.num_shards, read.shard + 1)

    def load_from_files(self, input_spec: str):
        """Per-shard TSVs: fragment_name<TAB>phase<TAB>region_order."""
        for shard, path in enumerate(glob_sharded_inputs(input_spec)):
            with open(path) as f:
                reads = []
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("fragment_name"):
                        continue
                    name, phase, region = line.split("\t")[:3]
                    reads.append(UnmergedRead(
                        name, int(phase), int(region), shard
                    ))
                self.add_reads(reads)

    # -- merging ------------------------------------------------------------

    def _group_reads(self):
        self.groups = {}
        for index, read in enumerate(self.unmerged_reads):
            group = self.groups.setdefault(
                (read.shard, read.region_order), {}
            )
            group[self._merged_map[read.fragment_name]] = index

    def _compare_groups(
        self, group_1: Tuple[int, int], group_2: Tuple[int, int]
    ) -> ComparisonResult:
        g1 = self.groups.get(group_1)
        g2 = self.groups.get(group_2)
        if g1 is None or g2 is None:
            return ComparisonResult.NOT_ENOUGH_OVERLAP
        mismatch = match = 0
        for merged_idx, idx2 in g2.items():
            idx1 = g1.get(merged_idx)
            if idx1 is None:
                continue
            p1 = self.unmerged_reads[idx1].phase
            p2 = self.unmerged_reads[idx2].phase
            if p1 == 0 or p2 == 0:
                continue
            if p1 != p2:
                mismatch += 1
            else:
                match += 1
        if abs(mismatch - match) < 2:
            return ComparisonResult.NOT_ENOUGH_OVERLAP
        return ComparisonResult.SWITCH if mismatch > match \
            else ComparisonResult.MATCH

    def _reverse_phasing(self, group: Tuple[int, int]):
        for idx in self.groups[group].values():
            if self.unmerged_reads[idx].phase > 0:
                self.unmerged_reads[idx].phase = \
                    3 - self.unmerged_reads[idx].phase

    def _merge_group(self, group: Tuple[int, int]):
        for merged_idx, unmerged_idx in self.groups[group].items():
            merged = self.merged_reads[merged_idx]
            phase = self.unmerged_reads[unmerged_idx].phase
            if merged.phase == 0:
                merged.phase = phase
            merged.phase_dist[phase] += 1

    def merge_reads(self, switches_output_path: Optional[str] = None):
        """MergeReads (:263-297): region-major, shard round-robin."""
        self._group_reads()
        num_groups = len(self.groups)
        processed = 0
        cur_region = min(
            (r for _, r in self.groups), default=0
        )
        prev_group: Optional[Tuple[int, int]] = None
        while processed < num_groups:
            for shard in range(self.num_shards):
                key = (shard, cur_region)
                if key not in self.groups:
                    continue
                result = (
                    self._compare_groups(prev_group, key)
                    if prev_group is not None
                    else ComparisonResult.NOT_ENOUGH_OVERLAP
                )
                if result == ComparisonResult.SWITCH:
                    self._reverse_phasing(key)
                self.switches.append((shard, cur_region, result))
                self._merge_group(key)
                processed += 1
                prev_group = key
            cur_region += 1
        if switches_output_path:
            with open(switches_output_path, "w") as f:
                for shard, region, result in self.switches:
                    f.write(f"{shard}\t{region}\t{result.value}\n")

    def correct_phasing(self) -> int:
        """Per-read majority vote (:316-340)."""
        corrected = 0
        for read in self.merged_reads:
            c1 = read.phase_dist.get(1, 0)
            c2 = read.phase_dist.get(2, 0)
            old = read.phase
            if c1 == c2:
                read.phase = 0
            else:
                read.phase = 1 if c1 > c2 else 2
            if read.phase != old:
                corrected += 1
        return corrected

    def write_merged(self, output_path: str):
        with open(output_path, "w") as f:
            f.write("fragment_name\tphase\n")
            for read in self.merged_reads:
                f.write(f"{read.fragment_name}\t{read.phase}\n")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("merge_phased_reads")
    p.add_argument("--input_path", required=True,
                   help="sharded TSV spec (name@N.tsv)")
    p.add_argument("--output_path", required=True)
    p.add_argument("--switches_output_path", default="")
    args = p.parse_args(argv)
    merger = Merger()
    merger.load_from_files(args.input_path)
    merger.merge_reads(args.switches_output_path or None)
    corrected = merger.correct_phasing()
    merger.write_merged(args.output_path)
    print(
        f"merge_phased_reads: {len(merger.merged_reads)} reads merged, "
        f"{corrected} corrected -> {args.output_path}"
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

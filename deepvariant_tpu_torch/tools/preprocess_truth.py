"""Normalize overlapping phased truth variants (reference
tools/preprocess_truth.py:30-227).

The port's copy of `deepvariant_tpu.tools.preprocess_truth`: host code
over the port's bgzf, tabix and vcf modules: the `.vcf.gz` and `.tbi`
equal the JAX package's byte for byte.

T2T/dipcall truth VCFs (e.g. the Q100 HG002 sets) represent nested
variation as several overlapping records plus `*` (spanning-deletion)
alt alleles. Training labelers want ONE consolidated record per locus.
This tool groups overlapping records on a contig, replays each phased
haplotype's alleles onto a per-position base map over the group's
reference span, and emits a single phased record whose two alt alleles
are the reconstructed haplotype sequences.

Only valid for fully-phased truth VCFs: without phasing the two
haplotype sequences cannot be reconstructed. Groups are never formed
on chrX/chrY (haploid regions make the two-haplotype replay
meaningless; the reference skips them the same way,
preprocess_truth.py:174).

Deviations from the reference (both deliberate):
  * a record that begins a new contig still starts a new group (the
    reference's loop `continue`s past it, silently dropping the first
    record of every contig after the first);
  * inserted bases that extend past the reference span of a len>1 REF
    are appended at the last covered position instead of dropped.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.io.tabix import build_index
from deepvariant_tpu_torch.io.vcf import VcfReader, format_variant_line

_UNGROUPED_CONTIGS = frozenset({"chrX", "chrY", "X", "Y"})


def _trim_common_suffix(ref: str, alt: str) -> int:
    """Length of the shared ref/alt suffix, keeping >=1 base of each
    (preprocess_truth.py:83-91 keeps index 0 of both alleles)."""
    n = 0
    i, j = len(ref) - 1, len(alt) - 1
    while i > 0 and j > 0 and ref[i] == alt[j]:
        n += 1
        i -= 1
        j -= 1
    return n


class _HaplotypeMap:
    """Per-position [ref, hap1, hap2] base map over one overlap group.

    Entries hold the string painted at that reference position: one
    base for matches/mismatches, '*' under a deletion, or a multi-base
    string where an insertion is anchored.
    """

    def __init__(self):
        self.bases: Dict[int, List[str]] = {}

    def paint_reference(self, variant: Variant) -> None:
        for offset, base in enumerate(variant.reference_bases):
            pos = variant.start + offset
            if pos not in self.bases:
                self.bases[pos] = [base, base, base]
            elif self.bases[pos][0] != base:
                raise ValueError(
                    f"inconsistent reference base at "
                    f"{variant.reference_name}:{pos + 1}: "
                    f"{self.bases[pos][0]} vs {base} ({variant})"
                )

    def paint_haplotypes(self, variant: Variant) -> None:
        """Replays each haplotype's allele onto the map."""
        genotype = variant.calls[0].genotype
        ref = variant.reference_bases
        alleles = [ref] + list(variant.alternate_bases)
        for hap, allele_index in enumerate(genotype[:2], start=1):
            if allele_index <= 0:
                continue  # ref or uncalled: the map already has ref.
            alt = alleles[allele_index]
            if alt == "*":
                continue  # covered by an overlapping deletion record.
            trim = 0
            if len(ref) > 1 and len(alt) > 1:
                trim = _trim_common_suffix(ref, alt)
            ref_n = len(ref) - trim
            alt_t = alt[: len(alt) - trim] if trim else alt
            if ref_n == 1:
                # Anchored insertion / SNP: whole allele at the anchor.
                self.bases[variant.start][hap] = alt_t
                continue
            for offset in range(ref_n):
                pos = variant.start + offset
                if offset < len(alt_t):
                    painted = alt_t[offset]
                    if offset == ref_n - 1 and len(alt_t) > ref_n:
                        painted = alt_t[offset:]  # insertion tail
                else:
                    painted = "*"  # deleted position
                self.bases[pos][hap] = painted

    def consolidated(self) -> List[str]:
        """[ref, hap1, hap2] sequences over the group span."""
        seqs = ["", "", ""]
        for pos in sorted(self.bases):
            for k in range(3):
                piece = self.bases[pos][k]
                if piece != "*":
                    seqs[k] += piece
        return seqs


def _group_overlapping(
    variants: Iterable[Variant],
) -> Iterator[List[Variant]]:
    """Yields runs of overlapping records (never across contigs, never
    on chrX/chrY)."""
    group: List[Variant] = []
    group_end = 0
    for v in variants:
        if (
            group
            and v.reference_name == group[0].reference_name
            and v.start < group_end
            and v.reference_name not in _UNGROUPED_CONTIGS
        ):
            group.append(v)
            group_end = max(group_end, v.end)
        else:
            if group:
                yield group
            group = [v]
            group_end = v.end
    if group:
        yield group


def consolidate_group(group: Sequence[Variant]) -> Variant:
    """Collapses >=2 overlapping phased records into one."""
    for v in group:
        if not v.calls:
            raise ValueError(
                "preprocess_truth requires a sample column with "
                "fully-phased GTs on every truth record; record at "
                f"{v.reference_name}:{v.start + 1} has no calls"
            )
    hmap = _HaplotypeMap()
    for v in group:
        hmap.paint_reference(v)
    for v in group:
        hmap.paint_haplotypes(v)
    ref, hap1, hap2 = hmap.consolidated()

    out = group[0]
    call = out.calls[0]
    if hap1 == ref and hap2 == ref:
        alts, gt = [], [0, 0]
    elif hap1 == ref:
        alts, gt = [hap2], [0, 1]
    elif hap2 == ref:
        alts, gt = [hap1], [1, 0]
    elif hap1 == hap2:
        alts, gt = [hap1], [1, 1]
    elif len(hap1) < len(hap2):
        # Shorter haplotype allele first (preprocess_truth.py:134-137).
        alts, gt = [hap1, hap2], [1, 2]
    else:
        alts, gt = [hap2, hap1], [2, 1]
    out.reference_bases = ref
    out.alternate_bases = alts
    out.end = out.start + len(ref)
    call.genotype = gt
    call.is_phased = True
    return out


def preprocess_truth(
    truth_vcf: str, output_vcf: str
) -> Dict[str, int]:
    """Streams the truth VCF, consolidating overlap groups in place.

    Returns counters: records in/out, groups collapsed.
    """
    from deepvariant_tpu_torch.io.bgzf import BgzfWriter

    stats = {"records_in": 0, "records_out": 0, "groups_collapsed": 0}
    with VcfReader(truth_vcf) as reader:
        if output_vcf.endswith(".gz"):
            fh = BgzfWriter(output_vcf)
            write = lambda s: fh.write(s.encode())
        else:
            fh = open(output_vcf, "w")
            write = fh.write
        try:
            for line in reader.header_lines:
                write(line.rstrip("\n") + "\n")
            cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                    "FILTER", "INFO"]
            if reader.sample_names:
                cols += ["FORMAT"] + reader.sample_names
            write("\t".join(cols) + "\n")

            def counted(r):
                for v in r:
                    stats["records_in"] += 1
                    yield v

            for group in _group_overlapping(counted(reader)):
                if len(group) > 1:
                    out = consolidate_group(group)
                    stats["groups_collapsed"] += 1
                else:
                    out = group[0]
                write(format_variant_line(out) + "\n")
                stats["records_out"] += 1
        finally:
            fh.close()
    if output_vcf.endswith(".gz"):
        build_index(output_vcf)
    return stats


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Consolidate overlapping phased truth variants."
    )
    p.add_argument("--truth_vcf", required=True,
                   help="fully-phased input truth VCF")
    p.add_argument("--output_vcf", required=True)
    args = p.parse_args(argv)
    stats = preprocess_truth(args.truth_vcf, args.output_vcf)
    print(
        f"preprocess_truth: {stats['records_in']} in -> "
        f"{stats['records_out']} out "
        f"({stats['groups_collapsed']} overlap groups collapsed)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

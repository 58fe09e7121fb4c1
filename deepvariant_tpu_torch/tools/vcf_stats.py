"""VCF statistics report (reference vcf_stats*.py, ~1000 LoC).

The port's copy of `deepvariant_tpu.tools.vcf_stats`: host code writing
the same JSON and HTML; the port's postprocess_variants
--vcf_stats_report calls it.

Computes the same summary families the reference's vcf_stats_report
emits — record counts by type, quality/GQ/depth/VAF distributions,
Ti/Tv ratio, genotype class counts, indel size spectrum — and writes
them as a JSON stats file plus a dependency-free single-file HTML
report (the reference uses altair; this renders inline SVG bars).
"""

from __future__ import annotations

import collections
import dataclasses
import html
import json
import math
from typing import Dict, List, Optional, Sequence

from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.io.vcf import VcfReader

_TRANSITIONS = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}

BIALLELIC_SNP = "Biallelic_SNP"
BIALLELIC_INSERTION = "Biallelic_Insertion"
BIALLELIC_DELETION = "Biallelic_Deletion"
BIALLELIC_MNP = "Biallelic_MNP"
MULTIALLELIC_SNP = "Multiallelic_SNP"
MULTIALLELIC_INSERTION = "Multiallelic_Insertion"
MULTIALLELIC_DELETION = "Multiallelic_Deletion"
MULTIALLELIC_COMPLEX = "Multiallelic_Complex"
REFCALL = "RefCall"


def variant_type(variant: Variant) -> str:
    """Classify like vcf_stats._get_variant_type (:69-96), which gates
    on nucleus is_variant_call: the gVCF <*> alt never counts, any
    failing FILTER means RefCall, and a called hom-ref genotype means
    RefCall."""
    if variant.filter and variant.filter not in (["PASS"], ["."]):
        return REFCALL
    alts = [a for a in variant.alternate_bases if a != "<*>"]
    ref = variant.reference_bases
    if not alts:
        return REFCALL
    if variant.calls:
        gt = variant.calls[0].genotype
        if gt and all(g == 0 for g in gt):
            return REFCALL
    biallelic = len(alts) == 1
    is_snp = all(len(a) == len(ref) == 1 for a in alts)
    is_insertion = all(len(a) > len(ref) for a in alts)
    is_deletion = all(len(a) < len(ref) for a in alts)
    if biallelic:
        if is_snp:
            return BIALLELIC_SNP
        if is_insertion:
            return BIALLELIC_INSERTION
        if is_deletion:
            return BIALLELIC_DELETION
        return BIALLELIC_MNP
    if is_snp:
        return MULTIALLELIC_SNP
    if is_insertion:
        return MULTIALLELIC_INSERTION
    if is_deletion:
        return MULTIALLELIC_DELETION
    return MULTIALLELIC_COMPLEX


def is_transition(ref: str, alt: str) -> bool:
    return (ref, alt) in _TRANSITIONS


@dataclasses.dataclass
class VcfStats:
    record_count: int = 0
    variant_count: int = 0
    counts_by_type: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int)
    )
    transitions: int = 0
    transversions: int = 0
    genotype_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int)
    )
    qualities: List[float] = dataclasses.field(default_factory=list)
    gqs: List[int] = dataclasses.field(default_factory=list)
    depths: List[int] = dataclasses.field(default_factory=list)
    vafs: List[float] = dataclasses.field(default_factory=list)
    indel_sizes: List[int] = dataclasses.field(default_factory=list)

    @property
    def titv_ratio(self) -> float:
        return self.transitions / self.transversions \
            if self.transversions else math.inf

    def to_json_dict(self) -> dict:
        def hist(values, bins, lo, hi):
            counts = [0] * bins
            for v in values:
                if v is None or not math.isfinite(v):
                    continue
                idx = int((v - lo) / (hi - lo) * bins)
                counts[min(max(idx, 0), bins - 1)] += 1
            return counts

        return {
            "record_count": self.record_count,
            "variant_count": self.variant_count,
            "counts_by_type": dict(self.counts_by_type),
            "transitions": self.transitions,
            "transversions": self.transversions,
            "titv_ratio": (self.titv_ratio
                           if math.isfinite(self.titv_ratio) else None),
            "genotype_counts": dict(self.genotype_counts),
            "quality_histogram": hist(self.qualities, 20, 0, 100),
            "gq_histogram": hist(self.gqs, 20, 0, 100),
            "depth_histogram": hist(self.depths, 20, 0, 200),
            "vaf_histogram": hist(self.vafs, 20, 0, 1.0001),
            "indel_size_histogram": hist(self.indel_sizes, 21, -10.5, 10.5),
        }


def compute_stats(variants) -> VcfStats:
    stats = VcfStats()
    for v in variants:
        stats.record_count += 1
        vtype = variant_type(v)
        stats.counts_by_type[vtype] += 1
        if v.alternate_bases and v.alternate_bases != ["<*>"]:
            if vtype != REFCALL:
                stats.variant_count += 1
            for alt in v.alternate_bases:
                if alt == "<*>":
                    continue
                if len(v.reference_bases) == 1 and len(alt) == 1:
                    if is_transition(v.reference_bases, alt):
                        stats.transitions += 1
                    else:
                        stats.transversions += 1
                else:
                    stats.indel_sizes.append(
                        len(alt) - len(v.reference_bases)
                    )
        stats.qualities.append(v.quality)
        if v.calls:
            call = v.calls[0]
            gt = call.genotype
            if gt:
                if any(g < 0 for g in gt):
                    key = "./."
                else:
                    key = "/".join(str(g) for g in sorted(gt))
                stats.genotype_counts[key] += 1
            if "GQ" in call.info:
                stats.gqs.append(int(call.info["GQ"][0]))
            if "DP" in call.info:
                stats.depths.append(int(call.info["DP"][0]))
            if "VAF" in call.info:
                for x in call.info["VAF"]:
                    stats.vafs.append(float(x))
    return stats


def _svg_bar_chart(title: str, labels, values, width=640, height=180):
    if not values:
        return f"<h3>{html.escape(title)}</h3><p>no data</p>"
    vmax = max(values) or 1
    n = len(values)
    bar_w = max(1, (width - 40) // n - 2)
    bars = []
    for i, v in enumerate(values):
        h = int((height - 40) * v / vmax)
        x = 30 + i * (bar_w + 2)
        y = height - 25 - h
        bars.append(
            f'<rect x="{x}" y="{y}" width="{bar_w}" height="{h}" '
            f'fill="#4878CF"><title>{html.escape(str(labels[i]))}: {v}'
            f"</title></rect>"
        )
    return (
        f"<h3>{html.escape(title)}</h3>"
        f'<svg width="{width}" height="{height}">'
        + "".join(bars)
        + f'<line x1="28" y1="{height - 25}" x2="{width - 5}" '
        f'y2="{height - 25}" stroke="#333"/></svg>'
    )


def write_report(stats: VcfStats, output_basename: str,
                 title: str = "VCF stats"):
    """Write <base>.stats.json and <base>.visual_report.html."""
    d = stats.to_json_dict()
    with open(output_basename + ".stats.json", "w") as f:
        json.dump(d, f, indent=2)
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title>"
        "<style>body{font-family:sans-serif;margin:2em}"
        "table{border-collapse:collapse}"
        "td,th{border:1px solid #ccc;padding:4px 10px}</style>"
        "</head><body>",
        f"<h1>{html.escape(title)}</h1>",
        f"<p>{d['record_count']} records, {d['variant_count']} variants, "
        f"Ti/Tv = {d['titv_ratio'] if d['titv_ratio'] is not None else 'inf'}"
        "</p>",
        "<h3>Variant types</h3><table><tr><th>type</th><th>count</th></tr>",
    ]
    for k in sorted(d["counts_by_type"]):
        parts.append(
            f"<tr><td>{html.escape(k)}</td>"
            f"<td>{d['counts_by_type'][k]}</td></tr>"
        )
    parts.append("</table>")
    parts.append(
        "<h3>Genotypes</h3><table><tr><th>GT</th><th>count</th></tr>"
        + "".join(
            f"<tr><td>{html.escape(k)}</td><td>{v}</td></tr>"
            for k, v in sorted(stats.genotype_counts.items())
        )
        + "</table>"
    )
    for name, key, lo, hi in [
        ("QUAL distribution", "quality_histogram", 0, 100),
        ("GQ distribution", "gq_histogram", 0, 100),
        ("Depth distribution", "depth_histogram", 0, 200),
        ("VAF distribution", "vaf_histogram", 0, 1),
        ("Indel sizes", "indel_size_histogram", -10, 10),
    ]:
        values = d[key]
        nbin = len(values)
        labels = [
            f"{lo + (hi - lo) * i / nbin:.2f}" for i in range(nbin)
        ]
        parts.append(_svg_bar_chart(name, labels, values))
    parts.append("</body></html>")
    with open(output_basename + ".visual_report.html", "w") as f:
        f.write("".join(parts))


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("vcf_stats_report")
    p.add_argument("--input_vcf", required=True)
    p.add_argument("--outfile_base", required=True)
    args = p.parse_args(argv)
    with VcfReader(args.input_vcf) as reader:
        stats = compute_stats(reader)
    write_report(stats, args.outfile_base,
                 title=f"VCF stats: {args.input_vcf}")
    print(
        f"vcf_stats_report: {stats.record_count} records -> "
        f"{args.outfile_base}.visual_report.html"
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

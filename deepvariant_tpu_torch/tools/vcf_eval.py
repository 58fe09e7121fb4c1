"""Genotype-level VCF comparison (a minimal hap.py-style evaluator).

The port's copy of `deepvariant_tpu.tools.vcf_eval`: host code with the
same matching rules and JSON.

Scores a query VCF against a truth VCF inside confident regions, the
way the reference's docs report accuracy (docs/metrics.md:33-44 uses
hap.py vs GIAB truth). This implements the GT-level ("genotype match")
benchmarking semantics on normalized allele representations:

  * both sides restrict to PASS (or unfiltered), non-ref-GT records
    whose position falls inside the confident regions (and optional
    region filter);
  * each called genotype is decomposed into its set of non-ref alleles
    after trimming shared prefix/suffix bases (so `CACA->CA @100` and
    `CA->"" @102`-style representations compare equal);
  * a truth and query record match (TP) when they describe the same
    normalized allele multiset with the same zygosity; a query record
    with no matching truth is a FP; an unmatched truth record is a FN.
    A genotype mismatch at a shared site counts as both FP and FN
    (hap.py's GT-level behavior).

Metrics are reported separately for SNPs and indels, by TRUTH type for
recall and QUERY type for precision (hap.py convention).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from deepvariant_tpu_torch.core.ranges import RangeSet
from deepvariant_tpu_torch.core.types import Range, Variant
from deepvariant_tpu_torch.io.vcf import VcfReader


def _trim(pos: int, ref: str, alt: str) -> Tuple[int, str, str]:
    """Trim shared suffix then shared prefix bases (VCF normalization
    without left-alignment; both sides of the comparison derive from
    the same reference so this canonicalizes representation)."""
    while len(ref) > 1 and len(alt) > 1 and ref[-1] == alt[-1]:
        ref, alt = ref[:-1], alt[:-1]
    while len(ref) > 1 and len(alt) > 1 and ref[0] == alt[0]:
        ref, alt = ref[1:], alt[1:]
        pos += 1
    return pos, ref, alt


def _genotype_key(variant: Variant) -> Optional[Tuple]:
    """Normalized (site, called-allele-multiset) key, or None if the
    record does not call a non-reference genotype."""
    if not variant.calls:
        return None
    gt = variant.calls[0].genotype
    alt_indices = sorted(g for g in gt if g > 0)
    if not alt_indices:
        return None
    alleles = []
    for g in alt_indices:
        if g - 1 >= len(variant.alternate_bases):
            return None
        alt = variant.alternate_bases[g - 1]
        alleles.append(
            _trim(variant.start, variant.reference_bases, alt)
        )
    n_ref = sum(1 for g in gt if g == 0)
    return (variant.reference_name, tuple(sorted(alleles)), n_ref)


def _is_snp_gt(variant: Variant) -> bool:
    """SNP/indel classification over the CALLED alleles only."""
    gt = variant.calls[0].genotype if variant.calls else []
    called = [g for g in gt if g > 0]
    for g in called:
        _, ref, alt = _trim(
            variant.start, variant.reference_bases,
            variant.alternate_bases[g - 1],
        )
        if len(ref) != 1 or len(alt) != 1:
            return False
    return True


def _eligible(
    variant: Variant,
    confident: Optional[RangeSet],
    region: Optional[Range],
) -> bool:
    if variant.filter and variant.filter not in (["PASS"], ["."]):
        return False
    if region is not None and not (
        variant.reference_name == region.reference_name
        and region.start <= variant.start < region.end
    ):
        return False
    if confident is not None and not confident.overlaps(
        variant.reference_name, variant.start
    ):
        return False
    return _genotype_key(variant) is not None


def wilson_ci(
    successes: int, n: int, z: float = 1.959964
) -> Tuple[float, float]:
    """Wilson score 95% interval for a binomial proportion.

    The reference's published F1s are computed over millions of calls
    (docs/metrics.md:33-44) where the interval is negligible; the
    evals here run on hundreds-to-thousands of calls, so every
    reported proportion carries this interval.
    """
    if n == 0:
        return (0.0, 1.0)
    p = successes / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (
        z * ((p * (1 - p) / n + z * z / (4 * n * n)) ** 0.5) / denom
    )
    return (max(0.0, center - half), min(1.0, center + half))


@dataclasses.dataclass
class TypeMetrics:
    tp: int = 0
    fn: int = 0
    fp: int = 0

    @property
    def recall(self) -> float:
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def precision(self) -> float:
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if p + r else 0.0

    def as_dict(self) -> Dict[str, float]:
        r_ci = wilson_ci(self.tp, self.tp + self.fn)
        p_ci = wilson_ci(self.tp, self.tp + self.fp)
        # F1 is monotone in both precision and recall, so evaluating
        # it at the paired interval ends gives a conservative
        # (wider-than-exact) 95% band.
        def _f1(p, r):
            return 2 * p * r / (p + r) if p + r else 0.0

        return {
            "tp": self.tp, "fn": self.fn, "fp": self.fp,
            "n_truth": self.tp + self.fn,
            "recall": round(self.recall, 6),
            "precision": round(self.precision, 6),
            "f1": round(self.f1, 6),
            "recall_ci95": [round(x, 6) for x in r_ci],
            "precision_ci95": [round(x, 6) for x in p_ci],
            "f1_ci95": [
                round(_f1(p_ci[0], r_ci[0]), 6),
                round(_f1(p_ci[1], r_ci[1]), 6),
            ],
        }


def evaluate_variants(
    truth: Sequence[Variant],
    query: Sequence[Variant],
    confident: Optional[RangeSet] = None,
    region: Optional[Range] = None,
) -> Dict[str, Dict[str, float]]:
    """Compare in-memory truth/query variants; see module docstring."""
    truth = [v for v in truth if _eligible(v, confident, region)]
    query = [v for v in query if _eligible(v, confident, region)]

    truth_by_key: Dict[Tuple, Variant] = {}
    for v in truth:
        truth_by_key[_genotype_key(v)] = v

    matched_truth = set()
    metrics = {"snp": TypeMetrics(), "indel": TypeMetrics()}
    for v in query:
        key = _genotype_key(v)
        kind = "snp" if _is_snp_gt(v) else "indel"
        if key in truth_by_key and key not in matched_truth:
            matched_truth.add(key)
            metrics[kind].tp += 1
        else:
            metrics[kind].fp += 1
    for v in truth:
        key = _genotype_key(v)
        if key not in matched_truth:
            kind = "snp" if _is_snp_gt(v) else "indel"
            metrics[kind].fn += 1

    out = {k: m.as_dict() for k, m in metrics.items()}
    total = TypeMetrics(
        tp=metrics["snp"].tp + metrics["indel"].tp,
        fn=metrics["snp"].fn + metrics["indel"].fn,
        fp=metrics["snp"].fp + metrics["indel"].fp,
    )
    out["all"] = total.as_dict()
    return out


def evaluate(
    truth_vcf: str,
    query_vcf: str,
    confident_bed: Optional[str] = None,
    region: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """File-level wrapper: paths in, metrics dict out."""
    region_obj = Range.from_region_string(region) if region else None
    confident = (
        RangeSet.from_regions([confident_bed]) if confident_bed else None
    )
    with VcfReader(truth_vcf) as r:
        truth = list(r)
    with VcfReader(query_vcf) as r:
        query = list(r)
    return evaluate_variants(truth, query, confident, region_obj)


def metrics_file_dict(
    result: Dict[str, Dict[str, float]],
) -> Dict[str, float]:
    """hap.py-extract-style keys for a `.metrics` sidecar — the format
    the checkpoint-sweep summarizer (tools/print_f1.py) consumes
    (reference tools/print_f1.py:63-68 reads TPs_All/FNs_All/FPs_All).
    """
    out: Dict[str, float] = {}
    for kind, suffix in (("all", "All"), ("snp", "SNP"),
                         ("indel", "INDEL")):
        m = result[kind]
        out[f"TPs_{suffix}"] = float(m["tp"])
        out[f"FNs_{suffix}"] = float(m["fn"])
        out[f"FPs_{suffix}"] = float(m["fp"])
        out[f"F1_{suffix}"] = float(m["f1"])
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Genotype-level VCF accuracy vs a truth set."
    )
    p.add_argument("--truth_vcf", required=True)
    p.add_argument("--query_vcf", required=True)
    p.add_argument("--confident_regions", default=None)
    p.add_argument("--region", default=None,
                   help="optional chrom:start-end filter")
    p.add_argument("--metrics_out", default=None,
                   help="also write a ckpt-style .metrics JSON "
                   "(consumed by tools/print_f1.py)")
    args = p.parse_args(argv)
    result = evaluate(
        args.truth_vcf, args.query_vcf,
        confident_bed=args.confident_regions, region=args.region,
    )
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_file_dict(result), f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()

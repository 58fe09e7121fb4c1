"""False-negative audit: WHY did each missed truth variant go missing?

The port's copy of `deepvariant_tpu.tools.fn_audit`: host code over the
port's vcf_eval, with the same JSON.

For every truth record inside the scored (confident ∩ region) space
that the query VCF failed to reproduce, walk the pipeline backwards
and classify the miss:

  * ``wrong_genotype``  — the site was called with the right allele
    but the wrong GT (het vs hom-alt);
  * ``wrong_allele``    — a variant was emitted at the position with a
    different alt;
  * ``cnn_ref_call``    — a candidate reached the CNN (a CVO exists for
    the allele) but the network called hom-ref; the CVO's class
    probabilities are reported;
  * ``cnn_low_qual``    — the CNN favored a variant genotype but the
    call was dropped by postprocess quality filtering;
  * ``no_candidate``    — the candidate generator never proposed the
    allele: nothing downstream could have called it.

It answers, for each FN: candidate miss? label? CNN? Reference
analog: hap.py's FN categorization + run_oracle_inference's
pipeline-vs-model split.

Usage:
    python -m deepvariant_tpu_torch.tools.fn_audit \
        --truth truth.vcf.gz --query out.vcf.gz \
        --cvos eval/cvo.tfrecord.gz \
        --confident_bed conf.bed --region chr20:10,000,000-10,100,000
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

from deepvariant_tpu_torch.core.ranges import RangeSet
from deepvariant_tpu_torch.core.types import CallVariantsOutput, Range, Variant
from deepvariant_tpu_torch.tools.vcf_eval import (
    _eligible,
    _genotype_key,
    _is_snp_gt,
    _trim,
)


def _read_vcf(path: str) -> List[Variant]:
    from deepvariant_tpu_torch.io.vcf import VcfReader

    return list(VcfReader(path))


def _read_cvos(path: str) -> List[CallVariantsOutput]:
    from deepvariant_tpu_torch.core.sharded_files import glob_sharded_inputs
    from deepvariant_tpu_torch.io.tfrecord import TFRecordReader

    out = []
    for p in glob_sharded_inputs(path):
        with TFRecordReader(p) as reader:
            for buf in reader:
                out.append(CallVariantsOutput.decode(buf))
    return out


def _allele_keys(variant: Variant) -> set:
    """Normalized (pos, ref, alt) triples for every alt allele."""
    keys = set()
    for alt in variant.alternate_bases:
        keys.add(_trim(variant.start, variant.reference_bases, alt))
    return keys


def audit_fns(
    truth: Sequence[Variant],
    query: Sequence[Variant],
    cvos: Sequence[CallVariantsOutput],
    confident: Optional[RangeSet] = None,
    region: Optional[Range] = None,
) -> List[Dict]:
    """One record per missed truth variant (see module docstring)."""
    truth = [v for v in truth if _eligible(v, confident, region)]
    eligible_query = [v for v in query if _eligible(v, confident, region)]
    matched = {_genotype_key(v) for v in eligible_query}

    # Index query calls and CVOs by normalized allele.
    query_by_allele: Dict[tuple, Variant] = {}
    for v in query:
        for k in _allele_keys(v):
            query_by_allele.setdefault(k, v)
    query_positions: Dict[tuple, List[Variant]] = {}
    for v in query:
        query_positions.setdefault(
            (v.reference_name, v.start), []
        ).append(v)
    cvo_by_allele: Dict[tuple, List[CallVariantsOutput]] = {}
    for c in cvos:
        for k in _allele_keys(c.variant):
            cvo_by_allele.setdefault(k, []).append(c)

    out: List[Dict] = []
    for t in truth:
        key = _genotype_key(t)
        if key is None or key in matched:
            continue
        row: Dict = {
            "locus": f"{t.reference_name}:{t.start + 1}",
            "ref": t.reference_bases,
            "alts": list(t.alternate_bases),
            "type": "snp" if _is_snp_gt(t) else "indel",
            "truth_gt": sorted(t.calls[0].genotype) if t.calls else None,
        }
        t_alleles = _allele_keys(t)
        hit = next(
            (query_by_allele[k] for k in t_alleles
             if k in query_by_allele), None,
        )
        if hit is not None:
            row["category"] = "wrong_genotype"
            row["called_gt"] = sorted(
                hit.calls[0].genotype) if hit.calls else None
            row["called_qual"] = round(hit.quality, 2)
            row["called_filter"] = list(hit.filter)
        elif query_positions.get((t.reference_name, t.start)):
            other = query_positions[(t.reference_name, t.start)][0]
            row["category"] = "wrong_allele"
            row["called_alts"] = list(other.alternate_bases)
        else:
            cands = [
                c for k in t_alleles for c in cvo_by_allele.get(k, [])
            ]
            if cands:
                best = max(
                    cands,
                    key=lambda c: 1.0 - c.genotype_probabilities[0],
                )
                probs = [round(p, 4) for p in
                         best.genotype_probabilities]
                row["cvo_probs"] = probs
                row["category"] = (
                    "cnn_ref_call"
                    if probs[0] >= max(probs[1], probs[2])
                    else "cnn_low_qual"
                )
            else:
                row["category"] = "no_candidate"
        out.append(row)
    return out


def run(
    truth_vcf: str,
    query_vcf: str,
    cvo_path: str,
    confident_bed: Optional[str] = None,
    region: Optional[str] = None,
) -> List[Dict]:
    confident = (
        RangeSet.from_regions([confident_bed]) if confident_bed else None
    )
    region_r = Range.from_region_string(region) if region else None
    return audit_fns(
        _read_vcf(truth_vcf),
        _read_vcf(query_vcf),
        _read_cvos(cvo_path) if cvo_path else [],
        confident=confident,
        region=region_r,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser("fn_audit", description=__doc__)
    p.add_argument("--truth", required=True)
    p.add_argument("--query", required=True)
    p.add_argument("--cvos", default="")
    p.add_argument("--confident_bed", default="")
    p.add_argument("--region", default="")
    p.add_argument("--out", default="", help="write JSON here")
    args = p.parse_args(argv)
    rows = run(
        args.truth, args.query, args.cvos,
        confident_bed=args.confident_bed or None,
        region=args.region or None,
    )
    text = json.dumps(rows, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    counts: Dict[str, int] = {}
    for r in rows:
        counts[r["category"]] = counts.get(r["category"], 0) + 1
    print(f"# {len(rows)} FN(s): {counts}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

"""Import candidates from a proposed VCF instead of threshold calling.

The port's copy of `deepvariant_tpu.make_examples.vcf_candidate_importer`
(the reference's vcf_candidate_importer.py and the C++ CallsFromVcf path
of variant_calling_multisample.cc): each proposed variant overlapping the
region becomes a DeepVariantCall; read support is looked up from the
allele counts at the variant position by matching observed alleles to
the proposal's alts.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from deepvariant_tpu_torch.core.types import Range, Variant, VariantCall
from deepvariant_tpu_torch.make_examples.allele_counter import AlleleCounter
from deepvariant_tpu_torch.make_examples.variant_caller import (
    DeepVariantCall,
    SUPPORTING_UNCALLED_ALLELE,
    VariantCallerOptions,
    VerySensitiveCaller,
    build_allele_map,
    calc_ref_bases,
)


class VcfCandidateImporter(VerySensitiveCaller):
    """Call variants proposed by an input VCF (vcf_candidate_importer.py)."""

    def __init__(self, options: Optional[VariantCallerOptions],
                 candidates_vcf: str):
        super().__init__(options)
        from deepvariant_tpu_torch.io.vcf import VcfReader

        self.vcf_reader = VcfReader(candidates_vcf)

    def calls_in_region(
        self, counter: AlleleCounter
    ) -> List[DeepVariantCall]:
        out: List[DeepVariantCall] = []
        interval = counter.interval
        for proposed in self.vcf_reader.query(interval):
            if not (interval.start <= proposed.start < interval.end):
                continue
            variant = Variant(
                reference_name=proposed.reference_name,
                start=proposed.start,
                end=proposed.end,
                reference_bases=proposed.reference_bases,
                alternate_bases=list(proposed.alternate_bases),
                calls=[VariantCall(
                    call_set_name=self.options.sample_name,
                    genotype=[-1, -1],
                )],
            )
            out.append(self._with_support(variant, counter))
        return out

    def _with_support(
        self, variant: Variant, counter: AlleleCounter
    ) -> DeepVariantCall:
        """Attach read support by matching observed alleles at the
        position to the proposal's alleles."""
        pos = variant.start - counter.interval.start
        support: Dict[str, List[int]] = {}
        ref_ids: List[int] = []
        dp = 0
        if 0 <= pos < len(counter.interval):
            alleles = counter.sum_allele_counts(pos)
            dp = counter.total_allele_count(pos)
            allele_map = build_allele_map(
                alleles, variant.reference_bases
            ) if alleles else []
            mapped = {(a.bases, a.type): alt for a, alt in allele_map}
            pc = counter.position_count(pos)
            if pc is not None:
                for rid, rec in pc.read_alleles.items():
                    if rec.is_low_quality:
                        continue
                    alt = mapped.get((rec.bases, rec.type))
                    if alt is not None and alt in variant.alternate_bases:
                        support.setdefault(alt, []).append(rid)
                    else:
                        support.setdefault(
                            SUPPORTING_UNCALLED_ALLELE, []
                        ).append(rid)
                ref_ids = list(pc.ref_supporting_read_ids)
        call = variant.calls[0]
        call.info["DP"] = [dp]
        ad = [int(counter.ref_count[pos])
              if 0 <= pos < len(counter.interval) else 0]
        vaf = []
        for alt in variant.alternate_bases:
            n = len(support.get(alt, []))
            ad.append(n)
            vaf.append(n / dp if dp else 0.0)
        call.info["AD"] = ad
        call.info["VAF"] = vaf
        return DeepVariantCall(
            variant=variant, allele_support=support, ref_support=ref_ids
        )

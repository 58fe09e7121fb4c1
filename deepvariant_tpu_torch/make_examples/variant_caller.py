"""Very-sensitive candidate variant caller + gVCF reference confidence.

The port's copy of `deepvariant_tpu.make_examples.variant_caller`: the
reference's candidate proposal logic (variant_calling_multisample.cc:
IsGoodAltAllele :235, SelectAltAlleles :586, CalcRefBases :119,
BuildAlleleMap :685, AddReadDepths :727, CallVariant :972) and the Python
gVCF math (variant_caller.py:121-420) on top of the vectorized
AlleleCounter.

Candidate rules (single sample; multi-sample hooks kept):
- an alt allele is good iff count >= min_count(type) and
  count/total >= min_fraction(type); SOFT_CLIP and REFERENCE never pass.
- ref bases of the Variant = region ref base extended by the longest deletion.
- alt strings rebuilt against those ref bases (MakeAltAllele semantics).
- variant gets calls=[{sample, GT=[-1,-1], DP, AD, VAF}] and alts sorted.

gVCF rules: p_error model with GQ quantization into blocks
(variant_caller.py:220-254 & make_gvcfs :256-420); GQ cache for
coverage <= 100; haploid contigs handled; max_gq 50.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core import genomics_math
from deepvariant_tpu_torch.core.types import Range, Variant, VariantCall
from deepvariant_tpu_torch.make_examples.allele_counter import (
    Allele,
    AlleleCounter,
    DELETION,
    INSERTION,
    REFERENCE,
    SOFT_CLIP,
    SUBSTITUTION,
)

NO_ALT_ALLELE = "."  # kNoAltAllele
GVCF_ALT_ALLELE = "<*>"
SUPPORTING_UNCALLED_ALLELE = "UNCALLED_ALLELE"
IMPOSSIBLE_PROBABILITY_LOG10 = 999.0
CANONICAL_DNA_BASES = frozenset(b"ACGT")
EXTENDED_IUPAC_CODES = frozenset(b"NRYSWKMBDHV")


@dataclasses.dataclass
class VariantCallerOptions:
    """Defaults mirror make_examples_core.py:220-248 + flag defaults."""

    min_count_snps: int = 2
    min_count_indels: int = 2
    min_fraction_snps: float = 0.12
    min_fraction_indels: float = 0.06
    min_fraction_multiplier: float = 1.0
    # Indel-size-dependent fractions (deepvariant.proto:481-488): when
    # the threshold and both fractions are set, alleles with bases
    # length <= threshold+1 use the small-indel fraction, longer ones
    # the large-indel fraction; otherwise min_fraction_indels applies.
    min_indel_fraction_for_small_indels: float = 0.0
    min_indel_fraction_for_large_indels: float = 0.0
    small_indel_threshold: int = 0
    # Multisample caps: drop an allele when the NON-target samples
    # carry it above these fractions (variant_calling_multisample.cc
    # AlleleFilter :264-286). 0 disables.
    max_fraction_snps_for_non_target_sample: float = 0.0
    max_fraction_indels_for_non_target_sample: float = 0.0
    # Keep read support from rejected alleles for downstream consumers
    # (deepvariant.proto:479 use_rejected_alleles).
    use_rejected_alleles: bool = False
    # Merge a deletion with overlapped alleles into complex
    # substitutions (deepvariant.proto:471 create_complex_alleles).
    create_complex_alleles: bool = False
    fraction_reference_sites_to_emit: float = 0.0
    random_seed: int = 1400605801
    sample_name: str = "default"
    p_error: float = 0.001
    max_gq: int = 50
    gq_resolution: int = 5
    ploidy: int = 2
    haploid_contigs: Tuple[str, ...] = ()
    # BED of pseudoautosomal regions that stay diploid on haploid
    # contigs (--par_regions_bed).
    par_regions_bed: str = ""
    skip_uncalled_genotypes: bool = False
    small_model_vaf_context_window_size: int = 0
    # Role of the target sample ("tumor" enables the matched-normal
    # NDP/NAD/NAF fields, variant_calling_multisample.cc:1131-1146).
    target_sample_role: str = ""


@dataclasses.dataclass
class DeepVariantCall:
    """A candidate: variant + supporting-read map (deepvariant.proto
    DeepVariantCall semantics; read names replaced by batch read indices)."""

    variant: Variant
    allele_support: Dict[str, List[int]]  # alt string -> read indices
    ref_support: List[int] = dataclasses.field(default_factory=list)
    allele_frequencies: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    # Per-position integer VAF (0-100) over the small-model context
    # window around the candidate (AddAdjacentAlleleFractionsAtPosition,
    # variant_calling_multisample.cc:1288-1314); keys are absolute
    # genome positions. Populated when
    # small_model_vaf_context_window_size > 0.
    allele_frequency_at_position: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    # (allele bases, allele type) -> vcf alt string, kept so other
    # samples' read support can be computed for the same candidate
    # (multisample pileups color every sample's reads by support).
    allele_keys: Dict[Tuple[str, int], str] = dataclasses.field(
        default_factory=dict
    )


def _quantize_gq(raw_gq: int, binsize: int) -> int:
    """variant_caller.py:95-117."""
    if raw_gq < 1:
        return 0
    return (raw_gq - 1) // binsize * binsize + 1


def rescale_read_counts_if_necessary(
    n_ref: int, n_total: int, max_allowed_reads: int
) -> Tuple[int, int]:
    """_rescale_read_counts_if_necessary (variant_caller.py:76-101):
    scale counts so n_total <= max_allowed, rounding n_ref UP
    (math.ceil — e.g. 1/1000 of 100 becomes 1, not 0)."""
    if n_total > max_allowed_reads:
        ratio = n_ref / (1.0 * n_total)
        n_ref = int(math.ceil(ratio * max_allowed_reads))
        n_total = max_allowed_reads
    return n_ref, n_total


class ReferenceConfidence:
    """gVCF reference-confidence model with GQ cache (variant_caller.py:124)."""

    def __init__(self, options: VariantCallerOptions,
                 max_cache_coverage: int = 100):
        self.options = options
        self.max_cache_coverage = max_cache_coverage
        self._cache: Dict[bool, list] = {}
        for is_haploid in (False, True):
            self._cache[is_haploid] = [
                self._calc_row(n_total, is_haploid)
                for n_total in range(max_cache_coverage + 1)
            ]

    def _calc_row(self, n_total: int, is_haploid: bool) -> list:
        """All (gq, log10_probs) for n_ref in 0..n_total, vectorized.

        Bit-identical to mapping _calc over n_ref (same float64 ops in
        the same order; verified exhaustively in
        tests/test_variant_caller.py)."""
        if n_total == 0:
            return [self._calc(0, 0, is_haploid)]
        opts = self.options
        log10 = math.log(10)
        logp = math.log(opts.p_error) / log10
        log1p = math.log1p(-opts.p_error) / log10
        n_ref = np.arange(n_total + 1, dtype=np.float64)
        n_alts = n_total - n_ref
        p_ref = n_ref * log1p + n_alts * logp
        if is_haploid:
            p_het = np.full(n_total + 1, -IMPOSSIBLE_PROBABILITY_LOG10,
                            dtype=np.float64)
        else:
            p_het = np.full(
                n_total + 1, -n_total * math.log(opts.ploidy) / log10,
                dtype=np.float64,
            )
        p_hom_alt = n_ref * logp + n_alts * log1p
        probs = np.stack([p_ref, p_het, p_hom_alt], axis=1)
        m = np.max(probs, axis=1, keepdims=True)
        lse = m + np.log10(np.sum(10.0 ** (probs - m), axis=1,
                                  keepdims=True))
        norm = np.minimum(probs - lse, 0.0)
        ptrue = 10.0 ** norm[:, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            gq_raw = -10.0 * np.log10(1.0 - ptrue)
        gq_raw = np.where(
            (ptrue >= 1.0) | ~np.isfinite(gq_raw), opts.max_gq, gq_raw
        )
        gqs = np.minimum(np.floor(gq_raw), opts.max_gq)
        return [(int(gqs[i]), norm[i]) for i in range(n_total + 1)]

    def __call__(self, n_ref: int, n_total: int,
                 is_haploid: bool = False) -> Tuple[int, np.ndarray]:
        n_ref, n_total = rescale_read_counts_if_necessary(
            n_ref, n_total, self.max_cache_coverage
        )
        return self._cache[is_haploid][n_total][n_ref]

    def _calc(self, n_ref: int, n_total: int,
              is_haploid: bool) -> Tuple[int, np.ndarray]:
        opts = self.options
        if n_total == 0:
            if is_haploid:
                log10_probs = genomics_math.normalize_log10_probs(
                    [-1.0, -IMPOSSIBLE_PROBABILITY_LOG10, -1.0]
                )
            else:
                log10_probs = genomics_math.normalize_log10_probs(
                    [-1.0, -1.0, -1.0]
                )
        else:
            n_alts = n_total - n_ref
            log10 = math.log(10)
            logp = math.log(opts.p_error) / log10
            log1p = math.log1p(-opts.p_error) / log10
            log10_p_ref = n_ref * log1p + n_alts * logp
            log10_p_het = -n_total * math.log(opts.ploidy) / log10
            if is_haploid:
                log10_p_het = -IMPOSSIBLE_PROBABILITY_LOG10
            log10_p_hom_alt = n_ref * logp + n_alts * log1p
            log10_probs = genomics_math.normalize_log10_probs(
                [log10_p_ref, log10_p_het, log10_p_hom_alt]
            )
        gq = genomics_math.log10_ptrue_to_phred(
            log10_probs[0], opts.max_gq
        )
        gq = int(min(np.floor(gq), opts.max_gq))
        return gq, log10_probs


@dataclasses.dataclass
class AlleleAtPosition:
    """One read's allele at one genomic position
    (AlleleAtPosition, variant_calling_multisample.h)."""

    alt_bases: str
    type: int
    position: int


def create_combined_alleles_support(
    counter: AlleleCounter, del_start: int, del_len: int
) -> Dict[int, List["AlleleAtPosition"]]:
    """read id -> its alleles across the deletion span
    (CreateCombinedAllelesSupport,
    variant_calling_multisample.cc:314-360). Empty when no alt allele
    is overlapped by the deletion or another deletion overlaps it.
    REFERENCE support is sourced from ref_supporting_read_ids (our
    counter tracks ref reads separately from the alt-record map)."""
    read_to_alt: Dict[int, List[AlleleAtPosition]] = {}
    found_alt = 0
    start_i = del_start - counter.interval.start
    for i in range(max(0, start_i),
                   min(len(counter.interval), start_i + del_len)):
        pc = counter.position_count(i)
        if pc is None:
            continue
        allele_pos = counter.interval.start + i
        for rid, rec in pc.read_alleles.items():
            if rec.is_low_quality:
                continue
            # Skip records of the deletion allele itself.
            if (allele_pos == del_start and rec.type == DELETION
                    and len(rec.bases) == del_len):
                continue
            # Another deletion overlapping ours: no complex variant.
            if rec.type == DELETION:
                return {}
            if rec.type != REFERENCE:
                found_alt += 1
            read_to_alt.setdefault(rid, []).append(
                AlleleAtPosition(rec.bases, rec.type, allele_pos)
            )
        ref_base = chr(counter.ref[i])
        for rid in pc.ref_supporting_read_ids:
            read_to_alt.setdefault(rid, []).append(
                AlleleAtPosition(ref_base, REFERENCE, allele_pos)
            )
    if found_alt < 1:
        return {}
    return read_to_alt


def create_complex_alleles_support(
    read_to_alt: Dict[int, List["AlleleAtPosition"]],
    del_start: int, del_len: int, ref_bases: str,
) -> Dict[str, List[int]]:
    """complex allele string -> supporting read ids
    (CreateComplexAllelesSupport,
    variant_calling_multisample.cc:376-434). Per read: concatenate its
    alleles in position order, filling gaps with reference bases;
    drops the whole site (empty map) when any read's complex allele
    cannot be generated."""
    out: Dict[str, List[int]] = {}
    for rid, alt_alleles in read_to_alt.items():
        start_pos = 0
        complex_allele = ""
        for allele in alt_alleles:
            rel = allele.position - del_start
            if start_pos < rel <= del_len:
                complex_allele += ref_bases[start_pos:rel]
                start_pos = rel
            complex_allele += allele.alt_bases
            if allele.type != INSERTION:
                start_pos = rel + len(allele.alt_bases)
            else:
                start_pos += 1
        if complex_allele and start_pos <= del_len:
            complex_allele += ref_bases[start_pos:]
            out.setdefault(complex_allele, []).append(rid)
        else:
            # One bad read drops the complex site entirely (:426-431).
            return {}
    return out


def _deletion_size(allele: Allele) -> int:
    return len(allele.bases) if allele.type == DELETION else -1


def calc_ref_bases(ref_base: str, alt_alleles: Sequence[Allele]) -> str:
    """variant_calling_multisample.cc:119 CalcRefBases."""
    if not alt_alleles:
        return ref_base
    max_del = max(alt_alleles, key=_deletion_size)
    if max_del.type != DELETION:
        return ref_base
    return ref_base + max_del.bases[1:]


def make_alt_allele(prefix: str, variant_ref: str, from_: int) -> str:
    """variant_calling_multisample.cc:224 MakeAltAllele."""
    postfix = "" if from_ >= len(variant_ref) else variant_ref[from_:]
    return prefix + postfix


def build_allele_map(
    alt_alleles: Sequence[Allele], ref_bases: str
) -> List[Tuple[Allele, str]]:
    """variant_calling_multisample.cc:685 BuildAlleleMap. Returns pairs
    (allele, vcf_alt_string); SOFT_CLIPs are excluded."""
    out = []
    for allele in alt_alleles:
        if allele.type == SUBSTITUTION:
            if len(allele.bases) > 1 and len(ref_bases) > 1:
                alt = allele.bases
            else:
                alt = make_alt_allele(allele.bases, ref_bases, 1)
        elif allele.type == INSERTION:
            alt = make_alt_allele(allele.bases, ref_bases, 1)
        elif allele.type == DELETION:
            alt = make_alt_allele(allele.bases[:1], ref_bases,
                                  len(allele.bases))
        else:
            continue
        out.append((allele, alt))
    return out


class VerySensitiveCaller:
    """Candidate proposal from an AlleleCounter interval."""

    def __init__(self, options: Optional[VariantCallerOptions] = None):
        self.options = options or VariantCallerOptions()
        self.ref_confidence = ReferenceConfidence(self.options)
        self._rng = np.random.Generator(
            np.random.Philox(self.options.random_seed)
        )
        self._par_regions_cache = None

    def _par_regions(self):
        if self._par_regions_cache is None and \
                self.options.par_regions_bed:
            from deepvariant_tpu_torch.core.ranges import RangeSet

            self._par_regions_cache = RangeSet.from_regions(
                [self.options.par_regions_bed]
            )
        return self._par_regions_cache

    # -- allele selection ---------------------------------------------------------

    def _min_count(self, allele: Allele) -> int:
        if allele.type == SUBSTITUTION:
            return self.options.min_count_snps
        return self.options.min_count_indels

    def _min_fraction(self, allele: Allele) -> float:
        """variant_calling_multisample.h:357-372."""
        o = self.options
        if allele.type == SUBSTITUTION:
            return o.min_fraction_snps
        if (o.small_indel_threshold > 0
                and o.min_indel_fraction_for_small_indels > 0.0
                and o.min_indel_fraction_for_large_indels > 0.0):
            if len(allele.bases) <= o.small_indel_threshold + 1:
                return o.min_indel_fraction_for_small_indels
            return o.min_indel_fraction_for_large_indels
        return o.min_fraction_indels

    def is_good_alt_allele(self, allele: Allele, total_count: int) -> bool:
        """variant_calling_multisample.cc:235."""
        if allele.type == REFERENCE:
            return False
        if allele.count < self._min_count(allele):
            return False
        if allele.type == SOFT_CLIP:
            return False
        if total_count == 0:
            return False
        return (
            allele.count / total_count >= self._min_fraction(allele)
        )

    def select_alt_alleles(
        self, alleles: Sequence[Allele], total_count: int
    ) -> List[Allele]:
        return [
            a for a in alleles if self.is_good_alt_allele(a, total_count)
        ]

    def select_alt_alleles_multisample(
        self,
        target_alleles: Sequence[Allele],
        target_total: int,
        all_alleles_by_key: Dict[Tuple[str, int], Allele],
        all_total: int,
        non_target_by_key: Dict[Tuple[str, int], Allele],
        non_target_total: int,
    ) -> List[Allele]:
        """Multisample AlleleFilter (variant_calling_multisample.cc
        :264-308): a target-sample allele that fails the ratio/support
        thresholds is rescued when the allele pooled over ALL samples
        passes them with min_fraction * min_fraction_multiplier (the
        trio coefficient); an allele is dropped outright when the
        NON-target samples carry it above the configured caps."""
        o = self.options
        out: List[Allele] = []
        for allele in target_alleles:
            if allele.type == REFERENCE:
                continue
            key = (allele.bases, allele.type)
            nt = non_target_by_key.get(key)
            if nt is not None and non_target_total > 0:
                cap = (
                    o.max_fraction_snps_for_non_target_sample
                    if allele.type == SUBSTITUTION
                    else o.max_fraction_indels_for_non_target_sample
                )
                if cap > 0 and nt.count / non_target_total > cap:
                    continue
            if self.is_good_alt_allele(allele, target_total):
                out.append(allele)
                continue
            if allele.type == SOFT_CLIP:
                continue
            pooled = all_alleles_by_key.get(key)
            if pooled is None or all_total == 0:
                continue
            mult = o.min_fraction_multiplier
            if (pooled.count >= self._min_count(pooled)
                    and pooled.count / all_total
                    >= self._min_fraction(pooled) * mult):
                out.append(allele)
        return out

    # -- complex alleles (--create_complex_alleles) --------------------------------

    def _complex_variant(
        self, counter: AlleleCounter, interval_pos: int,
        alt_alleles: Sequence[Allele],
    ):
        """SelectAltAllelesWithComplexVariant
        (variant_calling_multisample.cc:510-580): when a deletion
        overlaps other alleles, reads' alleles across the deletion span
        concatenate into complex SUBSTITUTION alleles, read support is
        reassigned, and selection re-runs on the modified counts.

        Returns None when no deletion/no overlap evidence, else
        (new_alt_alleles, ref_bases, modified_records) where
        modified_records maps read id -> (bases, type) at this
        position after reassignment."""
        if not any(a.type == DELETION for a in alt_alleles):
            return None
        ref_base = chr(counter.ref[interval_pos])
        ref_bases = calc_ref_bases(ref_base, alt_alleles)
        del_len = len(ref_bases)
        del_start = counter.interval.start + interval_pos
        read_to_alt = create_combined_alleles_support(
            counter, del_start, del_len
        )
        if not read_to_alt:
            return None
        complex_to_reads = create_complex_alleles_support(
            read_to_alt, del_start, del_len, ref_bases
        )

        # ReassignReadSupportForComplexAlleles (:446-488): rewrite the
        # target position's per-read alleles with the complex strings.
        pc = counter.position_count(interval_pos)
        mod_records: Dict[int, Tuple[str, int]] = {}
        if pc is not None:
            for rid, rec in pc.read_alleles.items():
                if not rec.is_low_quality:
                    mod_records[rid] = (rec.bases, rec.type)
            for rid in pc.ref_supporting_read_ids:
                mod_records[rid] = (ref_base, REFERENCE)
        for comp, rids in complex_to_reads.items():
            for rid in rids:
                if rid not in mod_records:
                    # Reads starting after the deletion start are not
                    # handled (:564-575 TODO in the reference).
                    continue
                if comp == ref_bases:
                    mod_records[rid] = (comp, REFERENCE)
                else:
                    mod_records[rid] = (comp, SUBSTITUTION)

        # Re-run the allele filter on the modified counts
        # (SelectAltAlleles with create_complex_alleles=false, :570-578).
        agg: Dict[Tuple[str, int], Allele] = {}
        total_ref = 0
        for rid, (bases, t) in mod_records.items():
            if t == REFERENCE:
                total_ref += 1
                continue
            a = agg.get((bases, t))
            if a is None:
                agg[(bases, t)] = Allele(bases, t, 1, [rid])
            else:
                a.count += 1
                a.read_ids.append(rid)
        total_mod = total_ref + sum(a.count for a in agg.values())
        new_alts = self.select_alt_alleles(
            list(agg.values()), total_mod
        )
        return new_alts, ref_bases, mod_records

    def keep_reference_site(self) -> bool:
        f = self.options.fraction_reference_sites_to_emit
        return f > 0.0 and self._rng.random() < f

    # -- candidate construction ----------------------------------------------------

    def call_position(
        self,
        counter: AlleleCounter,
        interval_pos: int,
        context_counters: Optional[Sequence[AlleleCounter]] = None,
        _state: Optional[dict] = None,
    ) -> Optional[DeepVariantCall]:
        """CallVariant for one position (variant_calling_multisample.cc:972).
        `context_counters` (multisample): ALL samples' counters over the
        same interval, enabling the pooled-sample allele rescue.
        `_state` threads prev_deletion_end / skip_until across
        positions for --create_complex_alleles."""
        ref_byte = counter.ref[interval_pos]
        if ref_byte not in CANONICAL_DNA_BASES:
            return None
        alleles = counter.sum_allele_counts(interval_pos)
        total_count = counter.total_allele_count(interval_pos)
        non_target_counters = []
        nt_by_key: Dict[Tuple[str, int], Allele] = {}
        if context_counters:
            all_by_key: Dict[Tuple[str, int], Allele] = {}
            all_total = 0
            nt_total = 0
            for c in context_counters:
                is_target = c is counter
                all_total += c.total_allele_count(interval_pos)
                if not is_target:
                    non_target_counters.append(c)
                    nt_total += c.total_allele_count(interval_pos)
                for a in c.sum_allele_counts(interval_pos):
                    key = (a.bases, a.type)
                    for acc, use in ((all_by_key, True),
                                     (nt_by_key, not is_target)):
                        if not use:
                            continue
                        prev = acc.get(key)
                        if prev is None:
                            acc[key] = dataclasses.replace(
                                a, read_ids=list(a.read_ids)
                            )
                        else:
                            prev.count += a.count
            alt_alleles = self.select_alt_alleles_multisample(
                alleles, total_count, all_by_key, all_total,
                nt_by_key, nt_total,
            )
        else:
            alt_alleles = self.select_alt_alleles(alleles, total_count)
        # --create_complex_alleles: a deletion overlapping other
        # alleles becomes a complex site with reassigned read support
        # (SelectAltAlleles, variant_calling_multisample.cc:647-657;
        # gated on prev_deletion_end so overlapped positions are not
        # re-processed).
        complex_created = False
        mod_records = None
        ref_bases = None
        if (self.options.create_complex_alleles
                and (_state is None or _state.get("prev_deletion_end", 0)
                     <= counter.interval.start + interval_pos)):
            result = self._complex_variant(
                counter, interval_pos, alt_alleles
            )
            if result is not None:
                alt_alleles, ref_bases, mod_records = result
                complex_created = True
        if not alt_alleles and not self.keep_reference_site():
            return None

        ref_base = chr(ref_byte)
        if ref_bases is None:
            ref_bases = calc_ref_bases(ref_base, alt_alleles)
        pos = counter.interval.start + interval_pos
        variant = Variant(
            reference_name=counter.interval.reference_name,
            start=pos,
            end=pos + len(ref_bases),
            reference_bases=ref_bases,
        )
        call = VariantCall(
            call_set_name=self.options.sample_name, genotype=[-1, -1]
        )
        variant.calls.append(call)

        allele_map = build_allele_map(alt_alleles, ref_bases)
        variant.alternate_bases = sorted(alt for _, alt in allele_map)
        if not allele_map:
            variant.alternate_bases = [NO_ALT_ALLELE]

        # DP / AD / VAF (AddReadDepths, :727).
        dp = total_count
        call.info["DP"] = [dp]
        if allele_map:
            alt_to_allele = {alt: a for a, alt in allele_map}
            ad = [int(counter.ref_count[interval_pos])]
            vaf = []
            for alt in variant.alternate_bases:
                a = alt_to_allele[alt]
                ad.append(a.count)
                vaf.append(a.count / dp if dp else 0.0)
            call.info["AD"] = ad
            call.info["VAF"] = vaf

        # Matched-normal depths on the tumor call (AddNormalReadDepths,
        # variant_calling_multisample.cc:810-844, gated at :1131-1146):
        # NDP/NAD's ref row come from the FIRST non-target (normal)
        # sample's counter; per-alt NAD counts from the non-target
        # pooled alleles, 0 when the normal lacks the tumor allele.
        if (self.options.target_sample_role == "tumor"
                and non_target_counters and allele_map):
            first_nt = non_target_counters[0]
            ndp = first_nt.total_allele_count(interval_pos)
            nad = [int(first_nt.ref_count[interval_pos])]
            naf = []
            for alt in variant.alternate_bases:
                a = alt_to_allele[alt]
                na = nt_by_key.get((a.bases, a.type))
                n_count = na.count if na is not None else 0
                nad.append(n_count)
                naf.append(n_count / ndp if ndp > 0 else 0.0)
            call.info["NDP"] = [ndp]
            call.info["NAD"] = nad
            call.info["NAF"] = naf

        # Supporting reads per alt (AddSupportingReads, :1180): reads whose
        # allele maps to a variant alt support it; other non-ref alleles
        # support UNCALLED_ALLELE.
        support: Dict[str, List[int]] = {}
        mapped = {(a.bases, a.type): alt for a, alt in allele_map}
        if complex_created and mod_records is not None:
            # Supporting reads come from the reassigned records
            # (AddSupportingReads with allele_counts_mod, :1147-1151).
            ref_ids = []
            for rid, (bases, rec_type) in mod_records.items():
                if rec_type == REFERENCE:
                    ref_ids.append(rid)
                    continue
                alt = mapped.get((bases, rec_type))
                key = alt if alt is not None else SUPPORTING_UNCALLED_ALLELE
                support.setdefault(key, []).append(rid)
        else:
            pc = counter.position_count(interval_pos)
            if pc is not None:
                for rid, rec in pc.read_alleles.items():
                    if rec.is_low_quality:
                        continue
                    alt = mapped.get((rec.bases, rec.type))
                    key = alt if alt is not None \
                        else SUPPORTING_UNCALLED_ALLELE
                    support.setdefault(key, []).append(rid)
            ref_ids = (
                list(pc.ref_supporting_read_ids) if pc is not None else []
            )
        if _state is not None:
            if any(a.type == DELETION for a in alt_alleles):
                _state["prev_deletion_end"] = pos + len(ref_bases)
            if (complex_created and len(ref_bases) > 1
                    and len(allele_map) > 1):
                # Skip the positions covered by the complex site
                # (skip_next_count, :1109-1112).
                _state["skip_until"] = pos + len(ref_bases)
        # Context VAFs for the small model
        # (AddAdjacentAlleleFractionsAtPosition,
        # variant_calling_multisample.cc:1288-1314, gated at :1160):
        # integer percent of non-ref read alleles over depth at every
        # position within +/- window//2 of the candidate, clamped to
        # the counter interval.
        ctx_vafs: Dict[int, int] = {}
        w = self.options.small_model_vaf_context_window_size
        if w > 0:
            half = w // 2
            size = len(counter.interval)
            for p in range(max(0, interval_pos - half),
                           min(size, interval_pos + half + 1)):
                pc_p = counter.position_count(p)
                n_alt = len(pc_p.read_alleles) if pc_p is not None else 0
                depth = int(counter.ref_count[p]) + n_alt
                ctx_vafs[counter.interval.start + p] = (
                    (100 * n_alt) // depth if depth > 0 else 0
                )
        return DeepVariantCall(
            variant=variant, allele_support=support, ref_support=ref_ids,
            allele_keys=dict(mapped),
            allele_frequency_at_position=ctx_vafs,
        )

    def support_from_counter(
        self, counter: AlleleCounter, dv_call: DeepVariantCall
    ) -> Tuple[Dict[str, List[int]], List[int]]:
        """(allele_support, ref_support) of THIS counter's sample for an
        existing candidate (AddSupportingReads per sample,
        variant_calling_multisample.cc:1180)."""
        pos = dv_call.variant.start - counter.interval.start
        if not 0 <= pos < len(counter.interval):
            return {}, []
        support: Dict[str, List[int]] = {}
        pc = counter.position_count(pos)
        if pc is None:
            return {}, []
        for rid, rec in pc.read_alleles.items():
            if rec.is_low_quality:
                continue
            alt = dv_call.allele_keys.get((rec.bases, rec.type))
            key = alt if alt is not None else SUPPORTING_UNCALLED_ALLELE
            support.setdefault(key, []).append(rid)
        return support, list(pc.ref_supporting_read_ids)

    def calls_in_region(
        self, counter: AlleleCounter,
        context_counters: Optional[Sequence[AlleleCounter]] = None,
    ) -> List[DeepVariantCall]:
        out = []
        width = len(counter.interval)
        candidates = set(counter.positions_with_alleles())
        if self.options.fraction_reference_sites_to_emit > 0.0:
            candidates = set(range(width))
        state = {"prev_deletion_end": 0, "skip_until": -1}
        for pos in sorted(candidates):
            if counter.interval.start + pos < state["skip_until"]:
                continue
            call = self.call_position(
                counter, pos, context_counters=context_counters,
                _state=state,
            )
            if call is not None:
                out.append(call)
        return out

    # -- gVCF ----------------------------------------------------------------------

    def make_gvcfs(
        self,
        counter: AlleleCounter,
        include_med_dp: bool = False,
        left_padding: int = 0,
        right_padding: int = 0,
    ) -> Iterator[Variant]:
        """Reference blocks for every interval position
        (variant_caller.py:256-420 make_gvcfs).

        left_padding/right_padding crop the phasing-padded flanks out
        of the gvcf (summary_counts(left_padding, right_padding),
        variant_caller.py:461-464), so blocks match an unpadded run."""
        interval = counter.interval
        ref_count, total_count = counter.summary_counts()
        is_haploid_contig = (
            interval.reference_name in self.options.haploid_contigs
        )
        if is_haploid_contig and self.options.par_regions_bed:
            # PAR regions on haploid contigs stay diploid
            # (--par_regions_bed; postprocess_variants.py:1070 analog).
            par = self._par_regions()
            if par is not None and any(
                par.overlaps(interval.reference_name, pos)
                for pos in (interval.start, interval.end - 1)
            ):
                is_haploid_contig = False
        opts = self.options
        width = len(interval)

        # Compute per-position (quantized_gq, raw_gq, likelihood idx, valid).
        records = []
        for i in range(left_padding, width - right_padding):
            ref_byte = counter.ref[i]
            if ref_byte not in CANONICAL_DNA_BASES:
                if ref_byte in EXTENDED_IUPAC_CODES:
                    records.append(
                        (None, None, None, True, int(total_count[i]), i)
                    )
                    continue
                raise ValueError(
                    f"invalid reference base {chr(ref_byte)} at "
                    f"{interval.reference_name}:{interval.start + i}"
                )
            raw_gq, likelihoods = self.ref_confidence(
                int(ref_count[i]), int(total_count[i]), is_haploid_contig
            )
            quantized = _quantize_gq(raw_gq, opts.gq_resolution)
            has_valid_gl = bool(
                np.max(likelihoods) == likelihoods[0]
            )
            records.append(
                (quantized, raw_gq, likelihoods, has_valid_gl,
                 int(total_count[i]), i)
            )

        # Group contiguous records by (quantized_gq, has_valid_gl).
        import itertools

        for (qgq, valid), group in itertools.groupby(
            records, key=lambda r: (r[0], r[3])
        ):
            if qgq is None:
                continue
            group = list(group)
            if valid:
                min_idx, min_gq = min(
                    enumerate(g[1] for g in group), key=lambda p: p[1]
                )
                min_dp = min(g[4] for g in group)
                first, last = group[0], group[-1]
                call = VariantCall(
                    call_set_name=opts.sample_name,
                    genotype=[0, 0],
                    genotype_likelihood=list(group[min_idx][2]),
                    info={"GQ": [min_gq], "MIN_DP": [min_dp]},
                )
                if include_med_dp:
                    import statistics

                    call.info["MED_DP"] = [
                        int(statistics.median(g[4] for g in group))
                    ]
                yield Variant(
                    reference_name=interval.reference_name,
                    reference_bases=chr(counter.ref[first[5]]),
                    alternate_bases=[GVCF_ALT_ALLELE],
                    start=interval.start + first[5],
                    end=interval.start + last[5] + 1,
                    info={"END": [interval.start + last[5] + 1]},
                    calls=[call],
                )
            else:
                for g in group:
                    call = VariantCall(
                        call_set_name=opts.sample_name,
                        genotype=[-1, -1],
                        genotype_likelihood=list(g[2]),
                        info={"GQ": [g[1]], "MIN_DP": [g[4]]},
                    )
                    if include_med_dp:
                        call.info["MED_DP"] = [g[4]]
                    yield Variant(
                        reference_name=interval.reference_name,
                        reference_bases=chr(counter.ref[g[5]]),
                        alternate_bases=[GVCF_ALT_ALLELE],
                        start=interval.start + g[5],
                        end=interval.start + g[5] + 1,
                        info={"END": [interval.start + g[5] + 1]},
                        calls=[call],
                    )

"""Family-trio and tumor/normal read simulation.

The port's copy of `deepvariant_tpu.training.simulate_family`: host
numpy with the JAX module's draws in the same order, so the BAMs, truth
VCFs and BED equal the JAX package's byte for byte on the same template.
Both drivers raise ValueError without a template BAM
(`simulate.require_template`): the port has no default template.

Extends the diploid simulator (training/simulate.py) to the two
multi-sample products so DeepTrio and DeepSomatic models can be
trained and *measured* end-to-end — the reference ships both as
flagship products with published accuracy (deeptrio/make_examples.py,
deepvariant/make_examples_somatic.py, docs/metrics.md) but no trio or
tumor truth data at training scale is at hand, so the corpora
are simulated with the same fitted error model the WGS accuracy
artifacts use.

Trio genetics (``simulate_trio_corpus``):
  * a POPULATION of variant loci is sampled once per window; each of
    the four parental haplotypes carries a locus' alt allele with the
    locus' population allele frequency (mixture of common and rare
    AFs), so parents share common variants exactly the way unrelated
    members of one population do;
  * the child inherits one haplotype from each parent with crossovers
    at the human-scale recombination rate — genotypes are mendelian
    by construction;
  * de-novo variants are injected child-only at a configurable rate.
    The default is deliberately ELEVATED vs the real ~1.2e-8/bp so a
    megabase-scale corpus carries a de-novo set large enough to
    measure recall on (documented wherever results are reported).

Somatic process (``simulate_somatic_corpus``):
  * the normal sample is a plain diploid genome (germline variants);
  * the tumor shares the germline and adds somatic variants placed on
    one haplotype with a per-site variant allele fraction drawn
    log-uniform over a configurable spectrum (default 5-50%) — the
    read-sourcing rule in ``simulate_window_reads`` turns
    ``p_ref_draw = 1 - VAF`` into exactly that expected alt-read
    fraction;
  * sequencing-error hotspots are SHARED between the related samples
    (plus sample-private ones), creating the hard negatives that
    define these products: an artifact seen in the whole family is
    not a de-novo, an artifact in tumor+normal is not somatic.

Everything downstream — stacked pileups, labeling, training — runs
through the production multi-sample path
(make_examples/multisample.py), same as real data would.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import Range, Variant, VariantCall
from deepvariant_tpu_torch.training.simulate import (
    QualityModel,
    SimConfig,
    SimVariant,
    build_haplotype,
    require_template,
    sample_hotspots,
    sample_variants,
    simulate_window_reads,
)


def _p_ref_for_genotype(
    rng: np.random.Generator, gt: Tuple[int, int]
) -> float:
    """Per-sample read-sourcing bias, matching sample_variants'
    het reference-bias / hom-alt contamination model."""
    if gt == (1, 1):
        return (
            float(rng.uniform(0.01, 0.10))
            if rng.random() < 0.4 else 0.0
        )
    return 1.0 - float(rng.beta(30.0, 32.0))


def _non_colliding(
    candidates: Sequence[SimVariant],
    taken: Sequence[SimVariant],
    guard: int,
) -> List[SimVariant]:
    """Drop candidate loci whose REF interval comes within `guard` bp
    of any taken locus (build_haplotype applies variants on a simple
    cursor walk, so intervals must stay disjoint)."""
    if not taken:
        return list(candidates)
    starts = np.array([t.pos - guard for t in taken])
    ends = np.array([t.pos + len(t.ref) + guard for t in taken])
    order = np.argsort(starts)
    starts, ends = starts[order], ends[order]
    out = []
    for c in candidates:
        i = int(np.searchsorted(starts, c.pos + len(c.ref))) - 1
        if i >= 0 and ends[i] > c.pos:
            continue
        out.append(c)
    return out


def _write_truth_vcf(
    path: str,
    contigs,
    contig: str,
    variants: Sequence[SimVariant],
    sample_name: str,
    info_by_pos: Optional[Dict[int, Dict[str, List]]] = None,
) -> None:
    from deepvariant_tpu_torch.io.vcf import VcfHeader, VcfWriter

    header = VcfHeader(contigs, [sample_name])
    writer = VcfWriter(path, header)
    for v in sorted(variants, key=lambda x: x.pos):
        writer.write(Variant(
            reference_name=contig,
            start=v.pos,
            end=v.pos + len(v.ref),
            reference_bases=v.ref,
            alternate_bases=[v.alt],
            quality=50.0,
            filter=["PASS"],
            info=(info_by_pos or {}).get(v.pos, {}),
            calls=[VariantCall(
                call_set_name=sample_name,
                genotype=list(v.genotype),
                is_phased=True,
            )],
        ))
    writer.close()


def _write_bam(
    path: str, contigs, reads, sample_name: str
) -> None:
    from deepvariant_tpu_torch.io.bam_writer import BamWriter, build_bam_index

    reads.sort(key=lambda r: r.position)
    writer = BamWriter(path, contigs, sample_name=sample_name)
    for rd in reads:
        writer.write_read(rd)
    writer.close()
    build_bam_index(path)


# ---------------------------------------------------------------------------
# Trio
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrioSimConfig:
    """Knobs for one simulated family replicate.

    Population/error knobs default to the calibrated single-sample
    values (SimConfig); the base SimConfig built from this carries
    them to the shared read-emission machinery.
    """

    ref_path: str
    contig: str
    windows: Sequence[Tuple[int, int]]
    seed: int = 0
    coverage_child: float = 32.0
    coverage_parent: float = 32.0
    template_bam: str = SimConfig.template_bam
    template_region: Tuple[str, int, int] = SimConfig.template_region
    # Population allele-frequency mixture: `common_fraction` of loci
    # draw AF ~ Beta(2,2) (common polymorphisms parents often share),
    # the rest Beta(1,9) floored at 0.02 (rare variants usually
    # carried by one parent only).
    common_fraction: float = 0.55
    # De novo rate per bp — ELEVATED ~400x over the real ~1.2e-8 so a
    # ~1 Mbp corpus holds a measurable de-novo set (~25/Mbp).
    de_novo_snv_rate: float = 1.0 / 50_000.0
    de_novo_indel_rate: float = 1.0 / 250_000.0
    # Human-scale crossover rate (~1.2 cM/Mb per meiosis).
    recombination_rate: float = 1.2e-8
    # Fraction of the shared hotspot rate drawn privately per sample
    # (run-specific artifacts; child-only artifacts are the hard
    # negative for de-novo calling).
    private_hotspot_fraction: float = 0.35
    sample_name_child: str = "child"
    sample_name_parent1: str = "parent1"
    sample_name_parent2: str = "parent2"

    def base_sim_config(self) -> SimConfig:
        return SimConfig(
            ref_path=self.ref_path, contig=self.contig,
            windows=self.windows, seed=self.seed,
            template_bam=self.template_bam,
            template_region=self.template_region,
        )


@dataclasses.dataclass
class _FamilyLocus:
    pos: int
    ref: str
    alt: str
    af: float
    # Alt carriage per parental haplotype [p1h0, p1h1, p2h0, p2h1].
    parent_haps: Tuple[int, int, int, int]


def sample_population_loci(
    rng: np.random.Generator,
    ref: np.ndarray,
    lo: int,
    hi: int,
    cfg: TrioSimConfig,
    base: SimConfig,
) -> List[_FamilyLocus]:
    """Population loci with per-haplotype alt carriage for two
    unrelated parents."""
    proposals = sample_variants(rng, ref, lo, hi, base)
    out: List[_FamilyLocus] = []
    for p in proposals:
        if rng.random() < cfg.common_fraction:
            af = float(rng.beta(2.0, 2.0))
        else:
            af = max(0.02, float(rng.beta(1.0, 9.0)))
        haps = tuple(int(rng.random() < af) for _ in range(4))
        if not any(haps):
            continue
        out.append(_FamilyLocus(p.pos, p.ref, p.alt, af, haps))
    return out


def _transmit(
    rng: np.random.Generator,
    loci_pos: np.ndarray,
    lo: int,
    hi: int,
    rate: float,
) -> np.ndarray:
    """Which haplotype (0/1) a parent transmits at each locus, with
    Poisson crossovers along the window."""
    start = int(rng.integers(2))
    n_cross = rng.poisson((hi - lo) * rate)
    if n_cross == 0:
        return np.full(len(loci_pos), start, np.int64)
    points = np.sort(rng.integers(lo, hi, n_cross))
    flips = np.searchsorted(points, loci_pos, side="right")
    return (start + flips) % 2


def simulate_trio_corpus(
    cfg: TrioSimConfig, outdir: str
) -> Dict[str, object]:
    """Simulate one family replicate: three BAMs, per-sample truth
    VCFs, a de-novo truth VCF, and a confident BED."""
    from deepvariant_tpu_torch.io.fasta import FastaReader

    require_template(cfg.template_bam)
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    base = cfg.base_sim_config()
    ref_reader = FastaReader(cfg.ref_path)
    contig_info = next(
        c for c in ref_reader.contigs if c.name == cfg.contig
    )
    ref = np.frombuffer(
        ref_reader.query(
            Range(cfg.contig, 0, contig_info.n_bases)
        ).upper().encode(),
        np.uint8,
    )
    qual_model = QualityModel.from_bam(
        cfg.template_bam, Range(*cfg.template_region)
    )
    base = dataclasses.replace(
        base,
        read_length=qual_model.read_length,
        fragment_mean=qual_model.fragment_mean,
        fragment_std=qual_model.fragment_std,
    )

    sample_names = [
        cfg.sample_name_child,
        cfg.sample_name_parent1,
        cfg.sample_name_parent2,
    ]
    coverages = [cfg.coverage_child, cfg.coverage_parent,
                 cfg.coverage_parent]
    all_reads: List[List] = [[], [], []]
    all_variants: List[List[SimVariant]] = [[], [], []]
    denovo: List[SimVariant] = []

    for w_idx, (lo, hi) in enumerate(cfg.windows):
        loci = sample_population_loci(rng, ref, lo, hi, cfg, base)
        loci_pos = np.array([l.pos for l in loci], np.int64)

        # Child transmission (child hap0 <- parent1, hap1 <- parent2).
        t1 = _transmit(rng, loci_pos, lo, hi, cfg.recombination_rate)
        t2 = _transmit(rng, loci_pos, lo, hi, cfg.recombination_rate)

        # De novos: fresh loci at the elevated rate, child-only het.
        dn_base = dataclasses.replace(
            base,
            snv_rate=cfg.de_novo_snv_rate,
            indel_rate=cfg.de_novo_indel_rate,
        )
        dn_proposals = sample_variants(rng, ref, lo, hi, dn_base)
        guard = base.max_indel_len + 2
        taken = [
            SimVariant(l.pos, l.ref, l.alt, (0, 1)) for l in loci
        ]
        dn_loci = _non_colliding(dn_proposals, taken, guard)

        # Per-sample phased variant lists.
        per_sample: List[List[SimVariant]] = [[], [], []]
        for i, l in enumerate(loci):
            gts = [
                (int(l.parent_haps[t1[i]]),
                 int(l.parent_haps[2 + t2[i]])),  # child
                (l.parent_haps[0], l.parent_haps[1]),  # parent1
                (l.parent_haps[2], l.parent_haps[3]),  # parent2
            ]
            for s, gt in enumerate(gts):
                if gt == (0, 0):
                    continue
                per_sample[s].append(SimVariant(
                    l.pos, l.ref, l.alt, gt,
                    _p_ref_for_genotype(rng, gt),
                ))
        for d in dn_loci:
            hap = int(rng.integers(2))
            gt = (1, 0) if hap == 0 else (0, 1)
            dn = SimVariant(
                d.pos, d.ref, d.alt, gt,
                _p_ref_for_genotype(rng, gt),
            )
            per_sample[0].append(dn)
            denovo.append(dn)
        for s in range(3):
            per_sample[s].sort(key=lambda v: v.pos)

        # Family-shared artifacts + per-sample private ones.
        union = sorted(
            {(v.pos, v.ref): v for vs in per_sample for v in vs}
            .values(), key=lambda v: v.pos,
        )
        shared_hot = sample_hotspots(rng, ref, lo, hi, base, union)
        private_base = dataclasses.replace(
            base,
            hotspot_rate=(
                base.hotspot_rate * cfg.private_hotspot_fraction
            ),
        )
        slip_rates: Dict[int, Tuple[float, float]] = {}
        for s in range(3):
            private_hot = sample_hotspots(
                rng, ref, lo, hi, private_base, union
            )
            hot = dict(shared_hot)
            hot.update(private_hot)
            haps = [
                build_haplotype(ref, lo, hi, per_sample[s], hap)
                for hap in (0, 1)
            ]
            haps.append((
                ref[lo:hi].copy(), np.arange(lo, hi, dtype=np.int64)
            ))
            scfg = dataclasses.replace(base, coverage=coverages[s])
            all_reads[s].extend(simulate_window_reads(
                rng, haps, scfg, qual_model, cfg.contig, hot,
                name_prefix=f"trio{cfg.seed}w{w_idx}s{s}",
                variants=per_sample[s], window=(lo, hi),
                slip_shared_rates=slip_rates,
            ))
            all_variants[s].extend(per_sample[s])

    paths: Dict[str, object] = {}
    roles = ["child", "parent1", "parent2"]
    for s, role in enumerate(roles):
        bam = os.path.join(outdir, f"{role}.bam")
        _write_bam(bam, ref_reader.contigs, all_reads[s],
                   sample_names[s])
        vcf = os.path.join(outdir, f"truth_{role}.vcf.gz")
        _write_truth_vcf(vcf, ref_reader.contigs, cfg.contig,
                         all_variants[s], sample_names[s])
        paths[f"bam_{role}"] = bam
        paths[f"truth_{role}"] = vcf
    dn_vcf = os.path.join(outdir, "truth_denovo.vcf.gz")
    _write_truth_vcf(dn_vcf, ref_reader.contigs, cfg.contig, denovo,
                     sample_names[0])
    bed = os.path.join(outdir, "confident.bed")
    with open(bed, "w") as f:
        for lo, hi in cfg.windows:
            f.write(f"{cfg.contig}\t{lo}\t{hi}\n")
    paths.update(
        truth_denovo=dn_vcf,
        confident_bed=bed,
        n_child_variants=len(all_variants[0]),
        n_denovo=len(denovo),
        n_reads=sum(len(r) for r in all_reads),
        child_variants=all_variants[0],
        denovo_variants=denovo,
    )
    return paths


# ---------------------------------------------------------------------------
# Tumor / normal
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SomaticSimConfig:
    """Knobs for one simulated tumor/normal replicate."""

    ref_path: str
    contig: str
    windows: Sequence[Tuple[int, int]]
    seed: int = 0
    coverage_tumor: float = 60.0
    coverage_normal: float = 30.0
    template_bam: str = SimConfig.template_bam
    template_region: Tuple[str, int, int] = SimConfig.template_region
    # Somatic burden — ELEVATED vs real tumors (~1-100/Mb) so a ~1 Mbp
    # corpus holds hundreds of somatic training sites.
    somatic_snv_rate: float = 1.0 / 3_000.0
    somatic_indel_rate: float = 1.0 / 15_000.0
    # VAF spectrum: log-uniform over [vaf_min, vaf_max] — subclonal
    # populations and impure tumors put most somatic sites well below
    # the germline-het 0.5 band.
    vaf_min: float = 0.05
    vaf_max: float = 0.5
    private_hotspot_fraction: float = 0.35
    sample_name_tumor: str = "tumor"
    sample_name_normal: str = "normal"

    def base_sim_config(self) -> SimConfig:
        return SimConfig(
            ref_path=self.ref_path, contig=self.contig,
            windows=self.windows, seed=self.seed,
            template_bam=self.template_bam,
            template_region=self.template_region,
        )


def simulate_somatic_corpus(
    cfg: SomaticSimConfig, outdir: str
) -> Dict[str, object]:
    """Simulate one tumor/normal replicate: two BAMs, a somatic truth
    VCF (INFO VAF per record), a germline VCF, and a confident BED."""
    from deepvariant_tpu_torch.io.fasta import FastaReader

    require_template(cfg.template_bam)
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    base = cfg.base_sim_config()
    ref_reader = FastaReader(cfg.ref_path)
    contig_info = next(
        c for c in ref_reader.contigs if c.name == cfg.contig
    )
    ref = np.frombuffer(
        ref_reader.query(
            Range(cfg.contig, 0, contig_info.n_bases)
        ).upper().encode(),
        np.uint8,
    )
    qual_model = QualityModel.from_bam(
        cfg.template_bam, Range(*cfg.template_region)
    )
    base = dataclasses.replace(
        base,
        read_length=qual_model.read_length,
        fragment_mean=qual_model.fragment_mean,
        fragment_std=qual_model.fragment_std,
    )

    tumor_reads: List = []
    normal_reads: List = []
    germline_all: List[SimVariant] = []
    somatic_all: List[SimVariant] = []
    vaf_by_pos: Dict[int, float] = {}

    for w_idx, (lo, hi) in enumerate(cfg.windows):
        germline = sample_variants(rng, ref, lo, hi, base)
        som_base = dataclasses.replace(
            base,
            snv_rate=cfg.somatic_snv_rate,
            indel_rate=cfg.somatic_indel_rate,
        )
        som_proposals = sample_variants(rng, ref, lo, hi, som_base)
        guard = base.max_indel_len + 2
        somatic: List[SimVariant] = []
        for p in _non_colliding(som_proposals, germline, guard):
            vaf = float(np.exp(rng.uniform(
                np.log(cfg.vaf_min), np.log(cfg.vaf_max)
            )))
            hap = int(rng.integers(2))
            somatic.append(SimVariant(
                p.pos, p.ref, p.alt,
                (1, 0) if hap == 0 else (0, 1),
                p_ref_draw=1.0 - vaf,
                source_priority=1,
            ))
            vaf_by_pos[p.pos] = vaf
        tumor_variants = sorted(
            germline + somatic, key=lambda v: v.pos
        )

        shared_hot = sample_hotspots(
            rng, ref, lo, hi, base, tumor_variants
        )
        private_base = dataclasses.replace(
            base,
            hotspot_rate=(
                base.hotspot_rate * cfg.private_hotspot_fraction
            ),
        )
        slip_rates: Dict[int, Tuple[float, float]] = {}
        for variants, reads_out, cov, tag in (
            (tumor_variants, tumor_reads, cfg.coverage_tumor, "t"),
            (germline, normal_reads, cfg.coverage_normal, "n"),
        ):
            private_hot = sample_hotspots(
                rng, ref, lo, hi, private_base, tumor_variants
            )
            hot = dict(shared_hot)
            hot.update(private_hot)
            haps = [
                build_haplotype(ref, lo, hi, variants, hap)
                for hap in (0, 1)
            ]
            haps.append((
                ref[lo:hi].copy(), np.arange(lo, hi, dtype=np.int64)
            ))
            scfg = dataclasses.replace(base, coverage=cov)
            reads_out.extend(simulate_window_reads(
                rng, haps, scfg, qual_model, cfg.contig, hot,
                name_prefix=f"som{cfg.seed}w{w_idx}{tag}",
                variants=variants, window=(lo, hi),
                slip_shared_rates=slip_rates,
            ))
        germline_all.extend(germline)
        somatic_all.extend(somatic)

    bam_tumor = os.path.join(outdir, "tumor.bam")
    bam_normal = os.path.join(outdir, "normal.bam")
    _write_bam(bam_tumor, ref_reader.contigs, tumor_reads,
               cfg.sample_name_tumor)
    _write_bam(bam_normal, ref_reader.contigs, normal_reads,
               cfg.sample_name_normal)
    # DeepSomatic class convention (postprocess _apply_somatic_filters
    # / reference vcf_writer.cc WriteSomatic): class 1 (het) = GERMLINE
    # (GT rewritten to 0/0, GERMLINE filter), class 2 (hom-alt) =
    # SOMATIC (stays PASS). Training truth therefore encodes every
    # germline variant as 0/1 (-> label 1) regardless of its real
    # zygosity and every somatic variant as 1/1 (-> label 2).
    vaf_info = {
        pos: {"VAF": [round(v, 4)]} for pos, v in vaf_by_pos.items()
    }
    truth_somatic = os.path.join(outdir, "truth_somatic.vcf.gz")
    _write_truth_vcf(
        truth_somatic, ref_reader.contigs, cfg.contig,
        [dataclasses.replace(v, genotype=(1, 1)) for v in somatic_all],
        cfg.sample_name_tumor,
        info_by_pos=vaf_info,
    )
    truth_training = os.path.join(outdir, "truth_training.vcf.gz")
    _write_truth_vcf(
        truth_training, ref_reader.contigs, cfg.contig,
        [dataclasses.replace(v, genotype=(0, 1))
         for v in germline_all]
        + [dataclasses.replace(v, genotype=(1, 1))
           for v in somatic_all],
        cfg.sample_name_tumor,
        info_by_pos=vaf_info,
    )
    truth_germline = os.path.join(outdir, "truth_germline.vcf.gz")
    _write_truth_vcf(truth_germline, ref_reader.contigs, cfg.contig,
                     germline_all, cfg.sample_name_normal)
    bed = os.path.join(outdir, "confident.bed")
    with open(bed, "w") as f:
        for lo, hi in cfg.windows:
            f.write(f"{cfg.contig}\t{lo}\t{hi}\n")
    return {
        "bam_tumor": bam_tumor,
        "bam_normal": bam_normal,
        "truth_somatic": truth_somatic,
        "truth_training": truth_training,
        "truth_germline": truth_germline,
        "confident_bed": bed,
        "n_somatic": len(somatic_all),
        "n_germline": len(germline_all),
        "vaf_by_pos": vaf_by_pos,
        "somatic_variants": somatic_all,
        "germline_variants": germline_all,
    }

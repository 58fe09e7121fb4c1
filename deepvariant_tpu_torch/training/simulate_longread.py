"""Long-read (PacBio HiFi / ONT) diploid read simulator.

The port's copy of `deepvariant_tpu.training.simulate_longread`: host
numpy with the JAX module's draws in the same order, so a corpus equals
the JAX package's byte for byte on the same template BAM and FASTA.
`simulate_corpus_longread` raises ValueError without a template BAM.

Extends the Illumina simulator (training/simulate.py) to the
long-read model families so the PACBIO / ONT_R104 presets can train
on a scaled synthetic corpus instead of a handful of real labeled
examples (an ONT run with ONE het training example in a fold scored
indel F1 0.0 — a data problem, not a pipeline problem).

Everything platform-specific about long reads lives here; the truth
process (sample_variants), haplotype construction (build_haplotype)
and alignment synthesis (cigar_from_refpos) are shared with the
Illumina path, so truth VCF / BED / labeling semantics are identical.

The error model is FITTED to a real template BAM (the same approach
the Illumina simulator takes with quality strings):
  * read lengths: empirical resampling of the template's length
    distribution;
  * base qualities: whole quality strings resampled from the template
    (concatenated/cropped to the simulated length), preserving the
    within-read quality structure;
  * substitutions: quality-driven (p = 10^(-q/10)), as in the
    Illumina path — long-read base qualities are calibrated;
  * indels: the dominant long-read error mode. Per-base insertion /
    deletion EVENT rates and event-length distributions are measured
    from the template CIGARs, and the fraction of events anchored in
    reference homopolymer runs (>=3) is measured by walking each
    template alignment against the reference. Homopolymer-anchored
    errors are SYSTEMATIC: the per-site rate grows with run length
    (p = r0 * (run_len - 2)^1.3, capped), with r0 calibrated so the
    aggregate simulated event rate matches the template measurement.
    That site recurrence is what creates candidate-threshold-passing
    hom-ref indel pileups — the class-0 examples an ONT model must
    learn to reject. Non-homopolymer events are i.i.d. per read.

Reads are emitted single-end (number_reads=1), mapq 60, strand
uniform — the long-read products (make_examples presets PACBIO /
ONT_R104: phased haplotype-sorted pileups, diff_channels alt
alignment, no realigner) consume them exactly like real data.

Reference anchors: the reference trains its PacBio/ONT models on real
GIAB data (docs/deepvariant-training-case-study.md); its long-read
example path is pileup_image_native.cc + alt_aligned_pileup_lib.h:75
with reads trimmed to the window (TrimReads, :87).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import (
    OPS_CONSUME_READ,
    OPS_CONSUME_REF,
    Range,
    Read,
    Variant,
    VariantCall,
)
from deepvariant_tpu_torch.training.simulate import (
    SimConfig,
    build_haplotype,
    cigar_from_refpos,
    homopolymer_runs,
    require_template,
    sample_hotspots,
    sample_variants,
)

_BASES = np.frombuffer(b"ACGT", np.uint8)
_OP_I, _OP_D = 2, 3
_HP_MIN_RUN = 3          # homopolymer run length that counts as a tract
_HP_EXP = 1.3            # site rate ~ (run_len - 2)^_HP_EXP
_HP_SITE_CAP = 0.35      # per-read per-site slip probability ceiling
_MAX_ERR_LEN = 8         # cap on per-event error indel length


@dataclasses.dataclass
class LongReadSimConfig:
    """Long-read replicate knobs (truth process comes from SimConfig)."""

    ref_path: str
    contig: str
    windows: Sequence[Tuple[int, int]]
    template_bam: str
    template_region: Tuple[str, int, int]
    # FASTA the template BAM is aligned to (for homopolymer fitting);
    # may differ from ref_path (e.g. masked eval FASTA).
    template_ref_path: str = ""
    seed: int = 0
    # 0 = fit from the template (LongReadModel.mean_depth).
    coverage: float = 0.0
    # Per-window depth multiplier range: real runs are not uniform
    # depth, and a model trained at ONE depth latches onto absolute
    # alt-row counts (measured: a 32x-trained model called 42x real
    # hets hom-alt). (lo, hi) multiplies `coverage` per window.
    # With (0.75, 1.3) a PacBio model called every
    # hom-alt below ~0.75x of the fitted mean het (the CNN latches
    # onto absolute alt-row counts; the held-out sim eval drew a
    # 0.87-jitter window and scored 0.64 with 245 uniform hom->het
    # flips at qual ~11). The wider envelope forces depth-invariant
    # features.
    depth_jitter: Tuple[float, float] = (0.5, 1.45)
    # Truth process (same knobs/defaults as the Illumina simulator).
    snv_rate: float = 1.0 / 250.0
    indel_rate: float = 1.0 / 1400.0
    max_indel_len: int = 12
    het_fraction: float = 0.67
    indel_repeat_fraction: float = 0.7
    # Substitution hotspots (clustered systematic SNP noise).
    hotspot_rate: float = 1.0 / 1200.0
    hotspot_min_frac: float = 0.05
    hotspot_max_frac: float = 0.25
    # Fraction of fragments drawn from the pure reference sequence
    # (mapping errors / sample contamination).
    ref_contamination: float = 0.02
    error_rate_scale: float = 1.0
    # Clamp on simulated read lengths (template resample is clipped).
    min_read_length: int = 500
    max_read_length: int = 80_000
    sample_name: str = "SIM"

    def truth_config(self) -> SimConfig:
        """SimConfig view for the shared truth-sampling helpers."""
        return SimConfig(
            ref_path=self.ref_path,
            contig=self.contig,
            windows=self.windows,
            seed=self.seed,
            snv_rate=self.snv_rate,
            indel_rate=self.indel_rate,
            max_indel_len=self.max_indel_len,
            het_fraction=self.het_fraction,
            indel_repeat_fraction=self.indel_repeat_fraction,
            hotspot_rate=self.hotspot_rate,
            hotspot_min_frac=self.hotspot_min_frac,
            hotspot_max_frac=self.hotspot_max_frac,
        )


class LongReadModel:
    """Error/length/quality model fitted to a real long-read BAM."""

    def __init__(
        self,
        lengths: np.ndarray,
        quality_pool: List[np.ndarray],
        ins_event_rate: float,
        del_event_rate: float,
        ins_lengths: np.ndarray,
        del_lengths: np.ndarray,
        hp_fraction: float,
        mean_depth: float = 32.0,
        extra_sub_rate: float = 0.0,
    ):
        if not len(lengths) or not quality_pool:
            raise ValueError("template fit produced no reads")
        self.lengths = lengths
        self.quality_pool = quality_pool
        self.ins_event_rate = ins_event_rate
        self.del_event_rate = del_event_rate
        self.ins_lengths = ins_lengths if len(ins_lengths) else \
            np.ones(1, np.int64)
        self.del_lengths = del_lengths if len(del_lengths) else \
            np.ones(1, np.int64)
        self.hp_fraction = hp_fraction
        self.mean_depth = mean_depth
        # Substitution rate NOT explained by base qualities: HiFi
        # consensus/alignment artifacts show up as mismatches at Q93
        # (measured on test_pacbio: 0.0013/base observed vs ~0.0002
        # quality-implied). Simulating errors only where quality is
        # low trains a model on speckle-free backgrounds that real
        # pileups never have.
        self.extra_sub_rate = extra_sub_rate

    @classmethod
    def from_bam(
        cls,
        bam_path: str,
        region: Range,
        ref_path: str = "",
        max_reads: int = 2000,
    ) -> "LongReadModel":
        from deepvariant_tpu_torch.io.bam import BamReader

        ref = None
        if ref_path:
            from deepvariant_tpu_torch.io.fasta import FastaReader

            fr = FastaReader(ref_path)
            ref = np.frombuffer(
                fr.query(Range(
                    region.reference_name, 0,
                    next(c.n_bases for c in fr.contigs
                         if c.name == region.reference_name),
                )).upper().encode(),
                np.uint8,
            )
            # Mask of positions inside-or-adjacent-to homopolymer runs
            # >= _HP_MIN_RUN (indel anchors sit one base left of runs).
            hp_mask = np.zeros(len(ref), bool)
            starts = homopolymer_runs(ref, _HP_MIN_RUN)
            change = np.flatnonzero(np.diff(ref)) + 1
            run_starts = np.concatenate([[0], change])
            run_ends = np.concatenate([change, [len(ref)]])
            by_start = dict(zip(run_starts.tolist(), run_ends.tolist()))
            for s in starts:
                e = by_start[int(s)]
                hp_mask[max(0, s - 1): e + 1] = True

        reads = BamReader(bam_path).query(region).to_reads()
        lengths: List[int] = []
        pool: List[np.ndarray] = []
        aligned_bases = 0
        region_bases = 0
        ins_events: List[int] = []
        del_events: List[int] = []
        hp_events = 0
        n_events = 0
        mismatches = 0
        quality_implied = 0.0
        for rd in reads[:max_reads]:
            if rd.secondary_alignment or rd.supplementary_alignment:
                continue
            q = np.frombuffer(bytes(rd.aligned_quality), np.uint8)
            if not len(q):
                continue
            lengths.append(len(rd.aligned_sequence))
            pool.append(q[::-1].copy() if rd.reverse_strand else q)
            seq = np.frombuffer(
                rd.aligned_sequence.encode(), np.uint8
            )
            rp = rd.position
            qp = 0
            for op, n in rd.cigar:
                if op == _OP_I and n <= _MAX_ERR_LEN:
                    ins_events.append(n)
                    n_events += 1
                    if ref is not None and hp_mask[min(rp, len(ref) - 1)]:
                        hp_events += 1
                elif op == _OP_D and n <= _MAX_ERR_LEN:
                    del_events.append(n)
                    n_events += 1
                    if ref is not None and hp_mask[min(rp, len(ref) - 1)]:
                        hp_events += 1
                if op in (1, 8, 9):
                    # Depth counts only the bases INSIDE the fitted
                    # region: long reads overhang a small window by a
                    # read length on each side, so counting whole
                    # reads inflated depth ~(1 + readlen/span)x —
                    # measured 2.1x on the 25 kb ONT template (sim
                    # pileups saturated at 95+ rows where real ones
                    # have ~60; the transferred model then called
                    # clean hom-alts het).
                    lo = max(rp, region.start)
                    hi = min(rp + n, region.end)
                    if hi > lo:
                        region_bases += hi - lo
                if op in (1, 8, 9) and ref is not None \
                        and rp + n <= len(ref):
                    r_slice = ref[rp: rp + n]
                    s_slice = seq[qp: qp + n]
                    ok = r_slice != ord("N")
                    mismatches += int(
                        np.count_nonzero((r_slice != s_slice) & ok)
                    )
                    quality_implied += float(np.sum(np.power(
                        10.0, -q[qp: qp + n][ok].astype(np.float64) / 10
                    )))
                if op in OPS_CONSUME_REF:
                    rp += n
                if op in OPS_CONSUME_READ:
                    qp += n
                if op in (1, 8, 9):
                    # Per-base rates normalize over ALIGNED bases
                    # (M/=/X) — soft-clips are neither aligned nor
                    # error opportunities.
                    aligned_bases += n
        if not aligned_bases:
            raise ValueError(f"no usable template reads in {bam_path}")
        hp_fraction = hp_events / n_events if (
            ref is not None and n_events
        ) else 0.6
        # Mean template depth over the fitted region, from the bases
        # that actually land INSIDE it (see region_bases above).
        span = region.end - region.start
        mean_depth = region_bases / span if span > 0 else 32.0
        # Mismatches include true het/hom variant sites (~0.0003/base
        # at human density) — subtract a human-variation allowance so
        # extra_sub_rate models machine/alignment artifacts only.
        observed = mismatches / aligned_bases if aligned_bases else 0.0
        implied = quality_implied / aligned_bases if aligned_bases else 0.0
        extra = max(0.0, observed - implied - 3.3e-4)
        return cls(
            lengths=np.asarray(lengths, np.int64),
            quality_pool=pool,
            ins_event_rate=len(ins_events) / aligned_bases,
            del_event_rate=len(del_events) / aligned_bases,
            ins_lengths=np.asarray(ins_events, np.int64),
            del_lengths=np.asarray(del_events, np.int64),
            hp_fraction=hp_fraction,
            mean_depth=mean_depth,
            extra_sub_rate=extra,
        )

    def draw_length(self, rng: np.random.Generator,
                    lo: int, hi: int) -> int:
        return int(np.clip(
            self.lengths[rng.integers(len(self.lengths))], lo, hi
        ))

    def draw_quality(self, rng: np.random.Generator, n: int) -> np.ndarray:
        parts: List[np.ndarray] = []
        have = 0
        while have < n:
            q = self.quality_pool[rng.integers(len(self.quality_pool))]
            parts.append(q)
            have += len(q)
        return np.concatenate(parts)[:n]

    def calibrate_hp_rate(self, ref: np.ndarray,
                          lo: int, hi: int) -> float:
        """r0 such that homopolymer-site slips reproduce the fitted
        homopolymer share of the per-base indel event rate over
        ref[lo:hi)."""
        target = (self.ins_event_rate + self.del_event_rate) \
            * self.hp_fraction
        window = ref[lo:hi]
        change = np.flatnonzero(np.diff(window)) + 1
        starts = np.concatenate([[0], change])
        ends = np.concatenate([change, [len(window)]])
        run_len = ends - starts
        run_len = run_len[run_len >= _HP_MIN_RUN]
        if not len(run_len):
            return 0.0
        unit = float(np.sum(
            np.power(run_len - 2.0, _HP_EXP)
        )) / (hi - lo)
        return target / unit if unit > 0 else 0.0


@dataclasses.dataclass
class _HpSites:
    """Homopolymer tracts of one haplotype with systematic slip rates."""

    starts: np.ndarray  # haplotype coordinates, sorted
    lens: np.ndarray
    rates: np.ndarray   # per-read slip probability at each tract


def _hp_sites(seq: np.ndarray, r0: float) -> _HpSites:
    change = np.flatnonzero(np.diff(seq)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(seq)]])
    lens = ends - starts
    keep = lens >= _HP_MIN_RUN
    starts, lens = starts[keep], lens[keep]
    rates = np.minimum(
        r0 * np.power(lens - 2.0, _HP_EXP), _HP_SITE_CAP
    )
    return _HpSites(starts.astype(np.int64), lens.astype(np.int64), rates)


def _apply_long_read_indels(
    rng: np.random.Generator,
    seq: np.ndarray,
    refpos: np.ndarray,
    frag_start: int,
    hp: _HpSites,
    model: LongReadModel,
    scale: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply systematic homopolymer slips + i.i.d. random indels."""
    edits: List[Tuple[int, int, int]] = []  # (pos_in_frag, +len | -len, unit)
    # Systematic homopolymer events: Bernoulli per covered tract.
    lo_i = int(np.searchsorted(hp.starts, frag_start + 2))
    hi_i = int(np.searchsorted(hp.starts, frag_start + len(seq) - 10))
    if hi_i > lo_i:
        draws = rng.random(hi_i - lo_i)
        for k in np.flatnonzero(draws < scale * hp.rates[lo_i:hi_i]):
            i = lo_i + int(k)
            at = int(hp.starts[i]) - frag_start + 1  # inside the run
            # Deletion-vs-insertion split follows the fitted event
            # rates; slip length 1 unit mostly, occasionally more.
            is_del = rng.random() < model.del_event_rate / (
                model.del_event_rate + model.ins_event_rate
            )
            n = min(1 + rng.geometric(0.75) - 1, 3)
            n = max(1, min(n, int(hp.lens[i]) - 1)) if is_del else max(1, n)
            edits.append((at, -n if is_del else n, 1))
    # Random (non-homopolymer-systematic) events.
    rand_rate = (model.ins_event_rate + model.del_event_rate) \
        * (1.0 - model.hp_fraction) * scale
    n_rand = rng.poisson(len(seq) * rand_rate)
    for _ in range(n_rand):
        at = int(rng.integers(2, max(3, len(seq) - _MAX_ERR_LEN - 2)))
        is_del = rng.random() < model.del_event_rate / (
            model.del_event_rate + model.ins_event_rate
        )
        pool = model.del_lengths if is_del else model.ins_lengths
        n = int(pool[rng.integers(len(pool))])
        edits.append((at, -n if is_del else n, 0))
    if not edits:
        return seq, refpos
    # Apply right-to-left so earlier coordinates stay valid.
    edits.sort(reverse=True)
    for at, signed_n, _unit in edits:
        n = abs(signed_n)
        if at < 1 or at + n >= len(seq) - 1:
            continue
        if signed_n < 0:  # deletion of n read bases
            keep = np.ones(len(seq), bool)
            keep[at: at + n] = False
            seq, refpos = seq[keep], refpos[keep]
        else:  # insertion duplicating the next n bases
            seq = np.insert(seq, at, seq[at: at + n])
            refpos = np.insert(refpos, at, np.full(n, -1, np.int64))
    return seq, refpos


def simulate_long_window_reads(
    rng: np.random.Generator,
    haps: Sequence[Tuple[np.ndarray, np.ndarray]],
    cfg: LongReadSimConfig,
    model: LongReadModel,
    hot_alt: Dict[int, Tuple[int, float, float]],
    name_prefix: str,
    window: Tuple[int, int],
    hp_r0: float,
) -> List[Read]:
    """Emit single-end long reads over one simulated window.

    `haps` = [(hap0_seq, hap0_refpos), (hap1...), (ref_seq, ref_refpos)]
    as in the Illumina path. Reads are clipped to the window (the
    window plays the role of a reference contig slice; make_examples
    consumes them with region restrictions exactly like real data).
    """
    lo, hi = window
    span = hi - lo
    if span < cfg.min_read_length:
        # Otherwise every candidate read is rejected by the
        # min_read_length clip and the loop never advances.
        raise ValueError(
            f"window {lo}-{hi} span {span} bp < min_read_length "
            f"{cfg.min_read_length}; widen the window or lower "
            "min_read_length"
        )
    reads: List[Read] = []
    hp_sites = [_hp_sites(seq, hp_r0) for seq, _ in haps]
    inv_maps = []
    for seq, refpos in haps:
        aligned = refpos >= 0
        inv_maps.append((refpos[aligned], np.flatnonzero(aligned)))
    hot_positions = (
        np.fromiter(hot_alt.keys(), np.int64, len(hot_alt))
        if hot_alt else np.zeros(0, np.int64)
    )
    coverage = cfg.coverage or model.mean_depth
    target_bases = int(span * coverage)
    emitted = 0
    idx = 0
    consecutive_rejects = 0
    while emitted < target_bases:
        if consecutive_rejects > 100_000:
            raise RuntimeError(
                f"window {lo}-{hi}: {consecutive_rejects} consecutive "
                "rejected read draws — degenerate window/config "
                "(emitted "
                f"{emitted}/{target_bases} bases before stalling)"
            )
        consecutive_rejects += 1
        L = model.draw_length(
            rng, cfg.min_read_length, min(cfg.max_read_length, span)
        )
        # Genomic start uniform over [lo - L + margin, hi - margin) so
        # coverage is flat across the interior; clip to the window.
        margin = min(200, L // 4)
        gstart = int(rng.integers(lo - L + margin, hi - margin))
        g0, g1 = max(lo, gstart), min(hi, gstart + L)
        if g1 - g0 < cfg.min_read_length:
            continue
        u = rng.random()
        hap = 2 if u < cfg.ref_contamination else int(rng.integers(2))
        hap_seq, hap_refpos = haps[hap]
        ref_keys, hap_at = inv_maps[hap]
        j0 = int(np.searchsorted(ref_keys, g0))
        j1 = int(np.searchsorted(ref_keys, g1))
        if j1 - j0 < cfg.min_read_length:
            continue
        start = int(hap_at[min(j0, len(hap_at) - 1)])
        stop = int(hap_at[min(j1, len(hap_at) - 1)]) if \
            j1 < len(hap_at) else len(hap_seq)
        seq = hap_seq[start:stop].copy()
        rp = hap_refpos[start:stop]
        seq, rp = _apply_long_read_indels(
            rng, seq, rp, start, hp_sites[hap], model,
            cfg.error_rate_scale,
        )
        forward = bool(rng.random() < 0.5)
        qual_seqdir = model.draw_quality(rng, len(seq))
        qual = qual_seqdir if forward else qual_seqdir[::-1]
        # Substitution hotspots (strand-biased systematic SNP noise).
        if len(hot_positions):
            m = np.isin(rp, hot_positions)
            for k in np.flatnonzero(m):
                alt_b, f_fwd, f_rev = hot_alt[int(rp[k])]
                if rng.random() < (f_fwd if forward else f_rev):
                    seq[k] = alt_b
        # Quality-driven substitutions PLUS the fitted
        # quality-decoupled artifact rate (real HiFi mismatches sit at
        # Q93; a speckle-free training background does not transfer).
        if cfg.error_rate_scale > 0:
            p_err = np.power(10.0, -qual.astype(np.float64) / 10) \
                + model.extra_sub_rate
            err = rng.random(len(seq)) < cfg.error_rate_scale * p_err
            for k in np.flatnonzero(err):
                choices = _BASES[_BASES != seq[k]]
                seq[k] = choices[rng.integers(len(choices))]
        aln = cigar_from_refpos(rp)
        if aln is None:
            continue
        pos, cigar = aln
        reads.append(Read(
            fragment_name=f"{name_prefix}:{idx}",
            aligned_sequence=bytes(seq).decode(),
            aligned_quality=bytes(qual),
            reference_name=cfg.contig,
            position=pos,
            mapping_quality=60,
            cigar=cigar,
            reverse_strand=not forward,
            read_number=0,
            number_reads=1,
        ))
        emitted += len(seq)
        idx += 1
        consecutive_rejects = 0
    return reads


def simulate_corpus_longread(
    cfg: LongReadSimConfig, outdir: str
) -> Dict[str, object]:
    """Simulate one long-read replicate: BAM (+.bai), truth VCF, BED."""
    from deepvariant_tpu_torch.io.bam_writer import BamWriter, build_bam_index
    from deepvariant_tpu_torch.io.fasta import FastaReader
    from deepvariant_tpu_torch.io.vcf import VcfHeader, VcfWriter

    require_template(cfg.template_bam)
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
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
    model = LongReadModel.from_bam(
        cfg.template_bam, Range(*cfg.template_region),
        ref_path=cfg.template_ref_path or cfg.ref_path,
    )
    truth_cfg = cfg.truth_config()

    all_variants = []
    all_reads: List[Read] = []
    for w_idx, (lo, hi) in enumerate(cfg.windows):
        variants = sample_variants(rng, ref, lo, hi, truth_cfg)
        hotspots = sample_hotspots(rng, ref, lo, hi, truth_cfg, variants)
        haps = [
            build_haplotype(ref, lo, hi, variants, hap) for hap in (0, 1)
        ]
        haps.append((
            ref[lo:hi].copy(), np.arange(lo, hi, dtype=np.int64)
        ))
        hp_r0 = model.calibrate_hp_rate(ref, lo, hi)
        # Depth augmentation: each window trains at a different depth
        # so the model reads allele FRACTIONS, not absolute row counts.
        j_lo, j_hi = cfg.depth_jitter
        w_cfg = dataclasses.replace(
            cfg,
            coverage=(cfg.coverage or model.mean_depth)
            * float(rng.uniform(j_lo, j_hi)),
        )
        reads = simulate_long_window_reads(
            rng, haps, w_cfg, model, hotspots,
            name_prefix=f"lsim{cfg.seed}w{w_idx}",
            window=(lo, hi), hp_r0=hp_r0,
        )
        all_variants.extend(variants)
        all_reads.extend(reads)

    all_reads.sort(key=lambda r: r.position)
    bam_path = os.path.join(outdir, "sim.bam")
    writer = BamWriter(
        bam_path, ref_reader.contigs, sample_name=cfg.sample_name
    )
    for rd in all_reads:
        writer.write_read(rd)
    writer.close()
    build_bam_index(bam_path)

    vcf_path = os.path.join(outdir, "truth.vcf.gz")
    header = VcfHeader(ref_reader.contigs, [cfg.sample_name])
    vcf_writer = VcfWriter(vcf_path, header)
    all_variants.sort(key=lambda v: v.pos)
    for v in all_variants:
        vcf_writer.write(Variant(
            reference_name=cfg.contig,
            start=v.pos,
            end=v.pos + len(v.ref),
            reference_bases=v.ref,
            alternate_bases=[v.alt],
            quality=50.0,
            filter=["PASS"],
            calls=[VariantCall(
                call_set_name=cfg.sample_name,
                genotype=list(v.genotype),
                is_phased=True,
            )],
        ))
    vcf_writer.close()

    bed_path = os.path.join(outdir, "confident.bed")
    with open(bed_path, "w") as f:
        for lo, hi in cfg.windows:
            f.write(f"{cfg.contig}\t{lo}\t{hi}\n")

    return {
        "bam": bam_path,
        "truth_vcf": vcf_path,
        "confident_bed": bed_path,
        "n_variants": len(all_variants),
        "n_reads": len(all_reads),
        "variants": all_variants,
        "model": model,
    }

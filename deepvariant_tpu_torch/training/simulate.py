"""Synthetic diploid read simulator for training-data scaling.

The port's copy of `deepvariant_tpu.training.simulate`: host numpy with
the same draws in the same order from one `np.random.default_rng(seed)`,
so that a corpus (BAM, .bai, truth VCF, BED) equals the JAX package's
byte for byte on the same template. One difference: there is no default
template. `SimConfig.template_bam` is empty unless the caller names a
BAM, and every corpus driver raises ValueError without one
(`require_template`).

The reference trains its production models on GIAB-scale truth sets
(docs/deepvariant-training-case-study.md) that are not at hand. This
module scales a small corpus instead: it samples a
diploid genome (phased SNVs + indels) into the real chr20 reference
windows, emits Illumina-like paired reads whose error process is
fitted to the real NA12878 run (resampled per-cycle quality strings,
quality-driven substitution errors, systematic error hotspots,
homopolymer slips), and writes a coordinate-sorted BAM + truth VCF +
confident BED. The output feeds the *existing* labeled-example path
(`make_examples --mode training`), so every downstream byte — pileup
channels, labels, tf.Example schema — is produced by the same code
that handles real data.

Design notes (all host-side numpy; this is stage-0 data synthesis, not
a kernel):
  * Each haplotype is materialized as a byte array plus a parallel
    `refpos` int64 array (-1 marks inserted bases). Fragments are
    slices of those arrays; CIGAR/POS for any read fall out of a
    single run-length scan of its refpos slice, so reads are emitted
    pre-aligned with exact alignments — no aligner in the loop.
  * Error realism drives label balance: quality-resampled substitution
    errors and Beta-fraction hotspots create hom-ref (class 0) SNP
    candidates, homopolymer slips create hom-ref indel candidates —
    the classes a clean simulator would starve.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import (
    ContigInfo,
    Range,
    Read,
    Variant,
    VariantCall,
)

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b

# proto CigarUnit ops (nucleus cigar.proto)
_OP_M, _OP_I, _OP_D, _OP_S = 1, 2, 3, 5


@dataclasses.dataclass
class SimConfig:
    """Knobs for one simulated replicate."""

    ref_path: str
    contig: str
    # Half-open [start, end) windows to simulate over (0-based).
    windows: Sequence[Tuple[int, int]]
    seed: int = 0
    coverage: float = 32.0
    # Template run the error model is fitted to: quality-string pools,
    # read length, and fragment-size stats all come from these reads.
    # Required: the drivers raise ValueError while it is empty.
    template_bam: str = ""
    template_region: Tuple[str, int, int] = (
        "chr20", 10_000_000, 10_080_000
    )
    read_length: int = 101
    fragment_mean: float = 320.0
    fragment_std: float = 72.0
    # Variant process.
    snv_rate: float = 1.0 / 250.0
    indel_rate: float = 1.0 / 2200.0
    max_indel_len: int = 12
    het_fraction: float = 0.67
    # Systematic sequencing-error hotspots (hom-ref SNP candidates).
    # Rates calibrated so the labeled-example distribution matches the
    # real NA12878 run through the same make_examples path (measured on
    # chr20:10.00-10.04M: 30% class-0 examples, 33% indel examples of
    # which ~60% are class-0 homopolymer noise).
    hotspot_rate: float = 1.0 / 900.0
    hotspot_min_frac: float = 0.05
    hotspot_max_frac: float = 0.30
    # Homopolymer slip model: a fraction of runs are "slippery" with a
    # site-specific per-read slip rate (PCR/polymerase slippage recurs
    # at the same run across reads — that recurrence is what creates
    # candidate-threshold-passing hom-ref indel pileups).
    slip_site_fraction: float = 0.30
    slip_rate_min: float = 0.02
    slip_rate_max: float = 0.18
    min_homopolymer: int = 5
    # Scales quality-driven substitution error probabilities (0 turns
    # sequencing errors off — used by reconstruction tests).
    error_rate_scale: float = 1.0
    # Allele-sampling bias: het alt fractions Beta-skewed below 0.5
    # (alignment reference bias) and hom-alt sites contaminated with a
    # few ref-carrying reads. Reconstruction tests turn this off.
    allele_sampling_bias: bool = True
    # Fraction of indels re-anchored into repeat tracts (homopolymers /
    # dinucleotide tandems) with tandem-duplication insertion content —
    # where real indels live.
    indel_repeat_fraction: float = 0.7
    sample_name: str = "SIM"


@dataclasses.dataclass
class SimVariant:
    pos: int  # 0-based ref position of the VCF record (anchor for indels)
    ref: str
    alt: str
    genotype: Tuple[int, int]  # phased (hap0 allele, hap1 allele)
    # Probability a fragment covering this site is drawn from a
    # REF-carrying source (mapping bias / contamination model):
    # het sites get 1 - Beta-skewed alt fraction, hom-alt sites get a
    # small contamination rate — real hom pileups are rarely pure, and
    # a model trained on pure ones systematically under-calls hom-alt
    # as het (measured on the NA12878 eval: every wrong-GT call was
    # hom->het before this knob existed).
    p_ref_draw: float = 0.5
    # When a fragment covers several variants, the one with the
    # highest priority governs its haplotype sourcing (ties: first).
    # Somatic variants set 1 so their sub-0.5 VAFs are not dragged
    # toward 0.5 by neighboring germline hets.
    source_priority: int = 0


class QualityModel:
    """Per-mate pools of real quality strings, in sequencing orientation.

    Resampling whole quality strings from the real run preserves the
    per-cycle decay, the low-quality tails, and the bursty q<=3 runs
    that drive realistic error placement — the parts a parametric
    model would smooth away.
    """

    def __init__(self, r1: np.ndarray, r2: np.ndarray, read_length: int):
        if len(r1) == 0 or len(r2) == 0:
            raise ValueError("quality pools must be non-empty")
        self.r1 = r1  # (n1, L) uint8 phred
        self.r2 = r2  # (n2, L) uint8 phred
        self.read_length = read_length
        self.fragment_mean = 320.0
        self.fragment_std = 72.0

    @classmethod
    def from_bam(
        cls,
        bam_path: str,
        region: Range,
        max_reads: int = 50_000,
    ) -> "QualityModel":
        from deepvariant_tpu_torch.io.bam import BamReader

        reader = BamReader(bam_path)
        batch = reader.query(region)
        reads = batch.to_reads()
        pools: Dict[int, List[np.ndarray]] = {0: [], 1: []}
        length = 0
        tlens: List[int] = []
        for rd in reads[:max_reads]:
            q = np.frombuffer(bytes(rd.aligned_quality), np.uint8)
            if length == 0:
                length = len(q)
            if len(q) != length:
                continue
            if rd.reverse_strand:
                q = q[::-1]  # back to sequencing orientation
            pools[rd.read_number % 2].append(q)
            if 0 < abs(rd.fragment_length) < 2000:
                tlens.append(abs(rd.fragment_length))
        if not pools[0] or not pools[1]:
            raise ValueError(f"no paired reads found in {bam_path}")
        model = cls(np.stack(pools[0]), np.stack(pools[1]), length)
        model.fragment_mean = float(np.mean(tlens)) if tlens else 320.0
        model.fragment_std = float(np.std(tlens)) if tlens else 72.0
        return model

    def draw(self, rng: np.random.Generator, mate: int) -> np.ndarray:
        pool = self.r1 if mate == 0 else self.r2
        return pool[rng.integers(len(pool))]


def require_template(template_bam: str) -> None:
    """Raise ValueError unless a template BAM is named: the error model
    is fitted to one and there is no default."""
    if not template_bam:
        raise ValueError(
            "template_bam is empty: name the BAM whose reads the error "
            "model is fitted to")


# ---------------------------------------------------------------------------
# Variant sampling and haplotype construction
# ---------------------------------------------------------------------------

def sample_variants(
    rng: np.random.Generator,
    ref: np.ndarray,
    lo: int,
    hi: int,
    cfg: SimConfig,
) -> List[SimVariant]:
    """Sample non-overlapping phased variants over ref[lo:hi).

    `ref` is the full-contig uint8 array; positions are contig
    coordinates. Variants keep a guard gap so their REF intervals
    never touch (overlapping truth would need haplotype-aware VCF
    normalization the labeler then has to undo — real truth sets are
    normalized the same way).
    """
    span = hi - lo
    n_snv = rng.poisson(span * cfg.snv_rate)
    n_indel = rng.poisson(span * cfg.indel_rate)
    repeat_anchors = _repeat_anchor_positions(ref, lo + 1, hi - 40)
    # Candidate positions, then greedy non-overlap selection.
    proposals: List[Tuple[int, int]] = []  # (pos, kind) kind 0=snv 1=ins 2=del
    for pos in rng.integers(lo + 1, hi - cfg.max_indel_len - 2, n_snv):
        proposals.append((int(pos), 0))
    for pos in rng.integers(lo + 1, hi - cfg.max_indel_len - 2, n_indel):
        kind = 1 + int(rng.integers(2))
        if len(repeat_anchors) and \
                rng.random() < cfg.indel_repeat_fraction:
            pos = int(repeat_anchors[rng.integers(len(repeat_anchors))])
        proposals.append((int(pos), kind))
    proposals.sort()
    variants: List[SimVariant] = []
    last_end = -(10 ** 9)
    guard = 2
    for pos, kind in proposals:
        if ref[pos] not in _BASES or ref[pos - 1] not in _BASES:
            continue
        if kind == 0:
            ref_allele = chr(ref[pos])
            alt = chr(rng.choice([b for b in _BASES if b != ref[pos]]))
            ref_end = pos + 1
        elif kind == 1:  # insertion after anchor at pos
            length = min(1 + rng.geometric(0.40), cfg.max_indel_len)
            dup = ref[pos + 1: pos + 1 + length]
            if len(dup) == length and all(b in _BASES for b in dup):
                # Tandem duplication of the adjacent sequence — the
                # dominant real insertion mechanism.
                ins = bytes(dup).decode()
            else:
                ins = bytes(rng.choice(_BASES, length)).decode()
            ref_allele = chr(ref[pos])
            alt = ref_allele + ins
            ref_end = pos + 1
        else:  # deletion of `length` bases after anchor at pos
            length = min(1 + rng.geometric(0.40), cfg.max_indel_len)
            if pos + 1 + length >= hi:
                continue
            deleted = ref[pos: pos + 1 + length]
            if not all(b in _BASES for b in deleted):
                continue
            ref_allele = bytes(deleted).decode()
            alt = ref_allele[0]
            ref_end = pos + 1 + length
        if pos < last_end + guard:
            continue
        if rng.random() < cfg.het_fraction:
            gt = (0, 1) if rng.random() < 0.5 else (1, 0)
            # Alignment reference bias: alt fraction centered slightly
            # below 0.5 with realistic spread.
            p_ref = 1.0 - float(rng.beta(30.0, 32.0))
        else:
            gt = (1, 1)
            # Hom-alt contamination: most sites pure, a minority carry
            # a few percent ref-supporting reads.
            p_ref = float(rng.uniform(0.01, 0.10)) \
                if rng.random() < 0.4 else 0.0
        if not cfg.allele_sampling_bias:
            p_ref = 0.5 if gt != (1, 1) else 0.0
        variants.append(SimVariant(pos, ref_allele, alt, gt, p_ref))
        last_end = ref_end
    return variants


def _repeat_anchor_positions(
    ref: np.ndarray, lo: int, hi: int
) -> np.ndarray:
    """Anchor positions (base BEFORE the tract) of homopolymer runs
    (>=4) and dinucleotide tandems (>=3 units) in ref[lo:hi)."""
    window = ref[lo:hi]
    anchors = []
    runs = homopolymer_runs(window, 4)
    anchors.extend(int(s) + lo - 1 for s in runs if s > 0)
    # Dinucleotide tandems: i where ref[i:i+2] repeats >= 3 times
    # (w[i]==w[i+2]==w[i+4], w[i+1]==w[i+3]==w[i+5], not a homopolymer).
    w = window
    if len(w) >= 6:
        m = (
            (w[:-5] == w[2:-3]) & (w[2:-3] == w[4:-1])
            & (w[1:-4] == w[3:-2]) & (w[3:-2] == w[5:])
            & (w[:-5] != w[1:-4])
        )
        starts = np.flatnonzero(m)
        # Keep only tandem STARTS (previous position not in a tandem).
        keep = np.concatenate([[True], np.diff(starts) > 1]) \
            if len(starts) else np.zeros(0, bool)
        anchors.extend(int(s) + lo - 1 for s in starts[keep] if s > 0)
    out = np.unique(np.asarray(sorted(anchors), np.int64))
    return out[(out >= lo) & (out < hi)]


def build_haplotype(
    ref: np.ndarray,
    lo: int,
    hi: int,
    variants: Sequence[SimVariant],
    hap: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply this haplotype's alleles to ref[lo:hi).

    Returns (seq uint8, refpos int64) where refpos holds the contig
    coordinate each haplotype base aligns to, or -1 for inserted bases.
    """
    seq_parts: List[np.ndarray] = []
    pos_parts: List[np.ndarray] = []
    cursor = lo
    for v in variants:
        if v.genotype[hap] == 0:
            continue
        seq_parts.append(ref[cursor: v.pos])
        pos_parts.append(np.arange(cursor, v.pos, dtype=np.int64))
        ref_len, alt_len = len(v.ref), len(v.alt)
        alt = np.frombuffer(v.alt.encode(), np.uint8)
        if ref_len == 1 and alt_len == 1:  # SNV
            seq_parts.append(alt)
            pos_parts.append(np.array([v.pos], np.int64))
        elif alt_len > ref_len:  # insertion: anchor M then inserted bases
            seq_parts.append(alt)
            pos_parts.append(np.concatenate([
                np.array([v.pos], np.int64),
                np.full(alt_len - 1, -1, np.int64),
            ]))
        else:  # deletion: anchor only
            seq_parts.append(alt[:1])
            pos_parts.append(np.array([v.pos], np.int64))
        cursor = v.pos + ref_len
    seq_parts.append(ref[cursor:hi])
    pos_parts.append(np.arange(cursor, hi, dtype=np.int64))
    return np.concatenate(seq_parts), np.concatenate(pos_parts)


def homopolymer_runs(
    seq: np.ndarray, min_len: int
) -> np.ndarray:
    """Start indices (into seq) of homopolymer runs >= min_len."""
    if len(seq) == 0:
        return np.zeros(0, np.int64)
    change = np.flatnonzero(np.diff(seq)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(seq)]])
    keep = (ends - starts) >= min_len
    return starts[keep]


# ---------------------------------------------------------------------------
# Read emission
# ---------------------------------------------------------------------------

def cigar_from_refpos(
    refpos: np.ndarray,
) -> Optional[Tuple[int, List[Tuple[int, int]]]]:
    """Alignment (POS, cigar) implied by a read's refpos slice.

    Interior insertion runs become I, reference jumps become D, edge
    insertion runs become soft clips (a BAM alignment cannot start or
    end with I). Returns None if no base aligns to the reference.
    """
    n = len(refpos)
    aligned = refpos >= 0
    if not aligned.any():
        return None
    first = int(np.argmax(aligned))
    last = n - 1 - int(np.argmax(aligned[::-1]))
    cigar: List[Tuple[int, int]] = []
    if first > 0:
        cigar.append((_OP_S, first))
    pos = int(refpos[first])
    i = first
    expect = pos
    m_run = 0
    while i <= last:
        rp = refpos[i]
        if rp < 0:  # insertion run
            if m_run:
                cigar.append((_OP_M, m_run))
                m_run = 0
            j = i
            while j <= last and refpos[j] < 0:
                j += 1
            cigar.append((_OP_I, j - i))
            i = j
            continue
        if rp != expect:  # deletion (reference jump)
            if m_run:
                cigar.append((_OP_M, m_run))
                m_run = 0
            cigar.append((_OP_D, int(rp - expect)))
            expect = int(rp)
        m_run += 1
        expect += 1
        i += 1
    if m_run:
        cigar.append((_OP_M, m_run))
    if last < n - 1:
        cigar.append((_OP_S, n - 1 - last))
    return pos, cigar


@dataclasses.dataclass
class SlipSites:
    """Per-haplotype slippery repeat tracts with site-specific rates.

    `starts` are haplotype coordinates of tract starts; `p_del`/`p_ins`
    the per-read slip probabilities (0 for quiet tracts); `unit` the
    repeat period (1 = homopolymer, 2 = dinucleotide tandem) — a slip
    removes or duplicates one full unit. Rates are keyed by the tract's
    reference anchor so both haplotypes share the same slip behavior
    at the same locus.
    """

    starts: np.ndarray  # (n,) int64, sorted, haplotype coordinates
    p_del: np.ndarray  # (n,) float64
    p_ins: np.ndarray  # (n,) float64
    unit: np.ndarray  # (n,) int64, repeat period (1 or 2)


def _dinucleotide_tandem_starts(seq: np.ndarray) -> np.ndarray:
    """Start indices of >=3-unit dinucleotide tandems in seq."""
    if len(seq) < 6:
        return np.zeros(0, np.int64)
    w = seq
    m = (
        (w[:-5] == w[2:-3]) & (w[2:-3] == w[4:-1])
        & (w[1:-4] == w[3:-2]) & (w[3:-2] == w[5:])
        & (w[:-5] != w[1:-4])
    )
    starts = np.flatnonzero(m)
    if not len(starts):
        return np.zeros(0, np.int64)
    keep = np.concatenate([[True], np.diff(starts) > 1])
    return starts[keep].astype(np.int64)


def build_slip_sites(
    rng: np.random.Generator,
    haps: Sequence[Tuple[np.ndarray, np.ndarray]],
    cfg: SimConfig,
    shared_rates: Dict[int, Tuple[float, float]],
) -> List[SlipSites]:
    """Assign slip rates to repeat tracts on each haplotype."""
    out = []
    for seq, refpos in haps:
        hp_starts = homopolymer_runs(seq, cfg.min_homopolymer)
        di_starts = _dinucleotide_tandem_starts(seq)
        starts = np.concatenate([hp_starts, di_starts]).astype(np.int64)
        unit = np.concatenate([
            np.ones(len(hp_starts), np.int64),
            np.full(len(di_starts), 2, np.int64),
        ])
        order = np.argsort(starts, kind="stable")
        starts, unit = starts[order], unit[order]
        p_del = np.zeros(len(starts))
        p_ins = np.zeros(len(starts))
        for i, s in enumerate(starts):
            anchor = int(refpos[s]) if refpos[s] >= 0 else -int(s)
            anchor = anchor * 4 + int(unit[i])  # separate keys per period
            if anchor not in shared_rates:
                if rng.random() < cfg.slip_site_fraction:
                    rate = rng.uniform(cfg.slip_rate_min, cfg.slip_rate_max)
                    # Deletion slips dominate in Illumina repeat
                    # errors; keep a minority insertion component.
                    shared_rates[anchor] = (0.7 * rate, 0.3 * rate)
                else:
                    shared_rates[anchor] = (0.0, 0.0)
            p_del[i], p_ins[i] = shared_rates[anchor]
        out.append(SlipSites(starts, p_del, p_ins, unit))
    return out


def _apply_slips(
    rng: np.random.Generator,
    seq: np.ndarray,
    refpos: np.ndarray,
    frag_start: int,
    slip_sites: SlipSites,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply site-rate homopolymer slips to a fragment (at most 2)."""
    if not len(slip_sites.starts):
        return seq, refpos
    lo = np.searchsorted(slip_sites.starts, frag_start + 5)
    hi = np.searchsorted(slip_sites.starts, frag_start + len(seq) - 6)
    applied = 0
    # Walk candidate tracts; indices shift by +-unit per applied slip,
    # tracked via `shift`.
    shift = 0
    for i in range(lo, hi):
        if applied >= 2:
            break
        unit = int(slip_sites.unit[i])
        at = int(slip_sites.starts[i]) - frag_start + shift
        if at < 1 or at >= len(seq) - unit - 1:
            continue
        u = rng.random()
        if u < slip_sites.p_del[i]:
            keep = np.ones(len(seq), bool)
            keep[at: at + unit] = False
            seq, refpos = seq[keep], refpos[keep]
            shift -= unit
            applied += 1
        elif u < slip_sites.p_del[i] + slip_sites.p_ins[i]:
            seq = np.insert(seq, at, seq[at: at + unit])
            refpos = np.insert(refpos, at, np.full(unit, -1, np.int64))
            shift += unit
            applied += 1
    return seq, refpos


def simulate_window_reads(
    rng: np.random.Generator,
    haps: Sequence[Tuple[np.ndarray, np.ndarray]],
    cfg: SimConfig,
    qual_model: QualityModel,
    contig: str,
    hot_alt: Dict[int, Tuple[int, float, float]],
    name_prefix: str,
    variants: Sequence[SimVariant] = (),
    window: Optional[Tuple[int, int]] = None,
    slip_shared_rates: Optional[Dict[int, Tuple[float, float]]] = None,
) -> List[Read]:
    """Emit paired reads over one simulated window.

    Fragments are placed in REFERENCE coordinates first, then sourced
    from hap0 / hap1 / the pure-reference sequence according to the
    first covered variant's `p_ref_draw` — that is how het skew and
    hom-alt contamination become per-SITE read fractions. `haps` is
    [(hap0_seq, hap0_refpos), (hap1...), (ref_seq, ref_refpos)].

    Slips apply at the fragment level: a library-prep slip is a
    property of the molecule, so both mates of a pair share it.
    """
    L = cfg.read_length
    reads: List[Read] = []
    if window is None:
        window = (int(haps[-1][1][0]), int(haps[-1][1][-1]) + 1)
    ref_lo, ref_hi = window
    span = ref_hi - ref_lo
    n_fragments = int(span * cfg.coverage / (2 * L))
    min_frag = L + 4
    hot_positions = (
        np.fromiter(hot_alt.keys(), np.int64, len(hot_alt))
        if hot_alt else np.zeros(0, np.int64)
    )
    # Slip rates key on the tract's REFERENCE anchor, so passing one
    # dict across related samples (trio members, tumor/normal) makes
    # the same locus slip at the same rate in every sample — the
    # polymerase behaves per-locus, not per-library.
    slip_sites = build_slip_sites(
        rng, haps, cfg,
        slip_shared_rates if slip_shared_rates is not None else {},
    )
    # ref coordinate -> haplotype coordinate maps (aligned bases only).
    inv_maps = []
    for seq, refpos in haps:
        aligned = refpos >= 0
        inv_maps.append((refpos[aligned], np.flatnonzero(aligned)))
    var_pos = np.array([v.pos for v in variants], np.int64)
    var_p_ref = np.array([v.p_ref_draw for v in variants])
    var_alt_hap = np.array([
        -1 if v.genotype == (1, 1) else v.genotype.index(1)
        for v in variants
    ], np.int64)
    var_priority = np.array(
        [v.source_priority for v in variants], np.int64
    )
    for frag_idx in range(n_fragments):
        frag_len = int(np.clip(
            rng.normal(cfg.fragment_mean, cfg.fragment_std), min_frag, 800
        ))
        if span <= frag_len:
            continue
        ref_start = ref_lo + int(rng.integers(span - frag_len))
        # Source haplotype from the governing covered variant's draw
        # rule: the highest-priority covered variant, first on ties.
        i0 = int(np.searchsorted(var_pos, ref_start + 3))
        if i0 < len(var_pos) and var_pos[i0] < ref_start + frag_len - 3:
            i_sel = i0
            i1 = int(np.searchsorted(
                var_pos, ref_start + frag_len - 3
            ))
            if i1 > i0 + 1:
                seg = var_priority[i0:i1]
                if seg.max() > seg[0]:
                    i_sel = i0 + int(np.argmax(seg))
            p_ref = float(var_p_ref[i_sel])
            alt_hap = int(var_alt_hap[i_sel])
            u = rng.random()
            if alt_hap < 0:  # hom-alt: contamination -> pure ref source
                hap = 2 if u < p_ref else int(rng.integers(2))
            else:  # het: ref draw -> the non-alt haplotype
                hap = (1 - alt_hap) if u < p_ref else alt_hap
        else:
            hap = int(rng.integers(2))
        hap_seq, hap_refpos = haps[hap]
        ref_keys, hap_at = inv_maps[hap]
        j = int(np.searchsorted(ref_keys, ref_start))
        start = int(hap_at[min(j, len(hap_at) - 1)])
        start = min(start, len(hap_seq) - frag_len)
        if start < 0:
            continue
        fseq = hap_seq[start: start + frag_len].copy()
        fpos = hap_refpos[start: start + frag_len]
        fseq, fpos = _apply_slips(rng, fseq, fpos, start, slip_sites[hap])
        # R1/R2 randomly assigned to the forward/reverse physical read.
        r1_forward = bool(rng.random() < 0.5)
        mates = []
        for mate in (0, 1):
            forward = r1_forward if mate == 0 else not r1_forward
            if forward:
                seq = fseq[:L].copy()
                rp = fpos[:L]
            else:
                seq = fseq[-L:].copy()
                rp = fpos[-L:]
            qual_seqdir = qual_model.draw(rng, mate)
            # BAM stores SEQ/QUAL in reference orientation.
            qual = qual_seqdir if forward else qual_seqdir[::-1]
            # Hotspot systematic errors (strand-biased).
            if len(hot_positions):
                m = np.isin(rp, hot_positions)
                for k in np.flatnonzero(m):
                    alt_b, f_fwd, f_rev = hot_alt[int(rp[k])]
                    if rng.random() < (f_fwd if forward else f_rev):
                        seq[k] = alt_b
            # Quality-driven substitution errors.
            if cfg.error_rate_scale > 0:
                err = rng.random(L) < cfg.error_rate_scale * np.power(
                    10.0, -qual.astype(np.float64) / 10
                )
                for k in np.flatnonzero(err):
                    choices = _BASES[_BASES != seq[k]]
                    seq[k] = choices[rng.integers(len(choices))]
            aln = cigar_from_refpos(rp)
            if aln is None:
                mates = []
                break
            pos, cigar = aln
            ref_span = sum(n for op, n in cigar if op in (_OP_M, _OP_D))
            mates.append((mate, forward, seq, qual, pos, cigar, ref_span))
        if len(mates) != 2:
            continue
        name = f"{name_prefix}:{frag_idx}"
        left = min(m[4] for m in mates)
        right = max(m[4] + m[6] for m in mates)
        tlen = right - left
        for (mate, forward, seq, qual, pos, cigar, ref_span) in mates:
            other = mates[1 - mate]
            reads.append(Read(
                fragment_name=name,
                aligned_sequence=bytes(seq).decode(),
                aligned_quality=bytes(qual),
                reference_name=contig,
                position=pos,
                mapping_quality=60,
                cigar=cigar,
                reverse_strand=not forward,
                read_number=mate,
                number_reads=2,
                fragment_length=tlen if pos == left else -tlen,
                proper_placement=True,
                next_mate_position=(contig, other[4], not other[1]),
            ))
    return reads


# ---------------------------------------------------------------------------
# Corpus driver
# ---------------------------------------------------------------------------

def sample_hotspots(
    rng: np.random.Generator,
    ref: np.ndarray,
    lo: int,
    hi: int,
    cfg: SimConfig,
    taken: Sequence[SimVariant],
) -> Dict[int, Tuple[int, float, float]]:
    """Systematic-error sites: pos -> (alt, frac_forward, frac_reverse).

    Real sequencing/alignment artifacts are strand-biased and often
    CLUSTERED (several artifact sites within tens of bp) — both are
    signatures a classifier can learn to reject, so the simulator must
    produce them: each hotspot draws a strand bias, and a minority
    spawn 1-3 satellites within +-15 bp sharing that bias.
    """
    occupied = set()
    for v in taken:
        occupied.update(range(v.pos - 1, v.pos + len(v.ref) + 1))
    n = rng.poisson((hi - lo) * cfg.hotspot_rate)
    out: Dict[int, Tuple[int, float, float]] = {}

    def add(pos: int, frac: float, bias: float):
        if pos in occupied or not (lo <= pos < hi) or \
                ref[pos] not in _BASES or pos in out:
            return
        alt = int(rng.choice([b for b in _BASES if b != ref[pos]]))
        # bias in [0.5, 1): share of the error rate on the forward
        # strand; total per-read rate across both strands stays `frac`.
        f_fwd = min(2.0 * frac * bias, 0.6)
        f_rev = min(2.0 * frac * (1.0 - bias), 0.6)
        out[pos] = (alt, f_fwd, f_rev)

    for pos in rng.integers(lo, hi, n):
        frac = float(rng.uniform(cfg.hotspot_min_frac,
                                 cfg.hotspot_max_frac))
        bias = float(rng.uniform(0.5, 0.95))
        add(int(pos), frac, bias)
        if rng.random() < 0.15:  # artifact cluster
            for _ in range(int(rng.integers(1, 4))):
                off = int(rng.integers(-15, 16))
                add(int(pos) + off, frac * rng.uniform(0.6, 1.3), bias)
    return out


def simulate_corpus(cfg: SimConfig, outdir: str) -> Dict[str, object]:
    """Simulate one replicate: BAM (+.bai), truth VCF (+sorted), BED.

    Returns paths plus the sampled truth for test assertions.
    """
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

    qual_model = QualityModel.from_bam(
        cfg.template_bam, Range(*cfg.template_region)
    )
    cfg = dataclasses.replace(
        cfg,
        read_length=qual_model.read_length,
        fragment_mean=qual_model.fragment_mean,
        fragment_std=qual_model.fragment_std,
    )

    all_variants: List[SimVariant] = []
    all_reads: List[Read] = []
    for w_idx, (lo, hi) in enumerate(cfg.windows):
        variants = sample_variants(rng, ref, lo, hi, cfg)
        hotspots = sample_hotspots(rng, ref, lo, hi, cfg, variants)
        haps = [
            build_haplotype(ref, lo, hi, variants, hap) for hap in (0, 1)
        ]
        # Third source: the pure reference (hom-alt contamination
        # fragments and a slip-site substrate).
        haps.append((
            ref[lo:hi].copy(), np.arange(lo, hi, dtype=np.int64)
        ))
        reads = simulate_window_reads(
            rng, haps, cfg, qual_model, cfg.contig, hotspots,
            name_prefix=f"sim{cfg.seed}w{w_idx}",
            variants=variants, window=(lo, hi),
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
    }

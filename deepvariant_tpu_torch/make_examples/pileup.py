"""Pileup image encoding: candidate -> (H, W, C) uint8 tensor.

The port's copy of `deepvariant_tpu.make_examples.pileup`, the host
encoder (the reference's pileup_image_native.cc BuildPileupForOneSample
:296-447, EncodeRead :476, the channel fills of deepvariant/channels/*.cc
and the CIGAR walk of pileup_channel_lib.cc CalculateBaseLevelData
:170-260), in numpy and Python over the columnar ReadBatch: the options
and channel constants, `build_pileup` and its per-read painter
`encode_read_row` for every channel, the aux-driven ones included
(methylation and 6mA from MM/ML, the homopolymer and inter-homopolymer
quality channels from Ultima's tp/t0), and the helpers the device
planners (`pileup_device`) share with it. Each read
is painted by `encode_read_row`, the JAX package's per-row branch; its
dispatch to the native batch painter (`native.encode_rows`) is not
copied. The aux-driven channels are not in the plan form's channel set
(`pileup_device.DEVICE_CHANNELS`), as in the JAX package, so a channel
list that holds one is painted here.

Numerics contract (channels/channel.h:78 kMaxPixelValueAsFloat = 254):
- read_base: A=40+70*3=250, G=40+70*2=180, T=30+70*1=100, C=30+70*0=30, else 0
- base_quality: int(254 * min(q, 40)/40); ref rows use q=60 -> 254
- mapping_quality: int(254 * min(mq, 60)/60); ref rows 254
- strand: forward 70, reverse 240; ref rows 70
- read_supports_variant: 254*alpha, alpha = 1.0 supports alt-in-image,
  0.6 other-alt, 0.6 non-supporting; ref rows 0.6
- base_differs_from_ref: match 0.2*254=50, mismatch 254; ref rows 50
- insert_size: int(254 * min(|tlen|, 1000)/1000); ref rows 254
- haplotype_tag: int(254 * hp/2), hp in {0,1,2}; ref rows 0
CIGAR walk: M/=/X per-base; I single overwrite at anchor col (ref_i-1,
only if ref_i > 0) with read_base '*'; D/N single overwrite at anchor
(first-deleted-base - 1, only if read_i > 0) with read_base '*'; S, H
and P paint nothing.
A read is dropped when mapq < min_mapping_quality or when any event
lands on the variant start with base quality < min_base_quality.
Rows: the reference band, then reads stable-sorted by (hap_index,
allele_support_group, position, fragment_name, read_number); a crowded
window is shuffled (libc++ std::shuffle over mt19937_64(random_seed),
`shuffle.shuffle_indices`) and cut.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.io.bam import (
    FLAG_FIRST,
    FLAG_PAIRED,
    FLAG_REVERSE,
    ReadBatch,
)
from deepvariant_tpu_torch.make_examples.shuffle import shuffle_indices
from deepvariant_tpu_torch.make_examples.variant_caller import DeepVariantCall

MAX_PIXEL_FLOAT = 254.0

# Channel enum values (deepvariant.proto:1287-1342).
CH_READ_BASE = 1
CH_BASE_QUALITY = 2
CH_MAPPING_QUALITY = 3
CH_STRAND = 4
CH_READ_SUPPORTS_VARIANT = 5
CH_BASE_DIFFERS_FROM_REF = 6
CH_HAPLOTYPE_TAG = 7
CH_ALLELE_FREQUENCY = 8
# "Opt Channels" (deepvariant.proto:1321-1335).
CH_READ_MAPPING_PERCENT = 11
CH_AVG_BASE_QUALITY = 12
CH_IDENTITY = 13
CH_GAP_COMPRESSED_IDENTITY = 14
CH_GC_CONTENT = 15
CH_IS_HOMOPOLYMER = 16
CH_HOMOPOLYMER_WEIGHTED = 17
CH_BLANK = 18
CH_INSERT_SIZE = 19
CH_MEAN_COVERAGE = 22
CH_BASE_METHYLATION = 23
CH_BASE_6MA = 24
CH_READ_SUPPORTS_VARIANT_FUZZY = 25
CH_SUPPLEMENTARY_ALIGNMENT = 26
CH_ALLELE_SAMPLE_PROBABILITY = 27
CH_HOMOPOLYMER_INSERTION_QUALITY = 28
CH_HOMOPOLYMER_DELETION_QUALITY = 29
CH_INTER_HOMOPOLYMER_INSERTION_QUALITY = 30

CHANNEL_NAME_TO_ENUM = {
    "read_base": CH_READ_BASE,
    "base_quality": CH_BASE_QUALITY,
    "mapping_quality": CH_MAPPING_QUALITY,
    "strand": CH_STRAND,
    "read_supports_variant": CH_READ_SUPPORTS_VARIANT,
    "base_differs_from_ref": CH_BASE_DIFFERS_FROM_REF,
    "haplotype": CH_HAPLOTYPE_TAG,
    "allele_frequency": CH_ALLELE_FREQUENCY,
    "insert_size": CH_INSERT_SIZE,
    "blank": CH_BLANK,
    "read_mapping_percent": CH_READ_MAPPING_PERCENT,
    "avg_base_quality": CH_AVG_BASE_QUALITY,
    "identity": CH_IDENTITY,
    "gap_compressed_identity": CH_GAP_COMPRESSED_IDENTITY,
    "gc_content": CH_GC_CONTENT,
    "is_homopolymer": CH_IS_HOMOPOLYMER,
    "homopolymer_weighted": CH_HOMOPOLYMER_WEIGHTED,
    "supplementary_alignment": CH_SUPPLEMENTARY_ALIGNMENT,
    "base_methylation": CH_BASE_METHYLATION,
    "mean_coverage": CH_MEAN_COVERAGE,
    "base_6ma": CH_BASE_6MA,
    "read_supports_variant_fuzzy": CH_READ_SUPPORTS_VARIANT_FUZZY,
    "allele_sample_probability": CH_ALLELE_SAMPLE_PROBABILITY,
    "homopolymer_insertion_quality": CH_HOMOPOLYMER_INSERTION_QUALITY,
    "homopolymer_deletion_quality": CH_HOMOPOLYMER_DELETION_QUALITY,
    "inter_homopolymer_insertion_quality":
        CH_INTER_HOMOPOLYMER_INSERTION_QUALITY,
}

#: Channels painted from aux tags (MM/ML, tp/t0): the reads' tags are
#: decoded only when a channel list holds one (`core.region_reads`).
AUX_CHANNELS = frozenset({
    CH_BASE_METHYLATION, CH_BASE_6MA, CH_HOMOPOLYMER_INSERTION_QUALITY,
    CH_HOMOPOLYMER_DELETION_QUALITY, CH_INTER_HOMOPOLYMER_INSERTION_QUALITY,
})


# Per-read "Opt Channel" scalar/vector values
# (deepvariant/channels/*_channel.cc formulas).

def _homopolymer_flags(seq: np.ndarray) -> np.ndarray:
    """0/1 per base: inside a homopolymer run of >= 3
    (is_homopolymer_channel.cc:82-97)."""
    out = np.zeros(len(seq), np.uint8)
    run = (seq[2:] == seq[1:-1]) & (seq[1:-1] == seq[:-2])
    idx = np.nonzero(run)[0]
    out[idx] = 1
    out[idx + 1] = 1
    out[idx + 2] = 1
    return out


def _homopolymer_weights(seq: np.ndarray) -> np.ndarray:
    """Run length per base (homopolymer_weighted_channel.cc), a
    vectorized run-length encode: per-read channels hand this the whole
    read sequence."""
    n = len(seq)
    if n == 0:
        return np.zeros(0, np.int32)
    change = np.flatnonzero(seq[1:] != seq[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [n]))
    lens = (ends - starts).astype(np.int32)
    return np.repeat(lens, lens)


def _scale_int(value: float, max_val: float) -> int:
    value = min(value, max_val)
    return int(MAX_PIXEL_FLOAT * (float(value) / max_val))


_MAX_Q_SCORE = 93  # homopolymer_indel_quality_channel.h:65 kMaxQScore


def _base_quality_color(q: int) -> int:
    """channel_utils.cc:42 BaseQualityColor: 254 * q / 93."""
    return int(MAX_PIXEL_FLOAT * q / float(_MAX_Q_SCORE))


def _hmer_indel_qualities(
    seq: np.ndarray, qual: np.ndarray, tp, is_deletion: bool
) -> np.ndarray:
    """Per-base phred color for hmer insertion/deletion risk
    (homopolymer_indel_quality_channel.cc HomoPolymerInDelQuality).

    tp[i] sign marks the error direction the encoded quality refers
    to (<0 deletion, >0 insertion, 0 none); per homopolymer, error
    probs in the matching direction are summed and re-phred-scaled.
    No/mismatched tp tag -> flat max-quality color."""
    n = len(seq)
    out = np.full(n, _base_quality_color(_MAX_Q_SCORE), np.uint8)
    if tp is None or len(tp) != n or n == 0:
        return out
    runs = _homopolymer_weights(seq)
    i = 0
    while i < n:
        hmer_len = int(runs[i])
        err = 0.0
        for j in range(hmer_len):
            t = int(tp[i + j])
            if t == 0:
                continue
            if (t < 0) == is_deletion:
                err += 10.0 ** (int(qual[i + j]) / -10.0)
        q = _MAX_Q_SCORE if err == 0 else int(
            -10.0 * math.log10(err)
        )
        # Summed error probabilities above 1 (low qualities in a long
        # run) give a negative phred: held at 0, where the JAX package's
        # uint8 store raises OverflowError (ROADMAP.md Queue 3).
        q = min(max(q, 0), _MAX_Q_SCORE)
        out[i : i + hmer_len] = _base_quality_color(q)
        i += hmer_len
    return out

# Channels whose pixel value is constant across a read's painted
# Channels whose pixel value is constant across a read's painted
# columns; encode_read_row paints _const_color_one at every event.
PER_READ_CONST_CHANNELS = frozenset({
    CH_MAPPING_QUALITY, CH_STRAND, CH_READ_SUPPORTS_VARIANT,
    CH_INSERT_SIZE, CH_HAPLOTYPE_TAG, CH_ALLELE_FREQUENCY,
    CH_READ_MAPPING_PERCENT, CH_IDENTITY, CH_GAP_COMPRESSED_IDENTITY,
    CH_AVG_BASE_QUALITY, CH_GC_CONTENT, CH_SUPPLEMENTARY_ALIGNMENT,
    CH_READ_SUPPORTS_VARIANT_FUZZY, CH_ALLELE_SAMPLE_PROBABILITY,
    CH_BLANK, CH_MEAN_COVERAGE,
})

DEFAULT_CHANNELS = [
    CH_READ_BASE, CH_BASE_QUALITY, CH_MAPPING_QUALITY, CH_STRAND,
    CH_READ_SUPPORTS_VARIANT, CH_BASE_DIFFERS_FROM_REF,
]
WGS_CHANNELS = DEFAULT_CHANNELS + [CH_INSERT_SIZE]


@dataclasses.dataclass
class PileupOptions:
    """Defaults per pileup_image.py:36-74."""

    width: int = 221
    height: int = 100
    reference_band_height: int = 5
    min_base_quality: int = 10
    min_mapping_quality: int = 10
    base_color_offset_a_and_g: int = 40
    base_color_offset_t_and_c: int = 30
    base_color_stride: int = 70
    allele_supporting_read_alpha: float = 1.0
    allele_unsupporting_read_alpha: float = 0.6
    other_allele_supporting_read_alpha: float = 0.6
    reference_matching_read_alpha: float = 0.2
    reference_mismatching_read_alpha: float = 1.0
    indel_anchoring_base_char: str = "*"
    reference_base_quality: int = 60
    positive_strand_color: int = 70
    negative_strand_color: int = 240
    base_quality_cap: int = 40
    mapping_quality_cap: int = 60
    read_overlap_buffer_bp: int = 5
    random_seed: int = 2101079370
    min_non_zero_allele_frequency: float = 0.00001
    sort_by_haplotypes: bool = False
    sort_by_alt_allele_support: bool = False
    hp_tag_for_assembly_polishing: int = 0
    reverse_haplotypes: bool = False
    multi_allelic_mode: str = "add_het_alt"
    use_non_uniform_downsampling: bool = False
    non_uniform_downsampling_threshold: int = 3
    mean_coverage: float = 14.0
    channels: Tuple[int, ...] = tuple(WGS_CHANNELS)
    # Alt-aligned pileups (pileup_image.py defaults: 'none', 'indels').
    alt_aligned_pileup: str = "none"
    types_to_alt_align: str = "indels"

    @property
    def half_width(self) -> int:
        return (self.width - 1) // 2

    @property
    def max_reads(self) -> int:
        return self.height - self.reference_band_height


def base_color_lut(opts: PileupOptions) -> np.ndarray:
    """The 256-entry read_base color table of these options."""
    lut = np.zeros(256, np.uint8)
    lut[ord("A")] = opts.base_color_offset_a_and_g + opts.base_color_stride * 3
    lut[ord("G")] = opts.base_color_offset_a_and_g + opts.base_color_stride * 2
    lut[ord("T")] = opts.base_color_offset_t_and_c + opts.base_color_stride * 1
    lut[ord("C")] = opts.base_color_offset_t_and_c + opts.base_color_stride * 0
    return lut


def _scale_color(values: np.ndarray, cap: float) -> np.ndarray:
    # numpy float32 IEEE division, as the JAX package's host encoder
    # computes it (its jitted encoder and the plan form multiply by a
    # folded reciprocal instead, which differs at 30 caps up to 255).
    v = np.minimum(values.astype(np.float32), cap)
    return (MAX_PIXEL_FLOAT * (v / cap)).astype(np.uint8)


_OP_M, _OP_I, _OP_D, _OP_N, _OP_S = 1, 2, 3, 4, 5
_OP_EQ, _OP_X = 8, 9


class PileupEncoder:
    """Encodes pileup images for candidates in one region; the device
    planners (`pileup_device`) share its per-read helpers."""

    def __init__(self, options: Optional[PileupOptions] = None):
        self.options = options or PileupOptions()
        self._base_lut = base_color_lut(self.options)
        o = self.options
        self._strand_lut = np.array(
            [o.positive_strand_color, o.negative_strand_color], np.uint8
        )
        self._support_lut = np.array(
            [
                int(MAX_PIXEL_FLOAT * o.allele_unsupporting_read_alpha),
                int(MAX_PIXEL_FLOAT * o.allele_supporting_read_alpha),
                int(MAX_PIXEL_FLOAT * o.other_allele_supporting_read_alpha),
            ],
            np.uint8,
        )
        self._match_color = int(
            MAX_PIXEL_FLOAT * o.reference_matching_read_alpha
        )
        self._mismatch_color = int(
            MAX_PIXEL_FLOAT * o.reference_mismatching_read_alpha
        )

    # -- reference rows ----------------------------------------------------------

    def encode_reference_row(self, ref_window: np.ndarray) -> np.ndarray:
        """One reference row: (W, C) uint8 (channels/*.cc FillRefBase)."""
        o = self.options
        width = len(ref_window)
        row = np.zeros((width, len(o.channels)), np.uint8)
        for ci, ch in enumerate(o.channels):
            if ch == CH_READ_BASE:
                row[:, ci] = self._base_lut[ref_window]
            elif ch == CH_BASE_QUALITY:
                row[:, ci] = _scale_color(
                    np.full(width, o.reference_base_quality),
                    o.base_quality_cap,
                )
            elif ch == CH_MAPPING_QUALITY:
                # NB: reference rows use base_quality_cap
                # (mapping_quality_channel.cc FillRefBase).
                row[:, ci] = _scale_color(
                    np.full(width, o.reference_base_quality),
                    o.base_quality_cap,
                )
            elif ch == CH_STRAND:
                row[:, ci] = o.positive_strand_color
            elif ch == CH_READ_SUPPORTS_VARIANT:
                row[:, ci] = self._support_lut[0]
            elif ch == CH_BASE_DIFFERS_FROM_REF:
                row[:, ci] = self._match_color
            elif ch == CH_INSERT_SIZE:
                row[:, ci] = int(MAX_PIXEL_FLOAT)
            elif ch == CH_HAPLOTYPE_TAG:
                row[:, ci] = 0
            elif ch == CH_ALLELE_FREQUENCY:
                row[:, ci] = 0
            elif ch in (CH_READ_MAPPING_PERCENT, CH_AVG_BASE_QUALITY,
                        CH_IDENTITY, CH_GAP_COMPRESSED_IDENTITY):
                row[:, ci] = int(MAX_PIXEL_FLOAT)
            elif ch == CH_GC_CONTENT:
                gc = int(
                    100.0 * np.isin(
                        ref_window, (ord("G"), ord("C"))
                    ).sum() / max(len(ref_window), 1)
                )
                row[:, ci] = _scale_int(gc, 100)
            elif ch == CH_IS_HOMOPOLYMER:
                flags = _homopolymer_flags(ref_window)
                row[:, ci] = flags * int(MAX_PIXEL_FLOAT)
            elif ch == CH_HOMOPOLYMER_WEIGHTED:
                weights = np.minimum(
                    _homopolymer_weights(ref_window), 30
                ).astype(np.float32)
                row[:, ci] = (
                    MAX_PIXEL_FLOAT * weights / 30.0
                ).astype(np.uint8)
            elif ch in (CH_BASE_METHYLATION, CH_BASE_6MA,
                        CH_ALLELE_SAMPLE_PROBABILITY,
                        CH_HOMOPOLYMER_INSERTION_QUALITY,
                        CH_HOMOPOLYMER_DELETION_QUALITY,
                        CH_INTER_HOMOPOLYMER_INSERTION_QUALITY):
                row[:, ci] = 0  # ref rows 0 (channels/*.cc FillRefBase)
            elif ch == CH_READ_SUPPORTS_VARIANT_FUZZY:
                # FillRefBase = SupportsAltColor(0)
                # (read_supports_variant_fuzzy_channel.cc:117).
                row[:, ci] = self._support_lut[0]
            elif ch == CH_MEAN_COVERAGE:
                # Filled by the build_pileup post-pass
                # (pileup_image_native.cc:424-444); ref band -> 255.
                row[:, ci] = 255
            elif ch == CH_SUPPLEMENTARY_ALIGNMENT:
                # FillRefBase stores the raw alpha cast to uchar
                # (supplementary_alignment_channel.cc): int(0.6) == 0.
                row[:, ci] = int(o.allele_unsupporting_read_alpha)
        return row

    # -- read rows ---------------------------------------------------------------

    def _read_supports_alt(
        self,
        dv_call: DeepVariantCall,
        read_idx: int,
        alt_alleles: Sequence[str],
    ) -> int:
        """0 = non-supporting, 1 = supports alt-in-image, 2 = other alt
        (read_supports_variant_channel.cc:73-100)."""
        for alt in dv_call.variant.alternate_bases:
            ids = dv_call.allele_support.get(alt)
            if ids and read_idx in ids:
                return 1 if alt in alt_alleles else 2
        return 0

    def _fuzzy_support_color(
        self,
        dv_call: DeepVariantCall,
        read_idx: int,
        alt_alleles: Sequence[str],
        batch: ReadBatch,
    ) -> int:
        """read_supports_variant_fuzzy_channel.cc ReadSupportsAlt +
        SupportsAltColor: exact support of an in-image alt -> 1.0;
        support of a near-length indel on the same haplotype phase ->
        0.90 (1bp off) / 0.80 (2bp); other-alt -> 0.6; else 0.6.

        Phases come from the candidate's ALT_PS info (values[i+1] is
        alt i's phase) vs the read's HP tag; phase 0 on either side
        matches both haplotypes. Rejected-allele support
        (alternate_bases_rejected) is not tracked by our candidate
        engine, so that fuzzy source is not consulted."""
        o = self.options
        variant = dv_call.variant
        all_alts = list(variant.alternate_bases)
        alt_ps = variant.info.get("ALT_PS")
        phases = [0] * len(all_alts)
        if alt_ps:
            for ai in range(len(all_alts)):
                if len(alt_ps) > ai + 1:
                    try:
                        phases[ai] = int(alt_ps[ai + 1])
                    except (TypeError, ValueError):
                        phases[ai] = 0
        hp = int(batch.hp[read_idx]) if len(batch.hp) else 0

        def support_level(allele: str, ids) -> int:
            if not ids or read_idx not in ids:
                return 0
            if allele in alt_alleles:
                return 1
            # Supported allele is off-image: fuzzy-match against the
            # in-image alts by indel-length closeness + phase.
            for image_alt in alt_alleles:
                try:
                    gi = all_alts.index(image_alt)
                except ValueError:
                    continue
                if phases[gi] == 0 or hp == 0 or phases[gi] == hp:
                    diff = abs(len(image_alt) - len(allele))
                    if diff == 1:
                        return 10
                    if diff == 2:
                        return 9
            return 2
        for alt in all_alts:
            level = support_level(alt, dv_call.allele_support.get(alt))
            if level in (1, 10, 9):
                return self._fuzzy_color(level)
        # Reference-supporting reads can fuzzy-match a near-length alt
        # (read_supports_variant_fuzzy_channel.cc:266-283).
        ref_ids = set(dv_call.ref_support or [])
        if read_idx in ref_ids:
            for image_alt in alt_alleles:
                diff = abs(len(image_alt) - len(variant.reference_bases))
                if diff in (1, 2):
                    try:
                        gi = all_alts.index(image_alt)
                    except ValueError:
                        continue
                    if phases[gi] == 0 or hp == 0 or phases[gi] == hp:
                        return self._fuzzy_color(10 if diff == 1 else 9)
        return self._fuzzy_color(0)

    def _fuzzy_color(self, level: int) -> int:
        """SupportsAltColor (read_supports_variant_fuzzy_channel.cc:287)."""
        o = self.options
        alpha = {
            0: o.allele_unsupporting_read_alpha,
            1: o.allele_supporting_read_alpha,
            10: 0.90,
            9: 0.80,
            8: 0.70,
            2: o.other_allele_supporting_read_alpha,
        }[level]
        return int(MAX_PIXEL_FLOAT * alpha)

    def _allele_sample_probability_color(
        self, dv_call: DeepVariantCall, read_idx: int
    ) -> int:
        """allele_sample_probability_channel.cc FillReadBase: fraction
        of region reads in the same allele-support group as this read,
        sqrt-scaled (ScaleColor :88-102)."""
        total = len(dv_call.ref_support or [])
        supporting = 0
        found = False
        for _alt, ids in dv_call.allele_support.items():
            ids = ids or []
            total += len(ids)
            if not found and read_idx in ids:
                supporting = len(ids)
                found = True
        if not found:
            supporting = len(dv_call.ref_support or [])
        if total == 0:
            return 0
        probability = min(max(float(supporting), 0.0), float(total)) / total
        return int(MAX_PIXEL_FLOAT * math.sqrt(probability))

    @staticmethod
    def _downsample_with_allele_mins(
        dv_call, indices, max_reads: int, min_per_allele: int, rng
    ):
        """Crowded-window downsample that guarantees up to
        `min_per_allele` reads per alt allele before uniform fill
        (DownsampleReadIndicesWithMinsPerAllele,
        pileup_image_native.cc:286-294). Returns None when the
        guarantees cannot fit in `max_reads` (caller falls back to
        uniform sampling, matching the reference's warning path)."""
        index_set = set(int(i) for i in indices)
        picked: List[int] = []
        picked_set: set = set()
        for alt in dv_call.variant.alternate_bases:
            ids = [
                int(r) for r in dv_call.allele_support.get(alt, [])
                if int(r) in index_set and int(r) not in picked_set
            ]
            take = ids if len(ids) <= min_per_allele else [
                ids[k] for k in rng.choice(
                    len(ids), size=min_per_allele, replace=False
                )
            ]
            picked.extend(take)
            picked_set.update(take)
        if len(picked) > max_reads:
            return None
        rest = [int(i) for i in indices if int(i) not in picked_set]
        fill = max_reads - len(picked)
        if len(rest) > fill:
            order = rng.permutation(len(rest))[:fill]
            rest = [rest[k] for k in order]
        return picked + rest

    def _hap_index(self, hp: int) -> int:
        """Sort key from HP tag (pileup_image_native.cc:449-475)."""
        o = self.options
        if not o.sort_by_haplotypes:
            return 0
        if (
            o.hp_tag_for_assembly_polishing > 0
            and hp == o.hp_tag_for_assembly_polishing
        ):
            return -1
        if o.reverse_haplotypes and hp in (1, 2):
            hp = 3 - hp
        return max(0, hp)

    def _hp_channel_value(self, hp: int) -> int:
        """haplotype_tag_channel.cc GetHPValueForHPChannel + ScaleColor."""
        o = self.options
        if o.hp_tag_for_assembly_polishing == 2:
            if hp == 1:
                hp = 2
            elif hp == 2:
                hp = 1
        hp = min(max(hp, 0), 2)
        return int(MAX_PIXEL_FLOAT * hp / 2.0)

    def encode_read_row(
        self,
        batch: ReadBatch,
        read_idx: int,
        ref_window: np.ndarray,
        image_start_pos: int,
        variant_start: int,
        support_code: int,
        af_value: float = 0.0,
        dv_call: Optional[DeepVariantCall] = None,
        alt_alleles: Sequence[str] = (),
    ) -> Optional[np.ndarray]:
        """Encode one read into a (W, C) row, or None if the read bails
        (EncodeRead + CalculateBaseLevelData semantics)."""
        o = self.options
        mapq = int(batch.mapq[read_idx])
        if mapq < o.min_mapping_quality:
            return None
        width = len(ref_window)
        cols, bases, quals, rpos = self._walk_events_with_positions(
            batch, read_idx, image_start_pos, width
        )
        if cols is None:
            return None
        # Low-quality base at the call site -> drop read.
        at_call = cols == (variant_start - image_start_pos)
        if np.any(quals[at_call] < o.min_base_quality):
            return None

        row = np.zeros((width, len(o.channels)), np.uint8)
        ref_at = ref_window[cols]
        for ci, ch in enumerate(o.channels):
            if ch == CH_READ_BASE:
                row[cols, ci] = self._base_lut[bases]
            elif ch == CH_BASE_QUALITY:
                row[cols, ci] = _scale_color(quals, o.base_quality_cap)
            elif ch == CH_BASE_DIFFERS_FROM_REF:
                row[cols, ci] = np.where(
                    bases == ref_at, self._match_color, self._mismatch_color
                )
            elif ch in PER_READ_CONST_CHANNELS:
                row[cols, ci] = self._const_color_one(
                    ch, batch, read_idx, support_code, af_value,
                    dv_call, alt_alleles,
                )
            elif ch == CH_IS_HOMOPOLYMER:
                so = batch.seq_offsets
                full_seq = batch.seq[so[read_idx]:so[read_idx + 1]]
                flags = _homopolymer_flags(full_seq)
                row[cols, ci] = flags[rpos] * int(MAX_PIXEL_FLOAT)
            elif ch == CH_HOMOPOLYMER_WEIGHTED:
                so = batch.seq_offsets
                full_seq = batch.seq[so[read_idx]:so[read_idx + 1]]
                weights = np.minimum(
                    _homopolymer_weights(full_seq), 30
                ).astype(np.float32)
                row[cols, ci] = (
                    MAX_PIXEL_FLOAT * weights[rpos] / 30.0
                ).astype(np.uint8)
            elif ch == CH_BASE_METHYLATION:
                meth = batch.meth[read_idx] if batch.meth else None
                if meth is not None:
                    # 5mC prob 0-255 scaled to 0-254
                    # (base_methylation_channel.cc ScaleColorVector).
                    row[cols, ci] = (
                        MAX_PIXEL_FLOAT
                        * meth[rpos].astype(np.float32) / 255.0
                    ).astype(np.uint8)
            elif ch == CH_BASE_6MA:
                m6a = (batch.meth6ma[read_idx]
                       if batch.meth6ma else None)
                if m6a is not None:
                    # 6mA prob 0-255 scaled to 0-254
                    # (base_6ma_channel.cc ScaleColorVector).
                    row[cols, ci] = (
                        MAX_PIXEL_FLOAT
                        * m6a[rpos].astype(np.float32) / 255.0
                    ).astype(np.uint8)
            elif ch in (CH_HOMOPOLYMER_INSERTION_QUALITY,
                        CH_HOMOPOLYMER_DELETION_QUALITY):
                so = batch.seq_offsets
                full_seq = batch.seq[so[read_idx]:so[read_idx + 1]]
                full_qual = batch.qual[so[read_idx]:so[read_idx + 1]]
                tp = batch.tp[read_idx] if batch.tp else None
                colors = _hmer_indel_qualities(
                    full_seq, full_qual, tp,
                    is_deletion=(
                        ch == CH_HOMOPOLYMER_DELETION_QUALITY
                    ),
                )
                row[cols, ci] = colors[rpos]
            elif ch == CH_INTER_HOMOPOLYMER_INSERTION_QUALITY:
                t0 = batch.t0[read_idx] if batch.t0 else None
                if t0 is not None:
                    # t0 Q-scores -> BaseQualityColor per base
                    # (inter_homopolymer_insertion_quality_channel.cc
                    # GetT0QualityValues).
                    colors = (
                        MAX_PIXEL_FLOAT
                        * np.minimum(
                            t0.astype(np.float32), _MAX_Q_SCORE
                        ) / float(_MAX_Q_SCORE)
                    ).astype(np.uint8)
                    valid = rpos < len(colors)
                    row[cols[valid], ci] = colors[rpos[valid]]
        return row

    def _const_color_one(
        self,
        ch: int,
        batch: ReadBatch,
        read_idx: int,
        support_code: int,
        af_value: float,
        dv_call: Optional[DeepVariantCall],
        alt_alleles: Sequence[str],
    ) -> int:
        """Per-read pixel value for a PER_READ_CONST_CHANNELS channel
        (the per-channel formulas of deepvariant/channels/*_channel.cc)."""
        o = self.options
        if ch == CH_MAPPING_QUALITY:
            return int(_scale_color(
                np.array([int(batch.mapq[read_idx])]),
                o.mapping_quality_cap,
            )[0])
        if ch == CH_STRAND:
            return int(self._strand_lut[
                int(bool(batch.flag[read_idx] & FLAG_REVERSE))
            ])
        if ch == CH_READ_SUPPORTS_VARIANT:
            return int(self._support_lut[support_code])
        if ch == CH_INSERT_SIZE:
            frag = min(abs(int(batch.tlen[read_idx])), 1000)
            return int(MAX_PIXEL_FLOAT * frag / 1000.0)
        if ch == CH_HAPLOTYPE_TAG:
            return self._hp_channel_value(int(batch.hp[read_idx]))
        if ch == CH_ALLELE_FREQUENCY:
            return self._allele_frequency_color(af_value)
        if ch == CH_READ_MAPPING_PERCENT or ch == CH_IDENTITY:
            # Both are matched-bases / read-length * 100
            # ({read_mapping_percent,identity}_channel.cc).
            so = batch.seq_offsets
            co = batch.cigar_offsets
            ops = batch.cigar_ops[co[read_idx]:co[read_idx + 1]]
            lens = batch.cigar_lens[co[read_idx]:co[read_idx + 1]]
            match_len = int(lens[(ops == _OP_M) | (ops == _OP_EQ)].sum())
            read_len = int(so[read_idx + 1] - so[read_idx]) or 1
            return _scale_int(int(100.0 * match_len / read_len), 100)
        if ch == CH_GAP_COMPRESSED_IDENTITY:
            co = batch.cigar_offsets
            ops = batch.cigar_ops[co[read_idx]:co[read_idx + 1]]
            lens = batch.cigar_lens[co[read_idx]:co[read_idx + 1]]
            is_match = (ops == _OP_M) | (ops == _OP_EQ)
            match_len = int(lens[is_match].sum())
            gap_len = match_len + int(
                lens[ops == _OP_X].sum()
            ) + int(((ops == _OP_I) | (ops == _OP_D)).sum())
            return _scale_int(
                int(100.0 * match_len / gap_len) if gap_len else 0, 100
            )
        if ch == CH_AVG_BASE_QUALITY:
            so = batch.seq_offsets
            all_quals = batch.qual[so[read_idx]:so[read_idx + 1]]
            avg = int(np.sum(all_quals) / max(len(all_quals), 1))
            return _scale_int(avg, 93)
        if ch == CH_GC_CONTENT:
            so = batch.seq_offsets
            full_seq = batch.seq[so[read_idx]:so[read_idx + 1]]
            gc = int(100.0 * np.isin(
                full_seq, (ord("G"), ord("C"))
            ).sum() / max(len(full_seq), 1))
            return _scale_int(gc, 100)
        if ch == CH_SUPPLEMENTARY_ALIGNMENT:
            supplementary = bool(batch.flag[read_idx] & 0x800)
            alpha = (o.allele_supporting_read_alpha if supplementary
                     else o.allele_unsupporting_read_alpha)
            return int(MAX_PIXEL_FLOAT * alpha)
        if ch == CH_READ_SUPPORTS_VARIANT_FUZZY:
            return int(self._fuzzy_support_color(
                dv_call, read_idx, alt_alleles, batch
            )) if dv_call is not None else int(self._support_lut[0])
        if ch == CH_ALLELE_SAMPLE_PROBABILITY:
            return int(self._allele_sample_probability_color(
                dv_call, read_idx
            )) if dv_call is not None else 0
        # CH_BLANK / CH_MEAN_COVERAGE: zero inside the read band
        # (mean-coverage bars are painted after placement).
        return 0

    def _allele_frequency_color(self, allele_frequency: float) -> int:
        """Log-scaled AF pixel (allele_frequency_channel.cc:78-86):
        ((log10(min) - log10(af)) / log10(min)) * 254, min = 1e-5."""
        min_af = self.options.min_non_zero_allele_frequency
        if allele_frequency <= min_af:
            return 0
        log10_af = math.log10(allele_frequency)
        log10_min = math.log10(min_af)
        return int(((log10_min - log10_af) / log10_min) * MAX_PIXEL_FLOAT)

    def _read_allele_frequency(
        self,
        dv_call: DeepVariantCall,
        read_idx: int,
        alt_alleles,
    ) -> float:
        """AF of the alt this read supports, if it is an alt-in-image
        (ReadAlleleFrequency, allele_frequency_channel.cc:89-119)."""
        for alt in dv_call.variant.alternate_bases:
            ids = dv_call.allele_support.get(alt)
            if ids and read_idx in ids and alt in alt_alleles:
                return dv_call.allele_frequencies.get(alt, 0.0)
        return 0.0

    def _walk_events(self, batch, read_idx, image_start_pos, width):
        cols, bases, quals, _ = self._walk_events_with_positions(
            batch, read_idx, image_start_pos, width
        )
        return cols, bases, quals

    def _walk_events_with_positions(
        self, batch, read_idx, image_start_pos, width
    ):
        """CIGAR walk -> (cols, read_base_bytes, quals, read_positions)
        in cigar order (pileup_channel_lib.cc:170-260); read_positions
        index into the read sequence. Returns (None,)*4 on empty."""
        co = batch.cigar_offsets
        so = batch.seq_offsets
        ops = batch.cigar_ops[co[read_idx] : co[read_idx + 1]]
        lens = batch.cigar_lens[co[read_idx] : co[read_idx + 1]].astype(
            np.int64
        )
        seq = batch.seq[so[read_idx] : so[read_idx + 1]]
        qual = batch.qual[so[read_idx] : so[read_idx + 1]]
        star = ord(self.options.indel_anchoring_base_char)

        cols_l: List[np.ndarray] = []
        bases_l: List[np.ndarray] = []
        quals_l: List[np.ndarray] = []
        rpos_l: List[np.ndarray] = []
        ref_i = int(batch.pos[read_idx])
        read_i = 0
        for op, op_len in zip(ops, lens):
            op_len = int(op_len)
            if op in (_OP_M, _OP_EQ, _OP_X):
                c = np.arange(ref_i, ref_i + op_len) - image_start_pos
                ok = (c >= 0) & (c < width)
                cols_l.append(c[ok])
                bases_l.append(seq[read_i : read_i + op_len][ok])
                quals_l.append(qual[read_i : read_i + op_len][ok])
                rpos_l.append(
                    np.arange(read_i, read_i + op_len)[ok]
                )
                ref_i += op_len
                read_i += op_len
            elif op in (_OP_I, _OP_S):
                # INSERT paints the anchor base; CLIP_SOFT paints nothing
                # (pileup_channel_lib.cc:130-143 leaves read_base 0 for
                # CLIP_SOFT, so the `if (read_base && ...)` guard skips it).
                if op == _OP_I and ref_i > 0:
                    c = ref_i - 1 - image_start_pos
                    if 0 <= c < width:
                        cols_l.append(np.array([c]))
                        bases_l.append(np.array([star], np.uint8))
                        quals_l.append(np.array([qual[read_i]]))
                        rpos_l.append(np.array([read_i]))
                read_i += op_len
            elif op in (_OP_D, _OP_N):
                if read_i > 0:
                    c = ref_i - 1 - image_start_pos
                    if 0 <= c < width:
                        cols_l.append(np.array([c]))
                        bases_l.append(np.array([star], np.uint8))
                        quals_l.append(
                            np.array([qual[read_i - 1]])
                        )
                        rpos_l.append(np.array([read_i - 1]))
                ref_i += op_len
            # CLIP_HARD / PAD: ignored.
        if not cols_l:
            return None, None, None, None
        cols = np.concatenate(cols_l).astype(np.int64)
        if len(cols) == 0:
            return None, None, None, None
        return (
            cols,
            np.concatenate(bases_l),
            np.concatenate(quals_l),
            np.concatenate(rpos_l).astype(np.int64),
        )

    # -- full pileup ----------------------------------------------------------------

    def build_pileup(
        self,
        dv_call: DeepVariantCall,
        ref_window: np.ndarray,
        batch: ReadBatch,
        read_indices: Sequence[int],
        alt_alleles: Sequence[str],
        sort_positions=None,
    ) -> np.ndarray:
        """(H, W, C) uint8 pileup (BuildPileupForOneSample).

        sort_positions: optional per-batch-index array overriding the
        position component of the row sort key — trimmed/realigned
        pileups sort rows by the reads' ORIGINAL alignment positions
        (alignment_positions, pileup_image_native.cc:397-401 fed from
        original_start_positions, make_examples_native.cc:677-684)."""
        o = self.options
        variant = dv_call.variant
        image_start_pos = variant.start - o.half_width
        if len(ref_window) != o.width:
            raise ValueError(f"reference window of {len(ref_window)} "
                             f"bases, the pileup is {o.width} wide")
        height = o.height
        n_channels = len(o.channels)
        image = np.zeros((height, o.width, n_channels), np.uint8)
        ref_row = self.encode_reference_row(ref_window)
        for i in range(o.reference_band_height):
            image[i] = ref_row

        max_reads = o.max_reads
        indices = list(read_indices)
        if len(indices) > max_reads:
            rng = np.random.Generator(np.random.Philox(o.random_seed))

            def permute():
                # Crowded window: the reference shuffles the index list
                # with std::shuffle + mt19937_64(random_seed)
                # (DownsampleReadIndices, pileup_image_native.cc:153),
                # as the JAX package's native library does.
                order = shuffle_indices(len(indices), o.random_seed)
                return [indices[k] for k in order]

            if o.use_non_uniform_downsampling:
                picked = self._downsample_with_allele_mins(
                    dv_call, indices, max_reads,
                    o.non_uniform_downsampling_threshold, rng,
                )
                indices = picked if picked is not None else permute()
            else:
                indices = permute()

        # Precompute allele-support groups for sorting.
        alt_order = {
            alt: i for i, alt in enumerate(variant.alternate_bases)
        }
        support_group: Dict[int, int] = {}
        if o.sort_by_alt_allele_support:
            for alt, ids in dv_call.allele_support.items():
                gi = alt_order.get(alt)
                if gi is not None:
                    for rid in ids:
                        support_group[rid] = gi

        support_codes = [
            self._read_supports_alt(dv_call, idx, alt_alleles)
            for idx in indices
        ]
        if CH_ALLELE_FREQUENCY in o.channels:
            af_values = [
                self._read_allele_frequency(dv_call, idx, alt_alleles)
                for idx in indices
            ]
        else:
            af_values = [0.0] * len(indices)

        def sort_key(idx, row):
            hap_idx = self._hap_index(int(batch.hp[idx]))
            group = support_group.get(idx, len(alt_order)) if (
                o.sort_by_alt_allele_support
            ) else 0
            return (
                hap_idx, group,
                int(sort_positions[idx]) if sort_positions is not None
                else int(batch.pos[idx]),
                batch.name[idx],
                0 if batch.flag[idx] & FLAG_FIRST or not (
                    batch.flag[idx] & FLAG_PAIRED
                ) else 1,
                row,
            )

        rows = []
        for k, idx in enumerate(indices):
            if len(rows) >= max_reads:
                break
            row = self.encode_read_row(
                batch, idx, ref_window, image_start_pos,
                variant.start, support_codes[k], af_values[k],
                dv_call=dv_call, alt_alleles=alt_alleles,
            )
            if row is None:
                continue
            rows.append(sort_key(idx, row))
        rows.sort(key=lambda t: t[:5])
        for i, (_, _, _, _, _, row) in enumerate(rows):
            image[o.reference_band_height + i] = row
        if CH_MEAN_COVERAGE in o.channels:
            # Bar-graph fill after reads are placed
            # (pileup_image_native.cc:424-444): ref band rows 255,
            # then rows up to mean_coverage get 200.
            ci = o.channels.index(CH_MEAN_COVERAGE)
            top = min(
                int(o.mean_coverage) + o.reference_band_height, height
            )
            image[:o.reference_band_height, :, ci] = 255
            image[o.reference_band_height:top, :, ci] = 200
        return image

def reads_overlapping_variant(
    batch: ReadBatch, variant, buffer_bp: int = 5
) -> np.ndarray:
    """Indices of reads overlapping [start - buffer, end + buffer)
    (read selection in CreateAndWriteExamplesForCandidate :643-648)."""
    lo = variant.start - buffer_bp
    hi = variant.end + buffer_bp
    ends = batch.reference_ends()
    return np.nonzero((batch.pos < hi) & (ends > lo))[0]

"""Pileup image options, channel constants and the planners' helpers.

A copy of what stage 2, the device encoders and their row planners need
from `deepvariant_tpu.make_examples.pileup`: the constants and options,
and of `PileupEncoder` the CIGAR walk, the support, allele-frequency and
haplotype helpers and the read query. The host painter itself
(`build_pileup`, `encode_read_row`, the opt channels) is not part of the
port yet.

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
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.io.bam import ReadBatch
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


_OP_M, _OP_I, _OP_D, _OP_N, _OP_S = 1, 2, 3, 4, 5
_OP_EQ, _OP_X = 8, 9


class PileupEncoder:
    """The planners' half of the host pileup encoder: options and the
    per-read helpers that `pileup_device.build_region_tensors` and
    `plan_candidate` call."""

    def __init__(self, options: Optional[PileupOptions] = None):
        self.options = options or PileupOptions()

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


def reads_overlapping_variant(
    batch: ReadBatch, variant, buffer_bp: int = 5
) -> np.ndarray:
    """Indices of reads overlapping [start - buffer, end + buffer)
    (read selection in CreateAndWriteExamplesForCandidate :643-648)."""
    lo = variant.start - buffer_bp
    hi = variant.end + buffer_bp
    ends = batch.reference_ends()
    return np.nonzero((batch.pos < hi) & (ends > lo))[0]

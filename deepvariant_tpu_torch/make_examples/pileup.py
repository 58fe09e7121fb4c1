"""Pileup image options and channel constants.

A copy of the constants and options of `deepvariant_tpu.make_examples.
pileup` that stage 2 and the device plan painter need; the host encoder
itself is not part of the port yet.

Numerics contract (channels/channel.h:78 kMaxPixelValueAsFloat = 254):
- read_base: A=40+70*3=250, G=40+70*2=180, T=30+70*1=100, C=30+70*0=30, else 0
- base_quality: int(254 * min(q, 40)/40); ref rows use q=60 -> 254
- mapping_quality: int(254 * min(mq, 60)/60); ref rows 254
- strand: forward 70, reverse 240; ref rows 70
- read_supports_variant: 254*alpha, alpha = 1.0 supports alt-in-image,
  0.6 other-alt, 0.6 non-supporting; ref rows 0.6
- base_differs_from_ref: match 0.2*254=50, mismatch 254; ref rows 50
- insert_size: int(254 * min(|tlen|, 1000)/1000); ref rows 254
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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

"""Alt-aligned pileup support: read trimming + realignment to alt
haplotypes (reference alt_aligned_pileup_lib.{h,cc}).

Used by long-read presets (PacBio/ONT): for indel candidates, reads are
trimmed to the pileup window (TrimCigar/TrimReads, :91-270) and
force-realigned against each alt haplotype (ref window with the alt
substituted, make_examples_native.cc:269-297) to produce up to two
extra alt-aligned pileup images, composed into the example as either
two extra channels (diff_channels/base_channels,
pileup_image_native.h:214-255) or extra rows (rows/single_row).

The port's copy of `deepvariant_tpu.make_examples.alt_aligned`. The
host painter and the planners use the trimming and the realignment;
`compose_alt_aligned` joins the host-painted images in every mode (the
diff_channels planes of a plan are composed on the card by the paint
kernel).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deepvariant_tpu_torch.core.types import CHAR_TO_PROTO_OP, Range, Read, Variant
from deepvariant_tpu_torch.realign.config import AlignerOptions
from deepvariant_tpu_torch.realign.fast_pass_aligner import FastPassAligner

OP_M = CHAR_TO_PROTO_OP["M"]
_REF_ADVANCING = frozenset(CHAR_TO_PROTO_OP[c] for c in "MDN=X")
_READ_ADVANCING = frozenset(CHAR_TO_PROTO_OP[c] for c in "MIS=X")

DEFAULT_MIN_OVERLAP = 15  # TrimReads min_overlap


def trim_cigar(
    cigar: Sequence[Tuple[int, int]], ref_start: int, ref_length: int
) -> Tuple[List[Tuple[int, int]], int, int]:
    """(new_cigar, read_start, new_read_length); ref_start is relative
    to the read's alignment (TrimCigar, alt_aligned_pileup_lib.cc:91)."""
    trim_remaining = ref_start
    ref_to_cover = ref_length
    read_start = 0
    new_read_length = 0
    new_cigar: List[Tuple[int, int]] = []
    for op, length in cigar:
        advances_ref = op in _REF_ADVANCING
        advances_read = op in _READ_ADVANCING
        ref_step = length if advances_ref else 0
        if trim_remaining > 0:
            if ref_step <= trim_remaining:
                trim_remaining -= ref_step
                read_start += length if advances_read else 0
                continue
            ref_step -= trim_remaining
            read_start += trim_remaining if advances_read else 0
            length = ref_step
            trim_remaining = 0
        if trim_remaining == 0:
            if ref_step <= ref_to_cover:
                new_cigar.append((op, length))
                ref_to_cover -= ref_step
                new_read_length += length if advances_read else 0
            else:
                new_cigar.append((op, ref_to_cover))
                new_read_length += ref_to_cover if advances_read else 0
                ref_to_cover = 0
                break
    return new_cigar, read_start, new_read_length


def trim_read(read: Read, region: Range) -> Read:
    """Trim a read to `region` (TrimRead, :149-218)."""
    read_start = read.position
    trim_left = max(region.start - read_start, 0)
    ref_length = region.end - max(region.start, read_start)
    assert ref_length > 0, "read must overlap region"
    new_cigar, read_trim, new_len = trim_cigar(
        read.cigar, trim_left, ref_length
    )
    new_read = dataclasses.replace(
        read,
        cigar=new_cigar,
        position=region.start if trim_left != 0 else read.position,
        aligned_sequence=read.aligned_sequence[
            read_trim:read_trim + new_len
        ],
        aligned_quality=read.aligned_quality[
            read_trim:read_trim + new_len
        ],
    )
    return new_read


def _cigar_ref_length(cigar: Sequence[Tuple[int, int]]) -> int:
    return sum(l for op, l in cigar if op in _REF_ADVANCING)


def trim_reads(
    reads: Sequence[Read], region: Range,
    min_overlap: int = DEFAULT_MIN_OVERLAP,
) -> Tuple[List[Read], List[int]]:
    """(trimmed reads, their original indices) (TrimReads, :250-270)."""
    out: List[Read] = []
    original_indices: List[int] = []
    for i, read in enumerate(reads):
        if read.position >= region.end or read.end() <= region.start:
            continue
        trimmed = trim_read(read, region)
        if _cigar_ref_length(trimmed.cigar) >= min_overlap and \
                trimmed.aligned_sequence:
            out.append(trimmed)
            original_indices.append(i)
    return out, original_indices


def calculate_alignment_region(
    variant: Variant, half_width: int, contig_n_bases: int
) -> Range:
    """(CalculateAlignmentRegion, :221-235)."""
    ref_end = variant.start + len(variant.reference_bases)
    return Range(
        variant.reference_name,
        max(variant.start - half_width, 0),
        min(contig_n_bases, ref_end + half_width),
    )


def create_haplotype(
    variant: Variant, alt: str, half_width: int, ref_query, contig_n_bases: int
) -> Tuple[str, int, int]:
    """Ref window with alt substituted (CreateHaplotype,
    make_examples_native.cc:269-297). Returns (hap, ref_start, ref_end)."""
    var_start = variant.start
    var_end = var_start + len(variant.reference_bases)
    contig = variant.reference_name
    ref_start = max(var_start - half_width, 0)
    prefix = ref_query(Range(contig, ref_start, var_start)) \
        if ref_start < var_start else ""
    ref_end = min(contig_n_bases, var_end + half_width)
    suffix = ref_query(Range(contig, var_end, ref_end)) \
        if ref_end > var_end else ""
    return prefix + alt + suffix, ref_start, ref_end


def realign_reads_to_haplotype(
    haplotype: str,
    reads: Sequence[Read],
    contig: str,
    ref_start: int,
    ref_end: int,
    ref_query,
    contig_n_bases: int,
    aln_options: Optional[AlignerOptions] = None,
) -> List[Read]:
    """Force-align reads to one haplotype
    (RealignReadsToHaplotype, :278-330). Unalignable reads come back
    empty (aligned_sequence == '').

    Unlike the python realigner's align_to_haplotype (which pads with
    _REF_ALIGN_MARGIN=20), this C++-path equivalent uses NO reference
    margin (kRefAlignMargin = 0, alt_aligned_pileup_lib.cc:62): reads
    longer than the haplotype window cannot be placed ungapped by the
    fast pass and fall through to SSW, which soft-clips them to the
    window — the behavior the golden alt-aligned images pin."""
    options = dataclasses.replace(aln_options or AlignerOptions())
    if reads and len(reads[0].aligned_sequence) > 15:
        options.read_size = len(reads[0].aligned_sequence)
    else:
        options.read_size = 200
    options.force_alignment = True
    aligner = FastPassAligner(options)
    aligner.set_reference(haplotype)
    aligner.set_ref_start(contig, ref_start)
    aligner.set_ref_prefix_len(0)
    aligner.set_ref_suffix_len(0)
    aligner.set_haplotypes([haplotype])
    return aligner.realign_reads(reads)


# Channel index of the plane copied into the alt-aligned channels
# (pileup_image_native.h:222-233): 5 = base_differs_from_ref for
# diff_channels, 0 = read_base for base_channels.
ALT_CHANNEL_INDEX = {"diff_channels": 5, "base_channels": 0}


def compose_alt_aligned(
    ref_image: np.ndarray,
    alt_images: List[Optional[np.ndarray]],
    mode: str,
    alt_combination: Sequence[str],
) -> np.ndarray:
    """Compose the final example tensor from ref + alt images
    (FillPileupArray, pileup_image_native.h:214-310)."""
    if mode == "none" or not mode:
        return ref_image
    if mode in ("diff_channels", "base_channels"):
        ci = ALT_CHANNEL_INDEX[mode]
        h, w, _ = ref_image.shape
        alt1 = alt_images[0][:, :, ci] if alt_images and \
            alt_images[0] is not None else np.zeros((h, w), np.uint8)
        if len(alt_images) > 1 and alt_images[1] is not None:
            alt2 = alt_images[1][:, :, ci]
        else:
            alt2 = alt1  # alt2 falls back to alt1 (h:232-242)
        return np.concatenate(
            [ref_image, alt1[:, :, None], alt2[:, :, None]], axis=-1
        )
    if mode == "rows":
        h, w, c = ref_image.shape
        planes = [ref_image]
        for i in range(2):
            img = alt_images[i] if i < len(alt_images) else None
            planes.append(
                img if img is not None else np.zeros((h, w, c), np.uint8)
            )
        return np.concatenate(planes, axis=0)
    if mode == "single_row":
        # Use the longer alt when two are present (h:199-205).
        idx = 0
        if len(alt_combination) == 2 and \
                len(alt_combination[1]) > len(alt_combination[0]):
            idx = 1
        h, w, c = ref_image.shape
        img = alt_images[idx] if idx < len(alt_images) else None
        if img is None:
            img = np.zeros((h, w, c), np.uint8)
        return np.concatenate([ref_image, img], axis=0)
    raise ValueError(f"unknown alt_aligned_pileup mode: {mode}")

"""Pileup visualization + automated curation library.

The port's copy of `deepvariant_tpu.tools.vis`: the same arrays,
curation tags and pixels as the JAX module. One difference: an image
without a header (no labels) is written by this module's own PNG
encoder (`write_png`, zlib and struct) and needs no Pillow; an image
with a header still draws its text with Pillow's font, imported where
the JAX module imports it.

Port of the reference's nucleus/util/vis.py public surface:
example accessors (image array, channels, variant, alt indices, locus
ids, label), PNG color scaling and export, the RGB quick-view, and the
automated pileup curation stack (base/mapping quality fractions,
strand-bias binomial test, diff/nearby-variant analysis,
curate_pileup). Examples here are the repo's byte-level
tf.Example codec objects (io/examples.py), not protos; every numeric
behavior matches nucleus/util/vis.py:95-854.
"""

from __future__ import annotations

import enum
import math
import struct
import zlib
from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np

from deepvariant_tpu_torch.core.types import Variant
from deepvariant_tpu_torch.io import examples as exio

DEEPVARIANT_CHANNEL_NAMES = [
    "read base", "base quality", "mapping quality", "strand",
    "read supports variant", "base differs from ref", "haplotype tag",
    "alternate allele 1", "alternate allele 2",
]


class Diff(enum.Enum):
    FEW_DIFFS = 1
    MANY_DIFFS = 2
    NEARBY_VARIANTS = 3


class BaseQuality(enum.Enum):
    GOOD = 1
    BAD = 2


class MappingQuality(enum.Enum):
    GOOD = 1
    BAD = 2


class StrandBias(enum.Enum):
    GOOD = 1
    BIASED = 2


class ReadSupport(enum.Enum):
    ALL = 1
    HALF = 2
    LOW = 3


PileupCuration = NamedTuple("PileupCuration", [
    ("base_quality", BaseQuality),
    ("mapping_quality", MappingQuality),
    ("strand_bias", StrandBias),
    ("diff_category", Diff),
    ("read_support", ReadSupport),
])

ExampleLike = Union[bytes, exio.DecodedExample]


def _as_decoded(example: ExampleLike) -> exio.DecodedExample:
    if isinstance(example, (bytes, bytearray)):
        return exio.parse_example(bytes(example))
    return example


def get_image_array_from_example(example: ExampleLike) -> np.ndarray:
    """The (H, W, C) uint8 pileup tensor of an example."""
    return _as_decoded(example).image


def split_3d_array_into_channels(arr: np.ndarray) -> List[np.ndarray]:
    """(H, W, C) -> list of C (H, W) planes."""
    return [arr[:, :, i] for i in range(arr.shape[-1])]


def channels_from_example(example: ExampleLike) -> List[np.ndarray]:
    return split_3d_array_into_channels(
        get_image_array_from_example(example)
    )


def convert_6_channels_to_rgb(channels: List[np.ndarray]) -> np.ndarray:
    """Quick RGB view: R = base, G = min(base qual, mapq), B = strand,
    all alpha-weighted by support * differs (vis.py:143-164). 254 is
    the quality ceiling (255 is reserved by the SAM spec)."""
    base = channels[0]
    qual = np.minimum(channels[1], channels[2])
    strand = channels[3]
    alpha = (channels[4] / 254.0) * (channels[5] / 254.0)
    return (
        np.stack([base, qual, strand]) * alpha
    ).astype(np.uint8).transpose([1, 2, 0])


def scale_colors_for_png(arr: np.ndarray, vmin=0, vmax=255) -> np.ndarray:
    """Clamp to [vmin, vmax] and rescale to uint8 0..255."""
    if vmax == 0 or vmax <= vmin:
        raise ValueError("vmax must be non-zero and greater than vmin")
    scaled = np.clip(arr, vmin, vmax)
    if vmin != 0 or vmax != 255:
        scaled = ((scaled - vmin) / (vmax - vmin)) * 255
    return scaled.astype(np.uint8)


def image_type_from_array(arr: np.ndarray) -> str:
    """'RGB' for (H, W, 3), 'L' for (H, W); raises otherwise."""
    if arr.ndim == 3 and arr.shape[2] == 3:
        return "RGB"
    if arr.ndim == 2:
        return "L"
    raise ValueError(
        "array must be (x, y) or (x, y, 3); found shape "
        f"{arr.shape}"
    )


def autoscale_colors_for_png(
    arr: np.ndarray, vmin=None, vmax=None
) -> Tuple[np.ndarray, str]:
    """Rescale to the data range (or the given one); returns the
    scaled array and its PIL image mode."""
    image_mode = image_type_from_array(arr)
    if vmin is None:
        vmin = np.min(arr)
    if vmax is None:
        vmax = np.max(arr)
    if vmin == vmax:
        # All-equal input: keep the shape visible instead of erroring.
        vmax = vmin + 1
    return scale_colors_for_png(arr, vmin=vmin, vmax=vmax), image_mode


def write_png(arr: np.ndarray, path: str) -> None:
    """Write an (H, W) or (H, W, 3) uint8 array as an 8-bit grayscale or
    RGB PNG: one IDAT of unfiltered scanlines."""
    color_type = {"L": 0, "RGB": 2}[image_type_from_array(arr)]
    h, w = arr.shape[:2]
    rows = np.zeros((h, 1 + arr[0].size), np.uint8)  # filter byte 0
    rows[:, 1:] = np.asarray(arr, np.uint8).reshape(h, -1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                             color_type, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + chunk(b"IEND", b""))


class PngImage:
    """What `array_to_png` returns for an image without a header: its
    uint8 pixels, with the `size`, `mode` and `save` of a Pillow image."""

    def __init__(self, pixels: np.ndarray, mode: str):
        self.pixels = pixels
        self.mode = mode

    @property
    def size(self) -> Tuple[int, int]:
        return self.pixels.shape[1], self.pixels.shape[0]

    def save(self, path: str) -> None:
        write_png(self.pixels, path)


def add_header(img, labels, mark_midpoints: bool = True,
               header_height: int = 20):
    """Adds a header strip with evenly-distributed labels."""
    from PIL import Image, ImageDraw

    if not labels:
        return img
    spacing = int(img.size[0] / len(labels))
    canvas = Image.new("RGB", (img.size[0], img.size[1] + header_height),
                       (255, 255, 255))
    canvas.paste(img, (0, header_height))
    draw = ImageDraw.Draw(canvas)
    for i, label in enumerate(labels):
        draw.text((i * spacing + 2, 2), str(label), fill=(0, 0, 0))
        if mark_midpoints:
            x = i * spacing + spacing // 2
            draw.line(
                [(x, header_height - 4), (x, header_height)],
                fill=(0, 0, 0),
            )
    return canvas


def array_to_png(arr: np.ndarray, vmin=None, vmax=None,
                 scale: Optional[int] = None,
                 labels: Optional[List[str]] = None):
    """An autoscaled image from a 2D/RGB array: a Pillow image with the
    labels drawn in a header, or a `PngImage` without labels."""
    scaled, image_mode = autoscale_colors_for_png(arr, vmin, vmax)
    if scale is None:
        scale = max(1, int(500 / max(scaled.shape[:2])))
    if scale != 1:
        scaled = np.repeat(
            np.repeat(scaled, scale, axis=0), scale, axis=1
        )
        if labels is not None:
            labels = list(labels)
    if not labels:
        return PngImage(scaled, image_mode)
    from PIL import Image

    return add_header(Image.fromarray(scaled, mode=image_mode), labels)


def save_to_png(arr: np.ndarray, path: str, vmin=None, vmax=None,
                scale: Optional[int] = None,
                labels: Optional[List[str]] = None,
                show: bool = False) -> None:
    img = array_to_png(arr, vmin=vmin, vmax=vmax, scale=scale,
                       labels=labels)
    img.save(path)


def _deepvariant_channel_names(num_channels: int) -> List[str]:
    """First `num_channels` canonical names, padded with opt-channel
    placeholders beyond the named nine."""
    names = list(DEEPVARIANT_CHANNEL_NAMES)
    while len(names) < num_channels:
        names.append(f"channel {len(names) + 1}")
    return names[:num_channels]


def draw_deepvariant_pileup(
    example: Optional[ExampleLike] = None,
    channels: Optional[List[np.ndarray]] = None,
    composite_type: Optional[str] = None,
    annotated: bool = True,
    labels: Optional[List[str]] = None,
    path: Optional[str] = None,
    scale: Optional[int] = None,
    show: bool = False,
):
    """Draw a pileup: one grayscale panel per channel, or an RGB
    composite (vis.py:425-480)."""
    if example is not None and channels is None:
        channels = channels_from_example(example)
    elif channels is None:
        raise ValueError("either example or channels must be given")
    if composite_type is None:
        img_array = np.concatenate(channels, axis=1)
        if annotated and labels is None:
            labels = _deepvariant_channel_names(len(channels))
    elif composite_type == "RGB":
        img_array = convert_6_channels_to_rgb(channels)
        if annotated and labels is None:
            labels = [""]
    else:
        raise ValueError(
            "composite_type must be None or 'RGB', got "
            f"{composite_type!r}"
        )
    img = array_to_png(img_array, scale=scale,
                       labels=labels if annotated else None)
    if path:
        img.save(path)
    return img


# ---------------------------------------------------------------------------
# Example accessors
# ---------------------------------------------------------------------------

def variant_from_example(example: ExampleLike) -> Variant:
    return _as_decoded(example).variant


def locus_id_from_variant(variant: Variant) -> str:
    return (
        f"{variant.reference_name}:{variant.start}_"
        f"{variant.reference_bases}"
    )


def alt_allele_indices_from_example(example: ExampleLike) -> List[int]:
    return list(_as_decoded(example).alt_allele_indices)


def alt_bases_from_indices(alt_allele_indices: List[int],
                           alternate_bases: List[str]) -> str:
    """'-'-joined alt bases at the given indices ('/' would break
    file paths)."""
    return "-".join(alternate_bases[i] for i in alt_allele_indices)


def alt_from_example(example: ExampleLike) -> str:
    ex = _as_decoded(example)
    return alt_bases_from_indices(
        list(ex.alt_allele_indices), ex.variant.alternate_bases
    )


def locus_id_with_alt(example: ExampleLike) -> str:
    ex = _as_decoded(example)
    return (
        f"{locus_id_from_variant(ex.variant)}_{alt_from_example(ex)}"
    )


def label_from_example(example: ExampleLike) -> Optional[int]:
    return _as_decoded(example).label


# ---------------------------------------------------------------------------
# Automated curation
# ---------------------------------------------------------------------------

def remove_ref_band(arr: np.ndarray,
                    num_top_rows_to_skip: int = 5) -> np.ndarray:
    """Drops the reference rows at the top of a pileup plane."""
    assert arr.ndim == 2
    assert arr.shape[0] > num_top_rows_to_skip
    return arr[num_top_rows_to_skip:, :]


def fraction_low_base_quality(channels: List[np.ndarray],
                              threshold: int = 127) -> float:
    """Fraction of (non-empty) base pixels whose base quality is below
    `threshold` (half of the 254 ceiling by default)."""
    plane = remove_ref_band(channels[1])
    nonzero = plane[plane > 0]
    if nonzero.size == 0:
        return 0.0
    return float(np.count_nonzero(nonzero < threshold)) / nonzero.size


def fraction_reads_with_low_mapq(channels: List[np.ndarray],
                                 threshold: int = 127) -> float:
    """Fraction of reads (pileup rows) whose mapping quality is below
    `threshold`."""
    per_read = np.amax(remove_ref_band(channels[2]), axis=1)
    nonzero = per_read[per_read > 0]
    if nonzero.size == 0:
        return 0.0
    return float(np.count_nonzero(nonzero < threshold)) / nonzero.size


def fraction_read_support(channels: List[np.ndarray]) -> float:
    """Fraction of reads fully supporting the alt allele(s)."""
    per_read = np.amax(remove_ref_band(channels[4]), axis=1)
    nonzero = per_read[per_read > 0]
    if nonzero.size == 0:
        return 0.0
    return float(np.count_nonzero(nonzero == 254)) / nonzero.size


def describe_read_support(channels: List[np.ndarray]) -> ReadSupport:
    """LOW is [0, 0.3], HALF is (0.3, 0.8], ALL is (0.8, 1]."""
    fraction = fraction_read_support(channels)
    if fraction > 0.8:
        return ReadSupport.ALL
    if fraction > 0.3:
        return ReadSupport.HALF
    return ReadSupport.LOW


def binomial_test(k: int, n: int) -> float:
    """Exact two-tailed binomial test at p=0.5 (symmetric, so the
    two-tailed p doubles the one-tailed sum)."""
    if k > n:
        raise ValueError("k must be <= n")
    if k * 2 == n:
        return 1.0
    k = min(k, n - k)
    half_pow = 0.5 ** n
    one_tail = sum(math.comb(n, x) for x in range(k + 1)) * half_pow
    return one_tail * 2.0


def pvalue_for_strand_bias(channels: List[np.ndarray]) -> float:
    """Binomial p-value comparing forward (240) vs reverse (70) strand
    among fully-supporting reads."""
    strand = remove_ref_band(channels[3])
    support = remove_ref_band(channels[4]) == 254
    forward = np.amax(support * (strand == 240), axis=1)
    reverse = np.amax(support * (strand == 70), axis=1)
    n_forward = int(forward.sum())
    n_reverse = int(reverse.sum())
    return binomial_test(k=n_forward, n=n_forward + n_reverse)


def analyze_diff_and_nearby_variants(
    channels: List[np.ndarray],
) -> Tuple[float, int]:
    """(fraction of diffs not explained by putative nearby variants,
    number of putative nearby-variant columns)."""
    diff = remove_ref_band(channels[5])
    is_diff = diff == 254
    column_diffs = is_diff.sum(axis=0)
    column_read_count = (diff != 0).sum(axis=0)
    # +1 avoids dividing by zero; the exact fraction is not vital.
    fraction = column_diffs / (column_read_count + 1)
    nearby_columns = (fraction > 0.1) & (column_diffs > 4)
    num_nearby = int(nearby_columns.sum())
    non_variant_diffs = int((is_diff & ~nearby_columns).sum())
    total_read_area = int((diff != 0).sum())
    diff_fraction = (
        0.0 if total_read_area == 0
        else non_variant_diffs / total_read_area
    )
    return diff_fraction, num_nearby


def describe_diff(channels: List[np.ndarray],
                  diff_fraction_threshold: float = 0.01) -> Diff:
    """MANY_DIFFS above the (curation-chosen) error threshold,
    NEARBY_VARIANTS at five or more putative variant columns,
    FEW_DIFFS otherwise."""
    diff_fraction, nearby_variants = analyze_diff_and_nearby_variants(
        channels
    )
    if diff_fraction > diff_fraction_threshold:
        return Diff.MANY_DIFFS
    if nearby_variants >= 5:
        return Diff.NEARBY_VARIANTS
    return Diff.FEW_DIFFS


def curate_pileup(channels: List[np.ndarray]) -> PileupCuration:
    """All automated curation tags at the reference's human-curated
    thresholds (vis.py:826-854)."""
    return PileupCuration(
        base_quality=BaseQuality.GOOD
        if fraction_low_base_quality(channels) < 0.05
        else BaseQuality.BAD,
        mapping_quality=MappingQuality.GOOD
        if fraction_reads_with_low_mapq(channels) < 0.05
        else MappingQuality.BAD,
        strand_bias=StrandBias.BIASED
        if pvalue_for_strand_bias(channels) < 0.05 else StrandBias.GOOD,
        diff_category=describe_diff(channels),
        read_support=describe_read_support(channels),
    )

"""Plain PyTorch pileup painter over plan tensors: the benchmark's
reference for the plan form of the paint.

A frozen copy of the arithmetic of DeepVariant's pileup image
(pileup_image_native.cc, as the JAX package's plan encoder computes it):
each channel's color from the plan's rows, the reference band above the
read rows, and in diff mode the two alt-aligned planes. The colors come
from the pileup options of the configuration file; nothing here reads
the port.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

MAX_PIXEL = 254.0

# Channel enums (deepvariant.proto) painted from a plan.
READ_BASE, BASE_QUALITY, MAPPING_QUALITY, STRAND = 1, 2, 3, 4
READ_SUPPORTS_VARIANT, BASE_DIFFERS_FROM_REF = 5, 6
HAPLOTYPE_TAG, ALLELE_FREQUENCY, INSERT_SIZE = 7, 8, 19
SUPPLEMENTARY_ALIGNMENT = 26

DEFAULT_OPTIONS = dict(
    reference_band_height=5, base_color_offset_a_and_g=40,
    base_color_offset_t_and_c=30, base_color_stride=70,
    allele_supporting_read_alpha=1.0, allele_unsupporting_read_alpha=0.6,
    other_allele_supporting_read_alpha=0.6,
    reference_matching_read_alpha=0.2, reference_mismatching_read_alpha=1.0,
    reference_base_quality=60, positive_strand_color=70,
    negative_strand_color=240, base_quality_cap=40, mapping_quality_cap=60,
    hp_tag_for_assembly_polishing=0)


def _byte(x: float) -> int:
    return int(x) & 0xFF


def scale_lut(cap: float) -> np.ndarray:
    """The color of a quality v = 0..255: 254 * (min(v, cap) / cap) with
    the division taken as a multiply by the float32 reciprocal, then
    truncated and saturated to a byte (the plan encoder's arithmetic; at
    the caps 40 and 60 of these configurations it equals the IEEE
    quotient's byte)."""
    factor = np.float32(MAX_PIXEL) * (np.float32(1) / np.float32(cap))
    v = np.minimum(np.arange(256, dtype=np.float32), np.float32(cap))
    return np.clip(v * factor, 0, 255).astype(np.uint8)


class Colors:
    """Every color the painter needs, from a dict of pileup options."""

    def __init__(self, options: Dict):
        o = {**DEFAULT_OPTIONS, **options}
        self.band = int(o["reference_band_height"])
        ag, tc, stride = (o["base_color_offset_a_and_g"],
                          o["base_color_offset_t_and_c"],
                          o["base_color_stride"])
        self.base = np.zeros(256, np.uint8)
        self.base[ord("A")] = ag + stride * 3
        self.base[ord("G")] = ag + stride * 2
        self.base[ord("T")] = tc + stride
        self.base[ord("C")] = tc
        self.support = [_byte(MAX_PIXEL * o[k]) for k in (
            "allele_unsupporting_read_alpha", "allele_supporting_read_alpha",
            "other_allele_supporting_read_alpha")]
        self.strand = [_byte(o["positive_strand_color"]),
                       _byte(o["negative_strand_color"])]
        self.match = _byte(MAX_PIXEL * o["reference_matching_read_alpha"])
        self.mismatch = _byte(
            MAX_PIXEL * o["reference_mismatching_read_alpha"])
        self.qual = scale_lut(o["base_quality_cap"])
        self.mapq = scale_lut(o["mapping_quality_cap"])
        ref_quality = _byte(MAX_PIXEL * min(
            o["reference_base_quality"], o["base_quality_cap"])
            / o["base_quality_cap"])
        self.supp = [self.support[0], self.support[1]]
        swap = o["hp_tag_for_assembly_polishing"] == 2
        self.hp = [0, 254 if swap else 127, 127 if swap else 254, 254]
        self.band_color = {
            BASE_QUALITY: ref_quality, MAPPING_QUALITY: ref_quality,
            STRAND: _byte(o["positive_strand_color"]),
            READ_SUPPORTS_VARIANT: self.support[0],
            BASE_DIFFERS_FROM_REF: self.match, INSERT_SIZE: 254,
            HAPLOTYPE_TAG: 0, ALLELE_FREQUENCY: 0,
            SUPPLEMENTARY_ALIGNMENT: _byte(
                o["allele_unsupporting_read_alpha"]),
        }


def _tlen_color(tlen: torch.Tensor) -> torch.Tensor:
    # |tlen| capped at 1000, 254 * |tlen| / 1000 in float32 (IEEE
    # division), truncated and saturated to a byte.
    t = torch.clamp(torch.abs(tlen), max=1000).to(torch.float32)
    t = (MAX_PIXEL * t) / torch.tensor(1000.0, device=t.device)
    return torch.clamp(t, 0.0, 255.0).to(torch.uint8)


def paint(plans: Dict[str, torch.Tensor], channels: Sequence[int],
          diff: bool, colors: Colors) -> torch.Tensor:
    """Stacked plan tensors (keys bases, quals, mapq, rev, hp, tlen, supp,
    support, af, row_valid, ref_window and, in diff mode, alt_bases,
    alt_row_valid, alt_ref, alt_present; leading dimension N) -> (N,
    band + R, W, len(channels) + 2 * diff) uint8 images."""
    bases, row_valid = plans["bases"], plans["row_valid"]
    n, rows, width = bases.shape
    dev = bases.device

    def lut(table):
        return torch.from_numpy(np.asarray(table, np.uint8)).to(dev)

    base, qual, mapq = lut(colors.base), lut(colors.qual), lut(colors.mapq)
    covered = (bases != 0) & row_valid[:, :, None]
    zero = torch.zeros((), dtype=torch.uint8, device=dev)

    def per_row(color_nr):  # (N, R) -> (N, R, W)
        return color_nr.to(torch.uint8)[:, :, None].expand(n, rows, width)

    def pick(mask, if_true, if_false):
        return torch.where(mask, torch.tensor(if_true, dtype=torch.uint8,
                                              device=dev),
                           torch.tensor(if_false, dtype=torch.uint8,
                                        device=dev))

    def support_color():
        s = plans["support"].to(torch.int64)
        s = torch.where(s < 0, s + 3, s).clamp(0, 2)
        return lut(colors.support)[s]

    painters = {
        READ_BASE: lambda: base[bases.long()],
        BASE_QUALITY: lambda: qual[plans["quals"].long()],
        BASE_DIFFERS_FROM_REF: lambda: pick(
            bases == plans["ref_window"][:, None, :], colors.match,
            colors.mismatch),
        MAPPING_QUALITY: lambda: per_row(mapq[plans["mapq"].long()]),
        STRAND: lambda: per_row(pick(plans["rev"], colors.strand[1],
                                     colors.strand[0])),
        READ_SUPPORTS_VARIANT: lambda: per_row(support_color()),
        INSERT_SIZE: lambda: per_row(_tlen_color(plans["tlen"])),
        HAPLOTYPE_TAG: lambda: per_row(
            lut(colors.hp)[plans["hp"].long().clamp(0, 3)]),
        ALLELE_FREQUENCY: lambda: per_row(plans["af"]),
        SUPPLEMENTARY_ALIGNMENT: lambda: per_row(pick(
            plans["supp"], colors.supp[1], colors.supp[0])),
    }

    def with_band(band_row, plane):  # (N, W) band row over (N, R, W)
        band = band_row[:, None, :].expand(n, colors.band, width)
        return torch.cat([band, plane], dim=1)

    def flat(color):
        return torch.full((n, width), color, dtype=torch.uint8, device=dev)

    planes = []
    for ch in channels:
        plane = torch.where(covered, painters[ch](), zero)
        band_row = (base[plans["ref_window"].long()] if ch == READ_BASE
                    else flat(colors.band_color[ch]))
        planes.append(with_band(band_row, plane))
    if diff:
        alt_bases = plans["alt_bases"]
        alt_cov = (alt_bases != 0) & plans["alt_row_valid"][:, :, :, None]
        alt_diff = pick(alt_bases == plans["alt_ref"][:, :, None, :],
                        colors.match, colors.mismatch)
        alt_diff = torch.where(alt_cov, alt_diff, zero)
        for k in range(2):
            plane = with_band(flat(colors.match), alt_diff[:, k])
            planes.append(torch.where(
                plans["alt_present"][:, k, None, None], plane, zero))
    return torch.stack(planes, dim=-1)

"""The WGS plan painter: plan row tensors -> (N, H, W, 7) uint8 pileups.

Counterpart of `make_longread_encode_fn` in
`deepvariant_tpu/make_examples/pileup_jax.py`, for the 7-channel WGS
channel set with `alt_aligned_pileup` 'none'. The read rows are painted
by the CUDA kernel (`ops.pileup_paint.paint_pileup`); this module
computes the four per-row colors exactly as the JAX encoder does, and
builds the reference band above the rows with plain PyTorch. The images
are bit-identical to the JAX encoder's.

Other channel sets and `diff_channels` (the alt-aligned planes) are not
ported yet: asking for them raises NotImplementedError rather than
painting something else.
"""

from __future__ import annotations

import torch

from deepvariant_tpu_torch.make_examples.pileup import (
    MAX_PIXEL_FLOAT,
    WGS_CHANNELS,
    PileupOptions,
)
from deepvariant_tpu_torch.ops.pileup_paint import paint_pileup

_LATER = ("the full DEVICE_CHANNELS plan painter with diff_channels, "
          "a later slice of the port (ROADMAP.md)")

# Options the paint kernel has built in; others are computed from options.
_KERNEL_FIXED = ("base_color_offset_a_and_g", "base_color_offset_t_and_c",
                 "base_color_stride", "base_quality_cap",
                 "reference_matching_read_alpha",
                 "reference_mismatching_read_alpha")


def make_longread_encode_fn(options: PileupOptions) -> "WgsPlanPainter":
    """The WGS painter over pre-gathered plan rows (see WgsPlanPainter)."""
    return WgsPlanPainter(options)


class WgsPlanPainter:
    """encode(bases, quals, mapq, rev, hp, tlen, supp, support, af,
    row_valid, ref_windows) -> (N, H, W, 7) uint8, with the arguments of
    the JAX encoder (PLAN_KEYS order) as tensors on one device: bases,
    quals (N, R, W) uint8; mapq (N, R) uint8; rev (N, R) bool; tlen
    (N, R) int32; support (N, R) int8; row_valid (N, R) bool; ref_windows
    (N, W) uint8. hp, supp and af feed channels outside the WGS set and
    are not read."""

    def __init__(self, options: PileupOptions):
        o = options
        if list(o.channels) != WGS_CHANNELS:
            raise NotImplementedError(
                f"the device plan painter implements the WGS channel set "
                f"{WGS_CHANNELS}, not {list(o.channels)}; other sets wait "
                "for " + _LATER)
        if o.alt_aligned_pileup == "diff_channels":
            raise NotImplementedError("alt_aligned_pileup diff_channels "
                                      "waits for " + _LATER)
        if o.alt_aligned_pileup not in ("", "none"):
            raise ValueError(
                "device plan painter implements alt_aligned_pileup 'none', "
                f"not {o.alt_aligned_pileup!r}")
        defaults = PileupOptions()
        changed = [f for f in _KERNEL_FIXED
                   if getattr(o, f) != getattr(defaults, f)]
        if changed:
            raise NotImplementedError(
                f"the paint kernel has the default values of {changed} "
                "built in; other values wait for " + _LATER)
        self.options = o
        support = [int(MAX_PIXEL_FLOAT * o.allele_unsupporting_read_alpha),
                   int(MAX_PIXEL_FLOAT * o.allele_supporting_read_alpha),
                   int(MAX_PIXEL_FLOAT *
                       o.other_allele_supporting_read_alpha)]
        match_color = int(MAX_PIXEL_FLOAT * o.reference_matching_read_alpha)
        ref_quality = int(MAX_PIXEL_FLOAT * min(
            o.reference_base_quality, o.base_quality_cap
        ) / o.base_quality_cap)
        base = [0] * 256
        base[ord("A")] = o.base_color_offset_a_and_g + o.base_color_stride * 3
        base[ord("G")] = o.base_color_offset_a_and_g + o.base_color_stride * 2
        base[ord("T")] = o.base_color_offset_t_and_c + o.base_color_stride * 1
        base[ord("C")] = o.base_color_offset_t_and_c + o.base_color_stride * 0
        self._lut_values = {
            "base": base,
            "strand": [o.positive_strand_color, o.negative_strand_color],
            "support": support,
            # Reference-band colors of channels 1..6 (pileup_jax.py:594-633).
            "band": [ref_quality, ref_quality, o.positive_strand_color,
                     support[0], match_color, int(MAX_PIXEL_FLOAT)],
        }
        # Tables per device, made once: a host-to-device copy inside a
        # call would wait for the work already queued on the stream.
        self._tables = {}

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        key = (name, device)
        if key not in self._tables:
            self._tables[key] = torch.tensor(
                self._lut_values[name], dtype=torch.uint8, device=device)
        return self._tables[key]

    def _lut(self, name: str, index: torch.Tensor) -> torch.Tensor:
        values = self._table(name, index.device)
        # JAX indexing wraps negative indices once, then clamps.
        index = index.to(torch.int64)
        index = torch.where(index < 0, index + len(values), index)
        return values[index.clamp(0, len(values) - 1)]

    def paint_args(self, bases, quals, mapq, rev, tlen, support, row_valid,
                   ref_windows):
        """The arguments of `paint_pileup` for these plan rows: the
        coverage mask and the four (N, R) float32 row colors, computed as
        pileup_jax.py:563-633 does (uint8 colors, truncated)."""
        cap = float(self.options.mapping_quality_cap)
        covered = (bases != 0) & row_valid[:, :, None]
        mapq_color = (MAX_PIXEL_FLOAT * (
            torch.clamp(mapq.to(torch.float32), max=cap) / cap
        )).to(torch.uint8)
        tlen_f = torch.clamp(torch.abs(tlen), max=1000).to(torch.float32)
        tlen_color = (MAX_PIXEL_FLOAT * tlen_f / 1000.0).to(torch.uint8)
        colors = [mapq_color, self._lut("strand", rev),
                  self._lut("support", support), tlen_color]
        return (bases.contiguous(), quals.contiguous(), covered.contiguous(),
                ref_windows.contiguous(),
                *[c.to(torch.float32) for c in colors])

    def __call__(self, bases, quals, mapq, rev, hp, tlen, supp, support, af,
                 row_valid, ref_windows):
        del hp, supp, af
        n, _, width = bases.shape
        rows = paint_pileup(*self.paint_args(
            bases, quals, mapq, rev, tlen, support, row_valid, ref_windows))
        channels = len(WGS_CHANNELS)
        ref_plane = torch.empty((n, width, channels), dtype=torch.uint8,
                                device=bases.device)
        ref_plane[:, :, 0] = self._lut("base", ref_windows)
        ref_plane[:, :, 1:] = self._table("band", bases.device)
        band = self.options.reference_band_height
        ref_rows = ref_plane[:, None].expand(n, band, width, channels)
        return torch.cat([ref_rows, rows], dim=1)

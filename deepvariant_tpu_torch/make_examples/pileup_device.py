"""The WGS plan painter: plan row tensors -> (N, H, W, 7) uint8 pileups.

Counterpart of `make_longread_encode_fn` in
`deepvariant_tpu/make_examples/pileup_jax.py`, for the 7-channel WGS
channel set with `alt_aligned_pileup` 'none'. The painter derives the
colors from the options and paints the whole image, reference band
included, with one launch of the CUDA paint kernel's plan form
(`ops.pileup_paint.paint_pileup_plan`); on CPU tensors it runs that
form's plain version. The images are bit-identical to the JAX encoder's.

Other channel sets and `diff_channels` (the alt-aligned planes) are not
ported yet: asking for them raises NotImplementedError rather than
painting something else.
"""

from __future__ import annotations

from deepvariant_tpu_torch.make_examples.pileup import (
    MAX_PIXEL_FLOAT,
    WGS_CHANNELS,
    PileupOptions,
)
from deepvariant_tpu_torch.ops.pileup_paint import (
    PlanColors,
    paint_pileup_plan,
)

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
        support = tuple(
            int(MAX_PIXEL_FLOAT * alpha) for alpha in (
                o.allele_unsupporting_read_alpha,
                o.allele_supporting_read_alpha,
                o.other_allele_supporting_read_alpha))
        match_color = int(MAX_PIXEL_FLOAT * o.reference_matching_read_alpha)
        ref_quality = int(MAX_PIXEL_FLOAT * min(
            o.reference_base_quality, o.base_quality_cap
        ) / o.base_quality_cap)
        self.colors = PlanColors(
            band=o.reference_band_height,
            mapq_cap=float(o.mapping_quality_cap),
            strand=(o.positive_strand_color, o.negative_strand_color),
            support=support,
            # Reference-band colors of channels 1..6 (pileup_jax.py:594-633).
            band_colors=(ref_quality, ref_quality, o.positive_strand_color,
                         support[0], match_color, int(MAX_PIXEL_FLOAT)))

    def __call__(self, bases, quals, mapq, rev, hp, tlen, supp, support, af,
                 row_valid, ref_windows):
        del hp, supp, af
        return paint_pileup_plan(bases, quals, mapq, rev, tlen, support,
                                 row_valid, ref_windows, self.colors)

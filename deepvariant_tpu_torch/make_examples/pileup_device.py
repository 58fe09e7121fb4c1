"""Device-side pileup encoding: planners, gathers and the plan painter.

Counterpart of `deepvariant_tpu/make_examples/pileup_jax.py`. The
irregular work (per-read CIGAR walks, read drop rules, row sorting and
downsampling) runs on the host and produces dense tensors
(`build_region_tensors`, `plan_candidate`, `gather_plan_rows`); the
per-pixel channel math runs on the device, as one launch of the CUDA
paint kernel's plan form (`ops.pileup_paint.paint_pileup_plan`) for all
candidates of a batch, and on CPU tensors as that form's plain version.
The images are bit-identical to the JAX encoders'.

Two encoders share the painter:
- `make_longread_encode_fn`: over pre-gathered (N, R, W) plan rows, any
  ordered list of `DEVICE_CHANNELS`, plus the two alt-aligned diff
  planes when `alt_aligned_pileup` is 'diff_channels';
- `make_encode_fn`: over a region's (K, Wr) read tensors, gathering each
  candidate's rows and window on the device first. It has no diff mode.

`plan_longread_example` makes one example's plan from a candidate and
its reads. With `alt_aligned_pileup` off its alt tensors are zeros; the
'diff_channels' branch for a variant that needs alt alignment waits for
the alt-haplotype aligner (`alt_aligned.py`) and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch

from deepvariant_tpu_torch.device import resolve_device
from deepvariant_tpu_torch.io.bam import FLAG_FIRST, FLAG_PAIRED, ReadBatch
from deepvariant_tpu_torch.make_examples.pileup import (
    CH_ALLELE_FREQUENCY,
    CH_BASE_DIFFERS_FROM_REF,
    CH_BASE_QUALITY,
    CH_HAPLOTYPE_TAG,
    CH_INSERT_SIZE,
    CH_MAPPING_QUALITY,
    CH_READ_BASE,
    CH_READ_SUPPORTS_VARIANT,
    CH_STRAND,
    CH_SUPPLEMENTARY_ALIGNMENT,
    MAX_PIXEL_FLOAT,
    PileupEncoder,
    PileupOptions,
    base_color_lut,
    reads_overlapping_variant,
)
from deepvariant_tpu_torch.make_examples.shuffle import shuffle_indices
from deepvariant_tpu_torch.make_examples.variant_caller import DeepVariantCall
from deepvariant_tpu_torch.ops import pileup_paint as pp

# The plan's tensor keys in the painter's argument order.
PLAN_KEYS = (
    "bases", "quals", "mapq", "rev", "hp", "tlen", "supp", "support",
    "af", "row_valid", "ref_window",
)
ALT_KEYS = ("alt_bases", "alt_row_valid", "alt_ref", "alt_present")

# Channel enum -> the paint kernel's plane kind.
_KIND = {
    CH_READ_BASE: pp.KIND_BASE,
    CH_BASE_QUALITY: pp.KIND_QUALITY,
    CH_MAPPING_QUALITY: pp.KIND_MAPQ,
    CH_STRAND: pp.KIND_STRAND,
    CH_READ_SUPPORTS_VARIANT: pp.KIND_SUPPORT,
    CH_BASE_DIFFERS_FROM_REF: pp.KIND_DIFFERS,
    CH_INSERT_SIZE: pp.KIND_TLEN,
    CH_HAPLOTYPE_TAG: pp.KIND_HP,
    CH_ALLELE_FREQUENCY: pp.KIND_AF,
    CH_SUPPLEMENTARY_ALIGNMENT: pp.KIND_SUPP,
}

#: Channels the device encoders implement with numerics identical to the
#: host encoder. The factories refuse to build for anything else rather
#: than emit silently-wrong zero planes.
DEVICE_CHANNELS = frozenset(_KIND)


@dataclasses.dataclass
class RegionTensors:
    """Host-prepared dense view of a region's reads."""

    span_start: int             # genome position of column 0
    bases: np.ndarray           # (K, Wr) uint8, 0 = uncovered
    quals: np.ndarray           # (K, Wr) uint8 (final event per col)
    min_quals: np.ndarray       # (K, Wr) uint8 (min event qual per col)
    mapq: np.ndarray            # (K,) uint8
    reverse: np.ndarray         # (K,) bool
    hp: np.ndarray              # (K,) int8
    tlen: np.ndarray            # (K,) int32
    supplementary: np.ndarray = None  # (K,) bool (flag 0x800)


def build_region_tensors(
    encoder: PileupEncoder,
    batch: ReadBatch,
    span_start: int,
    span_end: int,
) -> RegionTensors:
    """One CIGAR walk per read per region over [span_start, span_end).

    Only reads overlapping the span are touched, and each read's walk is
    computed once per batch in global coordinates and memoized on the
    batch, so the candidates of a partition slice it instead of
    re-walking."""
    width = span_end - span_start
    k = len(batch)
    bases = np.zeros((k, width), np.uint8)
    quals = np.zeros((k, width), np.uint8)
    min_quals = np.full((k, width), 255, np.uint8)
    cache = getattr(batch, "_plan_walk_cache", None)
    if cache is None:
        cache = {}
        batch._plan_walk_cache = cache
        batch._plan_ref_ends = batch.reference_ends()
    ends = batch._plan_ref_ends
    # A read whose first aligned op is an insertion paints its anchor at
    # pos - 1 (`PileupEncoder._walk_events_with_positions`, the host
    # painter), so the walk and the overlap test start a column left of
    # the read. (The JAX package's planner walks from pos and drops that
    # anchor, so its plan and its host image differ there.)
    overlapping = np.flatnonzero(
        (batch.pos <= span_end) & (ends > span_start)
    )
    for r in overlapping:
        r = int(r)
        entry = cache.get(r)
        if entry is None:
            first = int(batch.pos[r]) - 1
            span = max(int(ends[r]) - first, 2)
            c_local, b, q = encoder._walk_events(batch, r, first, span)
            if c_local is None:
                entry = (None, None, None)
            else:
                entry = (c_local + first, b, q)  # global columns
            cache[r] = entry
        cols_g, b, q = entry
        if cols_g is None:
            continue
        sel = (cols_g >= span_start) & (cols_g < span_end)
        if not sel.any():
            continue
        cols = cols_g[sel] - span_start
        bases[r, cols] = b[sel]
        quals[r, cols] = q[sel]
        np.minimum.at(min_quals[r], cols, q[sel])
    return RegionTensors(
        span_start=span_start,
        bases=bases,
        quals=quals,
        min_quals=min_quals,
        mapq=batch.mapq.copy(),
        reverse=np.asarray(batch.is_reverse()),
        hp=batch.hp.copy()
        if len(batch.hp) == k else np.zeros(k, np.int8),
        tlen=batch.tlen.copy(),
        supplementary=np.asarray((batch.flag & 0x800) != 0),
    )


@dataclasses.dataclass
class CandidatePlan:
    """Row layout for one (candidate, alt-combo) example."""

    window_start: int             # genome position of window col 0
    row_reads: np.ndarray         # (H - band,) int32, -1 = empty row
    support_codes: np.ndarray     # (K,) int8
    af_colors: np.ndarray         # (K,) uint8
    ref_window: np.ndarray        # (W,) uint8


def plan_candidate(
    encoder: PileupEncoder,
    tensors: RegionTensors,
    dv_call: DeepVariantCall,
    batch: ReadBatch,
    alt_alleles: Sequence[str],
    ref_window: np.ndarray,
    read_indices: Optional[Sequence[int]] = None,
    sort_positions: Optional[np.ndarray] = None,
) -> CandidatePlan:
    """The host painter's read selection and row sort for one example.

    `read_indices` overrides the overlap query (alt-aligned pileups take
    all realigned reads); `sort_positions` overrides the position sort
    component (trimmed pileups sort by original alignment positions)."""
    o = encoder.options
    variant = dv_call.variant
    image_start = variant.start - o.half_width
    call_col = variant.start - tensors.span_start
    if read_indices is None:
        read_indices = reads_overlapping_variant(
            batch, variant, o.read_overlap_buffer_bp
        )
    indices = list(read_indices)
    max_reads = o.max_reads
    if len(indices) > max_reads:
        # The crowded-window shuffle of the host painter: libc++'s
        # std::shuffle over mt19937_64(random_seed).
        order = shuffle_indices(len(indices), o.random_seed)
        indices = [indices[i] for i in order]

    alt_order = {a: i for i, a in enumerate(variant.alternate_bases)}
    support_group = {}
    if o.sort_by_alt_allele_support:
        for alt, ids in dv_call.allele_support.items():
            gi = alt_order.get(alt)
            if gi is not None:
                for rid in ids:
                    support_group[rid] = gi

    k = len(batch)
    support_codes = np.zeros(k, np.int8)
    af_colors = np.zeros(k, np.uint8)
    rows = []
    for idx in indices:
        if len(rows) >= max_reads:
            break
        if int(tensors.mapq[idx]) < o.min_mapping_quality:
            continue
        # Does the read produce any event in the window?
        w0 = image_start - tensors.span_start
        window = tensors.bases[idx, max(w0, 0): w0 + o.width]
        if not window.any():
            continue
        # Low-quality base at the call site -> drop.
        if 0 <= call_col < tensors.bases.shape[1] and \
                tensors.bases[idx, call_col] != 0 and \
                tensors.min_quals[idx, call_col] < o.min_base_quality:
            continue
        support_codes[idx] = encoder._read_supports_alt(
            dv_call, idx, alt_alleles
        )
        if CH_ALLELE_FREQUENCY in o.channels:
            af_colors[idx] = encoder._allele_frequency_color(
                encoder._read_allele_frequency(dv_call, idx, alt_alleles)
            )
        hap_idx = encoder._hap_index(int(tensors.hp[idx]))
        group = support_group.get(idx, len(alt_order)) if \
            o.sort_by_alt_allele_support else 0
        rows.append((
            hap_idx, group,
            int(sort_positions[idx]) if sort_positions is not None
            else int(batch.pos[idx]),
            batch.name[idx],
            0 if batch.flag[idx] & FLAG_FIRST or not (
                batch.flag[idx] & FLAG_PAIRED
            ) else 1,
            idx,
        ))
    rows.sort(key=lambda t: t[:5])
    row_reads = np.full(max_reads, -1, np.int32)
    for i, (_, _, _, _, _, idx) in enumerate(rows):
        row_reads[i] = idx
    return CandidatePlan(
        window_start=image_start,
        row_reads=row_reads,
        support_codes=support_codes,
        af_colors=af_colors,
        ref_window=ref_window,
    )


def gather_plan_rows(
    tensors: RegionTensors,
    plan: CandidatePlan,
    width: int,
) -> dict:
    """Host-side gather of a plan's rows into dense (R, W) tensors."""
    rows = plan.row_reads
    w0 = plan.window_start - tensors.span_start
    if w0 != 0 or tensors.bases.shape[1] != width:
        raise ValueError(
            "long-read plans must be built over exactly the pileup "
            f"window (span offset {w0}, span width "
            f"{tensors.bases.shape[1]}, window width {width})"
        )
    safe = np.maximum(rows, 0)
    valid = rows >= 0
    return {
        "bases": tensors.bases[safe],
        "quals": tensors.quals[safe],
        "mapq": tensors.mapq[safe],
        "rev": tensors.reverse[safe],
        "hp": tensors.hp[safe],
        "tlen": tensors.tlen[safe],
        "supp": tensors.supplementary[safe],
        "support": plan.support_codes[safe],
        "af": plan.af_colors[safe],
        "row_valid": valid,
    }


def plan_colors(options: PileupOptions, diff: bool = False) -> pp.PlanColors:
    """The paint kernel's planes and colors for these options, every
    color computed as pileup_jax.py:535-574 and :592-650 compute it."""
    o = options
    base_lut = base_color_lut(o)
    support = [int(c) for c in np.array([
        int(MAX_PIXEL_FLOAT * o.allele_unsupporting_read_alpha),
        int(MAX_PIXEL_FLOAT * o.allele_supporting_read_alpha),
        int(MAX_PIXEL_FLOAT * o.other_allele_supporting_read_alpha),
    ], np.uint8)]
    strand = [int(c) for c in np.array(
        [o.positive_strand_color, o.negative_strand_color], np.uint8)]
    # The match and mismatch colors pass through an integer -> uint8
    # conversion, which wraps.
    match = int(MAX_PIXEL_FLOAT * o.reference_matching_read_alpha) & 0xFF
    mismatch = int(
        MAX_PIXEL_FLOAT * o.reference_mismatching_read_alpha) & 0xFF
    ref_quality = int(MAX_PIXEL_FLOAT * min(
        o.reference_base_quality, o.base_quality_cap
    ) / o.base_quality_cap) & 0xFF
    band_color = {
        CH_READ_BASE: 0,  # not read: the band is the reference's color
        CH_BASE_QUALITY: ref_quality,
        # The band of mapping_quality uses the base-quality cap.
        CH_MAPPING_QUALITY: ref_quality,
        CH_STRAND: o.positive_strand_color & 0xFF,
        CH_READ_SUPPORTS_VARIANT: support[0],
        CH_BASE_DIFFERS_FROM_REF: match,
        CH_INSERT_SIZE: int(MAX_PIXEL_FLOAT),
        CH_HAPLOTYPE_TAG: 0,
        CH_ALLELE_FREQUENCY: 0,
        # The raw alpha cast to a byte: int(0.6) == 0.
        CH_SUPPLEMENTARY_ALIGNMENT:
            int(o.allele_unsupporting_read_alpha) & 0xFF,
    }
    # 254 * hp / 2 of hp clipped to 0..2, after the polishing swap of 1
    # and 2; the table is over hp clamped to 0..3.
    swap = o.hp_tag_for_assembly_polishing == 2
    hp = (0, 254 if swap else 127, 127 if swap else 254, 254)
    channels = list(o.channels)
    return pp.PlanColors(
        band=o.reference_band_height,
        kinds=tuple(_KIND[ch] for ch in channels),
        diff=diff,
        band_colors=tuple(band_color[ch] for ch in channels),
        qual_cap=float(o.base_quality_cap),
        mapq_cap=float(o.mapping_quality_cap),
        base=tuple(int(base_lut[ord(c)]) for c in "AGTC"),
        strand=tuple(strand),
        support=tuple(support),
        supp=(support[0], support[1]),
        hp=hp,
        match=match,
        mismatch=mismatch,
    )


class PlanPainter:
    """encode(bases, quals, mapq, rev, hp, tlen, supp, support, af,
    row_valid, ref_windows[, alt_bases, alt_row_valid, alt_ref,
    alt_present]) -> (N, H, W, C) uint8, with the arguments of the JAX
    encoder (PLAN_KEYS then ALT_KEYS order) as tensors on one device:
    bases, quals (N, R, W) uint8; mapq, af (N, R) uint8; rev, supp,
    row_valid (N, R) bool; hp, support (N, R) int8; tlen (N, R) int32;
    ref_windows (N, W) uint8; alt_bases (N, 2, R, W) uint8; alt_row_valid
    (N, 2, R) bool; alt_ref (N, 2, W) uint8; alt_present (N, 2) bool. The
    four alt tensors are read only in diff mode, where C is
    len(channels) + 2, and may be left out otherwise. One launch of the
    paint kernel on CUDA tensors."""

    def __init__(self, options: PileupOptions):
        self.options = options
        self.diff_mode = options.alt_aligned_pileup == "diff_channels"
        self.colors = plan_colors(options, self.diff_mode)
        self.colors.check()

    def __call__(self, bases, quals, mapq, rev, hp, tlen, supp, support, af,
                 row_valid, ref_windows, alt_bases=None, alt_row_valid=None,
                 alt_ref=None, alt_present=None):
        if not self.diff_mode:
            alt_bases = alt_row_valid = alt_ref = alt_present = None
        return pp.paint_pileup_plan(
            bases, quals, mapq, rev, hp, tlen, supp, support, af, row_valid,
            ref_windows, alt_bases, alt_row_valid, alt_ref, alt_present,
            self.colors)


def make_longread_encode_fn(options: PileupOptions) -> PlanPainter:
    """The painter over pre-gathered plan rows (+ diff alt planes)."""
    o = options
    unsupported = [ch for ch in o.channels if ch not in DEVICE_CHANNELS]
    if unsupported:
        raise ValueError(
            "device long-read encoder does not implement channel(s) "
            f"{unsupported}; supported: {sorted(DEVICE_CHANNELS)}"
        )
    if o.alt_aligned_pileup not in ("", "none", "diff_channels"):
        raise ValueError(
            "device long-read encoder implements alt_aligned_pileup "
            f"in {{none, diff_channels}}, not {o.alt_aligned_pileup!r}"
        )
    return PlanPainter(options)


class RegionEncoder:
    """encode(region_bases, region_quals, mapq, reverse, hp, tlen,
    supplementary, window_offsets, row_reads, support_codes, af_colors,
    ref_windows) -> (N, H, W, C) uint8, all candidates of a region at
    once, with the arguments of the JAX region encoder as tensors on one
    device: region_bases, region_quals (K, Wr) uint8; mapq (K,) uint8;
    reverse, supplementary (K,) bool; hp (K,) int8; tlen (K,) int32;
    window_offsets (N,) int32 (window col 0 - span col 0); row_reads
    (N, H-band) int32, -1 an empty row; support_codes (N, K) int8;
    af_colors (N, K) uint8; ref_windows (N, W) uint8.

    The gather is torch indexing that makes the plan tensors; the paint
    is the same one launch as the plan painter's."""

    def __init__(self, options: PileupOptions):
        self.options = options
        self.colors = plan_colors(options)
        self.colors.check()

    def __call__(self, region_bases, region_quals, mapq, reverse, hp, tlen,
                 supplementary, window_offsets, row_reads, support_codes,
                 af_colors, ref_windows):
        width = self.options.width
        cols = window_offsets[:, None].long() + torch.arange(
            width, device=window_offsets.device)[None, :]
        # A window hanging off the span repeats the edge column.
        cols = cols.clamp(0, region_bases.shape[1] - 1)
        # Empty rows (read -1) gather read 0 and are masked by row_valid.
        safe = row_reads.long().clamp(min=0)
        at = (safe[:, :, None], cols[:, None, :])
        return pp.paint_pileup_plan(
            region_bases[at], region_quals[at], mapq[safe], reverse[safe],
            hp[safe], tlen[safe], supplementary[safe],
            torch.gather(support_codes, 1, safe),
            torch.gather(af_colors, 1, safe), row_reads >= 0,
            ref_windows.contiguous(), None, None, None, None, self.colors)


def make_encode_fn(options: PileupOptions) -> RegionEncoder:
    """The device encoder over a region's read tensors, for a fixed
    channel set."""
    unsupported = [ch for ch in options.channels
                   if ch not in DEVICE_CHANNELS]
    if unsupported:
        raise ValueError(
            "device pileup encoder does not implement channel(s) "
            f"{unsupported}; supported: {sorted(DEVICE_CHANNELS)}. Use the "
            "host encoder (pileup.PileupEncoder) for this channel set."
        )
    return RegionEncoder(options)


def _to_device(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def encode_region_candidates(
    encoder: PileupEncoder,
    dv_calls: Sequence[DeepVariantCall],
    alt_combos: Sequence[Sequence[str]],
    batch: ReadBatch,
    ref_query,
    encode_fn=None,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Convenience wrapper: host prep + one device call for a region.

    dv_calls[i] pairs with alt_combos[i]; ref_query(variant) must return
    the (W,) uint8 pileup reference window.
    Returns (N, H, W, C) uint8.
    """
    o = encoder.options
    if not dv_calls:
        return np.zeros((0, o.height, o.width, len(o.channels)), np.uint8)
    device = resolve_device(device)
    span_start = min(
        c.variant.start - o.half_width for c in dv_calls
    )
    span_end = max(
        c.variant.start - o.half_width + o.width for c in dv_calls
    )
    tensors = build_region_tensors(encoder, batch, span_start, span_end)
    plans = []
    for dv_call, combo in zip(dv_calls, alt_combos):
        plans.append(plan_candidate(
            encoder, tensors, dv_call, batch, combo,
            ref_query(dv_call.variant),
        ))
    if encode_fn is None:
        encode_fn = make_encode_fn(o)
    out = encode_fn(*_to_device([
        tensors.bases,
        tensors.quals,
        tensors.mapq,
        tensors.reverse,
        tensors.hp,
        tensors.tlen,
        tensors.supplementary,
        np.array([p.window_start - span_start for p in plans], np.int32),
        np.stack([p.row_reads for p in plans]),
        np.stack([p.support_codes for p in plans]),
        np.stack([p.af_colors for p in plans]),
        np.stack([p.ref_window for p in plans]),
    ], device))
    return out.cpu().numpy()


def plan_longread_example(
    builder,
    dv_call: DeepVariantCall,
    batch: ReadBatch,
    combo: Sequence[str],
) -> Optional[dict]:
    """Host planning for one (candidate, alt-combo) example.

    Runs the trimming, realignment and row-selection paths and returns
    the gathered input dict for make_longread_encode_fn, or None when the
    reference window is unavailable. `builder` is the ExamplesBuilder
    (reference window, candidate preparation, reads realigned to the alt
    haplotypes)."""
    encoder = builder.encoder
    o = encoder.options
    variant = dv_call.variant
    ref_window = builder.reference_window(variant)
    if ref_window is None or len(ref_window) != o.width:
        return None
    dv_call, batch, read_indices, sort_positions = \
        builder.prepare_candidate_batch(dv_call, batch)
    image_start = variant.start - o.half_width
    tensors = build_region_tensors(
        encoder, batch, image_start, image_start + o.width
    )
    plan = plan_candidate(
        encoder, tensors, dv_call, batch, combo, ref_window,
        read_indices=read_indices, sort_positions=sort_positions,
    )
    rows = gather_plan_rows(tensors, plan, o.width)
    rows["ref_window"] = np.asarray(ref_window, np.uint8)

    r = o.max_reads
    alt_bases = np.zeros((2, r, o.width), np.uint8)
    alt_row_valid = np.zeros((2, r), bool)
    alt_ref = np.zeros((2, o.width), np.uint8)
    alt_present = np.zeros(2, bool)
    if o.alt_aligned_pileup == "diff_channels" and \
            builder.need_alt_alignment(variant):
        items = list(builder.iter_alt_batches(
            dv_call, batch, combo, sort_positions=sort_positions
        ))
        for i, item in enumerate(items[:2]):
            if item is None:
                continue
            remapped, alt_batch, alt_sort_pos, hap_window = item
            alt_tensors = build_region_tensors(
                encoder, alt_batch, image_start, image_start + o.width
            )
            alt_plan = plan_candidate(
                encoder, alt_tensors, remapped, alt_batch, combo,
                np.asarray(hap_window, np.uint8),
                read_indices=np.arange(len(alt_batch)),
                sort_positions=alt_sort_pos,
            )
            g = gather_plan_rows(alt_tensors, alt_plan, o.width)
            alt_bases[i] = g["bases"]
            alt_row_valid[i] = g["row_valid"]
            alt_ref[i] = np.asarray(hap_window, np.uint8)
            alt_present[i] = True
        # alt2 falls back to alt1 (pileup_image_native.h:232-242).
        if len(items) < 2 or (alt_present[0] and not alt_present[1]):
            alt_bases[1] = alt_bases[0]
            alt_row_valid[1] = alt_row_valid[0]
            alt_ref[1] = alt_ref[0]
            alt_present[1] = alt_present[0]
    rows["alt_bases"] = alt_bases
    rows["alt_row_valid"] = alt_row_valid
    rows["alt_ref"] = alt_ref
    rows["alt_present"] = alt_present
    return rows


def encode_longread_examples(
    builder,
    planned: Sequence[dict],
    encode_fn=None,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Batch-encode planned long-read examples on the device. Of the
    first argument only its encoder's pileup options are read."""
    o = builder.encoder.options
    n_ch = len(o.channels) + (
        2 if o.alt_aligned_pileup == "diff_channels" else 0
    )
    if not planned:
        return np.zeros((0, o.height, o.width, n_ch), np.uint8)
    device = resolve_device(device)
    if encode_fn is None:
        encode_fn = make_longread_encode_fn(o)
    out = encode_fn(*_to_device(
        [np.stack([p[key] for p in planned]) for key in PLAN_KEYS + ALT_KEYS],
        device))
    return out.cpu().numpy()
